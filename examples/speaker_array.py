"""Steered speaker-array demo: per-source aims in one mixdown launch.

An 8-element vertical line array of cardioid sources is aimed at a focal
listener; a second listener sits behind the array. Per-source
directivity rides ``TraceParams.directivity`` as an [S, C] row table —
the whole array traces in one vmapped mixdown program
(`parallel/multisource.py`), each source weighting its own emission. The
same array re-run omni shows what the steering
buys: front/back energy contrast at the two listeners.

The reference has no multi-source mode at all (closest analogue: one
Unity scene per source); this is framework-only capability.

Run:  python examples/speaker_array.py [--cpu] [--elements 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--out", default="speaker_array_out")
parser.add_argument("--elements", type=int, default=8)
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import realisticaudioraytracing2d_tpu as art  # noqa: E402
from realisticaudioraytracing2d_tpu.models.materials import (  # noqa: E402
    AudioMaterial)
from realisticaudioraytracing2d_tpu.models.scene import (  # noqa: E402
    SceneBuilder)
from realisticaudioraytracing2d_tpu.ops import directivity as dv  # noqa: E402
from realisticaudioraytracing2d_tpu.parallel.multisource import (  # noqa: E402
    trace_sources_mixdown)
from realisticaudioraytracing2d_tpu.utils import viz  # noqa: E402

os.makedirs(args.out, exist_ok=True)
key = jax.random.PRNGKey(0)

# a 16 x 12 hall, mildly absorbing
m = AudioMaterial(absorption=0.35, scattering=0.4, transmission=0.0,
                  ior=1.0)
b = SceneBuilder(n_bands=1)
b.add_box(m, size=(16.0, 12.0))
scene = b.build()

S = args.elements
# vertical line array at x = -5, half-wavelengthish spacing
ys = np.linspace(-1.4, 1.4, S)
sources = jnp.asarray(np.stack([np.full(S, -5.0), ys], axis=1),
                      jnp.float32)
listeners = jnp.asarray([[5.0, 0.0],     # focal listener (front)
                         [-7.0, 0.0]],   # behind the array
                        jnp.float32)
# every element aims at the focal listener: per-source cardioid rows
aims = jnp.stack([jnp.asarray(dv.cardioid(
    float(np.arctan2(0.0 - y, 5.0 - (-5.0))))) for y in ys]).astype(
        jnp.float32)

kw = dict(n_rays=30000, max_bounces=6, sample_rate=16000, ir_length=16000)
p = art.TraceParams.make(sources, listeners, 0.5, 343.0, 1.0)

t0 = time.time()
steered = np.asarray(trace_sources_mixdown(
    scene, p._replace(directivity=aims), key, **kw))
omni = np.asarray(trace_sources_mixdown(scene, p, key, **kw))
dt = time.time() - t0


def db(x):
    return 10.0 * np.log10(max(x, 1e-30))


# early (direct-dominated) energy window per listener
def early(ir, l):
    d = float(jnp.linalg.norm(sources.mean(0) - listeners[l]))
    b0 = int(d / 343.0 * 16000)
    return float(ir[l, b0 - 40:b0 + 200, 0].sum())


contrast_steered = db(early(steered, 0)) - db(early(steered, 1))
contrast_omni = db(early(omni, 0)) - db(early(omni, 1))
print(f"{S}-element array traced twice in {dt:.2f}s "
      f"on {jax.devices()[0].platform}")
print(f"front/back early-energy contrast: steered "
      f"{contrast_steered:+.1f} dB vs omni {contrast_omni:+.1f} dB "
      f"(steering gain {contrast_steered - contrast_omni:+.1f} dB)")

for name, ir in (("steered", steered), ("omni", omni)):
    png = os.path.join(args.out, f"ir_{name}.png")
    viz.write_png(png, viz.ir_waveform_image(ir[0, :, 0], frames=1))
    print("wrote", png)

assert contrast_steered > contrast_omni + 3.0, \
    "steering should buy >3 dB of front/back contrast"
print("OK")
