"""Occlusion walk-by: stream audio while the listener walks through the
acoustic shadow of an opaque pillar, with and without the edge-diffraction
shadow fill (ops/diffraction.py) and atmospheric absorption (ops/air.py).

Without diffraction the trace has the reference's hard shadows
(`Raytrace2D.compute:101-119`): the wet signal collapses to the few
wall-bounce paths while the pillar blocks the line of sight. With
`diffraction=True` the Maekawa knife-edge paths around the pillar tips
fill the shadow — the level dips smoothly instead of cratering, which is
what a real walk-by sounds like.

Success criterion: in the shadowed middle chunks the plain stream is
EXACTLY silent while the diffraction stream is not; both are identical
while the line of sight is clear; air absorption only removes energy.

Run:  python examples/occlusion_walkby.py  [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--out", default="occlusion_out")
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import realisticaudioraytracing2d_tpu as art  # noqa: E402
from realisticaudioraytracing2d_tpu.models.materials import (  # noqa: E402
    AudioMaterial)
from realisticaudioraytracing2d_tpu.models.scene import (  # noqa: E402
    SceneBuilder, Transform2D)
from realisticaudioraytracing2d_tpu.ops import air  # noqa: E402
from realisticaudioraytracing2d_tpu.utils import audio_io  # noqa: E402

os.makedirs(args.out, exist_ok=True)
SR = 16000

# The classic barrier demo: an opaque free-standing pillar, no room
# shell — in the shadow the plain trace is EXACTLY silent (in a live
# room the diffracted path is still there but sits under the reverb).
OPAQUE = AudioMaterial(absorption=0.8, scattering=0.6, transmission=0.0,
                       ior=1.0)
b = SceneBuilder(n_bands=1)
b.add_segment((0.0, -3.0), (0.0, 3.0), (1.0, 0.0), OPAQUE)    # thin pillar
scene = b.build()
source = np.asarray([-6.0, 0.0], np.float32)

cfg = art.smoll_room_config(ray_count=4000)
import dataclasses  # noqa: E402
cfg = dataclasses.replace(
    cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
    audio=dataclasses.replace(cfg.audio, sample_rate=SR,
                              reverb_duration=0.25))

# The listener walks a straight line on the far side of the pillar:
# x = +4, y from -8 (clear) through 0 (deep shadow) to +8 (clear).
N_CHUNKS = 24
def listener_at(i):
    y = -8.0 + 16.0 * i / (N_CHUNKS - 1)
    return np.asarray([4.0, y], np.float32)

def poses(i):
    return art.TraceParams.make(source, listener_at(i),
                                listener_radius=0.5)

dry = audio_io.noise_burst(N_CHUNKS * cfg.audio.chunk_duration, SR, seed=7)

runs = {}
for name, kw in [
        ("plain", {}),
        ("diffraction", dict(diffraction=True)),
        ("diffraction+air", dict(
            diffraction=True,
            air_alpha=jnp.asarray(air.iso9613_alpha(
                air.band_frequencies(1)), jnp.float32)))]:
    streamer = art.Streamer(scene, cfg, jax.random.PRNGKey(0), **kw)
    wet = np.asarray(streamer.stream_clip(
        jnp.asarray(dry), poses, total_chunks=N_CHUNKS))[0]
    audio_io.write_wav(os.path.join(args.out, f"walkby_{name}.wav"),
                       wet, SR)
    n = cfg.audio.chunk_samples
    levels = np.asarray([np.sqrt(np.mean(wet[i * n:(i + 1) * n] ** 2))
                         for i in range(N_CHUNKS)])
    runs[name] = levels
    print(f"{name:16s} chunk RMS: " +
          " ".join(f"{lv:7.1e}" for lv in levels[::4]))

mid = slice(N_CHUNKS // 2 - 2, N_CHUNKS // 2 + 2)   # deep shadow
clear = slice(0, 3)                                  # clear line of sight
assert np.all(runs["plain"][mid] == 0.0), \
    "free-field shadow must be exactly silent without diffraction"
assert np.all(runs["diffraction"][mid] > 0.0), \
    "diffraction must add energy in the shadow"
ratio = runs["diffraction"][clear].sum() / max(runs["plain"][clear].sum(),
                                               1e-12)
assert 0.8 < ratio < 1.2, f"clear-LOS levels should agree, ratio={ratio}"
assert np.all(runs["diffraction+air"][mid] <= runs["diffraction"][mid]
              + 1e-12), "air absorption must not add energy"
print("OK: shadow filled by diffraction; clear-LOS unchanged; air "
      f"attenuates. WAVs in {args.out}/")
