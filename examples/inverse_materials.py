"""Inverse material estimation: recover wall absorption from a target IR.

A capability the reference pipeline (Unity/HLSL compute, no autodiff)
cannot express: the whole trace is a pure JAX function, so we synthesize a
"measured" impulse response with ground-truth materials, then recover them
by gradient descent through the ray tracer (`diff.fit_materials`).

Fits two groups at once — the left/right vs top/bottom shoebox walls —
starting from deliberately wrong absorptions. (Every wall sees plenty of
ray traffic, so both groups are strongly identifiable from one listener's
energy-decay curve; a small interior obstacle, by contrast, moves the EDC
less than the Monte-Carlo noise floor at this ray budget.)

Run:  python examples/inverse_materials.py [--cpu] [--steps 80]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--steps", type=int, default=150)
parser.add_argument("--rays", type=int, default=256)
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from realisticaudioraytracing2d_tpu import diff  # noqa: E402
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu.models.scene import (  # noqa: E402
    SceneBuilder, Transform2D)
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams  # noqa: E402

SR, IR_LEN, BOUNCES = 16000, 2048, 8
TRUE = {"sides": 0.507, "topbot": 0.148}   # the shipped material values
START = {"sides": 0.10, "topbot": 0.60}    # deliberately wrong


def room(sides_abs, topbot_abs):
    """6x5 m shoebox; left/right walls one material, top/bottom another."""
    sides = AudioMaterial(absorption=sides_abs, scattering=0.5)
    topbot = AudioMaterial(absorption=topbot_abs, scattering=1.0)
    w, h, t = 6.0, 5.0, 1.0
    b = SceneBuilder()
    b.add_box(topbot, Transform2D((0, h / 2 + t / 2), 0, (w + 2 * t, t)))
    b.add_box(topbot, Transform2D((0, -h / 2 - t / 2), 0, (w + 2 * t, t)))
    b.add_box(sides, Transform2D((-w / 2 - t / 2, 0), 0, (t, h)))
    b.add_box(sides, Transform2D((w / 2 + t / 2, 0), 0, (t, h)))
    return b.build()


# Three listeners: one EDC has a sides<->topbot trade-off plateau; spatially
# spread microphones (plus the edc+mse loss) make both groups identifiable.
params = TraceParams.make(source=(-1.8, 0.6),
                          listeners=[(1.6, 1.2), (0.0, -1.6), (2.2, -0.4)],
                          listener_radius=0.5)

true_scene = room(TRUE["sides"], TRUE["topbot"])
target = diff.simulate_ir(true_scene, params, jax.random.PRNGKey(7),
                          n_rays=args.rays, max_bounces=BOUNCES,
                          sample_rate=SR, ir_length=IR_LEN, frames=8)

start_scene = room(START["sides"], START["topbot"])
groups, n_groups = diff.infer_material_groups(start_scene)

t0 = time.perf_counter()
result = diff.fit_materials(
    start_scene, params, target, jax.random.PRNGKey(0),
    n_rays=args.rays, max_bounces=BOUNCES, sample_rate=SR,
    frames=4, fields=("absorption",), loss="edc+mse",
    steps=args.steps, lr=0.08)
dt = time.perf_counter() - t0

fitted = np.asarray(jax.nn.sigmoid(result.params.absorption))[:, 0]
losses = np.asarray(result.losses)
print(f"{args.steps} Adam steps in {dt:.1f}s "
      f"({dt / args.steps * 1e3:.0f} ms/step)")
print(f"loss: {losses[:5].mean():.4f} -> {losses[-5:].mean():.4f}")

# map fitted groups back to named walls via any wall index of each kind
topbot_g = int(groups[0])   # first segment of the top wall box
sides_g = int(groups[8])    # first segment of the left wall box
for name, g in [("sides", sides_g), ("topbot", topbot_g)]:
    print(f"{name:9s} true={TRUE[name]:.3f} start={START[name]:.3f} "
          f"fitted={fitted[g]:.3f}  (|err|={abs(fitted[g]-TRUE[name]):.3f})")
