"""Acoustic source localization with ONE microphone, via differentiable echoes.

A single listener's first arrival only fixes a range circle around it —
classical trilateration needs three microphones. But the impulse response
also carries every wall reflection, and those echo delays depend on where
the source sits on that circle. Because the whole ray tracer is
differentiable (soft two-bin IR splat, `ops/ir.py::scatter_hits_soft`),
`diff.localize_source` recovers the source position by multi-start Adam
through the simulation — all starts batched in one `vmap`.

The reference (Unity/HLSL graphics pipeline) cannot express this: there is
no gradient through a compute-shader dispatch.

Run:  python examples/locate_source.py [--cpu] [--starts 8] [--steps 200]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--starts", type=int, default=8)
parser.add_argument("--steps", type=int, default=200)
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
from realisticaudioraytracing2d_tpu.models.rooms import \
    shoebox_room  # noqa: E402
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams  # noqa: E402

SR, IR_LEN, BOUNCES = 8000, 512, 4

scene = shoebox_room(4.0, 4.0,
                     wall_material=AudioMaterial(absorption=0.3,
                                                 scattering=0.4))
true_source = jnp.array([-1.0, 0.4])
params = TraceParams.make(source=true_source, listeners=(1.0, 0.3),
                          listener_radius=0.5)

# "Measure" an IR at the single microphone (soft-binned: the same forward
# model the optimizer uses — a real measurement would be hard-binned, which
# adds at most one bin of bias).
key = jax.random.PRNGKey(0)
target = diff.simulate_ir(scene, params, key, n_rays=args.rays,
                          max_bounces=BOUNCES, sample_rate=SR,
                          ir_length=IR_LEN, soft=True)

t0 = time.time()
result = diff.localize_source(scene, params, target, key,
                              n_rays=args.rays, max_bounces=BOUNCES,
                              sample_rate=SR, n_starts=args.starts,
                              steps=args.steps)
dt = time.time() - t0

true_np = np.asarray(true_source)
best = np.asarray(result.position)
err = float(np.linalg.norm(best - true_np))
print(f"{args.starts} starts x {args.steps} steps in {dt:.1f}s "
      f"(one vmapped fit)")
for pos, loss in zip(np.asarray(result.positions),
                     np.asarray(result.losses)):
    tag = " <- best" if np.allclose(pos, best) else ""
    print(f"  start -> ({pos[0]:+.3f}, {pos[1]:+.3f})  loss {loss:9.4f}{tag}")
print(f"true   ({true_np[0]:+.3f}, {true_np[1]:+.3f})")
print(f"fitted ({best[0]:+.3f}, {best[1]:+.3f})   |err| = {err:.3f} m")
if err > 0.15:
    sys.exit("localization failed (err > 0.15 m)")
