"""IR dataset generation over procedural rooms, sharded across a device
mesh (BASELINE.json config #5 at demo scale).

Run:  python examples/dataset_sweep.py [--rooms 64] [--cpu]
With --cpu it forces 8 virtual CPU devices so the sharded path runs
anywhere; without it, it uses whatever devices the platform exposes.
Writes dataset.npz (+ per-room IR stats to stdout).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--rooms", type=int, default=64)
parser.add_argument("--rays", type=int, default=4096)
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--out", default="dataset.npz")
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

from realisticaudioraytracing2d_tpu.models.rooms import random_rooms  # noqa: E402
from realisticaudioraytracing2d_tpu.parallel.mesh import make_mesh  # noqa: E402
from realisticaudioraytracing2d_tpu.parallel.sweep import (  # noqa: E402
    sweep_rooms, sweep_rooms_sharded)

n_dev = len(jax.devices())
rooms = (args.rooms // max(1, n_dev)) * max(1, n_dev) or n_dev
scenes, sources, listeners = random_rooms(rooms, seed=0, n_obstacles=3)
print(f"{rooms} rooms, {scenes.a.shape[1]} padded walls each, "
      f"{n_dev} devices")

kw = dict(n_rays=args.rays, max_bounces=6, sample_rate=16000,
          ir_length=16000, n_frames=2)
key = jax.random.PRNGKey(0)
t0 = time.perf_counter()
if n_dev > 1:
    mesh = make_mesh((n_dev,), ("rooms",))
    irs = sweep_rooms_sharded(scenes, sources, listeners, key, mesh, **kw)
else:
    irs = sweep_rooms(scenes, sources, listeners, key, **kw)
irs = np.asarray(irs)
dt = time.perf_counter() - t0
print(f"swept in {dt:.2f}s ({rooms / dt:.1f} rooms/s incl. compile)")

np.savez_compressed(args.out, irs=irs, sources=sources,
                    listeners=listeners)
energies = irs.sum(axis=(1, 2, 3))
print(f"wrote {args.out}: irs {irs.shape}; "
      f"per-room energy min/med/max = {energies.min():.4f}/"
      f"{np.median(energies):.4f}/{energies.max():.4f}")
