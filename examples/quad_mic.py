"""Microphone-array demo: one trace pass, N x N listeners.

Traces the SmollRoom with a square microphone array around the shipped
listener position (all listeners share every wall sweep of the trace;
the listener count is unbounded), then bakes an N*N-channel
WAV whose inter-channel delays encode the array geometry.

Run:  python examples/quad_mic.py [--cpu] [--grid 3]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--out", default="quad_out")
parser.add_argument("--grid", type=int, default=2,
                    help="array side length (grid x grid mics; >2 "
                    "exercises the blocked multi-launch path)")
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import realisticaudioraytracing2d_tpu as art  # noqa: E402
from realisticaudioraytracing2d_tpu.utils import audio_io  # noqa: E402

os.makedirs(args.out, exist_ok=True)
key = jax.random.PRNGKey(0)

room = art.rooms.smoll_room()
cfg = art.smoll_room_config(ray_count=4096)

# grid x grid array, 1 m spacing, centered on the shipped listener
g = args.grid
n_mics = g * g
center = np.asarray(room.listener, np.float32)
axis_off = (np.arange(g, dtype=np.float32) - (g - 1) / 2.0)
offsets = np.stack(np.meshgrid(axis_off, axis_off),
                   axis=-1).reshape(-1, 2)
mics = center[None, :] + offsets

eng = art.Engine(room.scene, cfg, n_listeners=n_mics)
params = eng.params(room.source, mics)

t0 = time.perf_counter()
state = eng.trace_frames(params, key, n_frames=8)
float(state.sum.sum())
print(f"traced {n_mics}-mic array, 8 frames x 4096 rays in "
      f"{time.perf_counter() - t0:.2f}s (incl. compile)")

ir = np.asarray(state.normalized())          # [n_mics, T, 1]
sr = cfg.audio.sample_rate
first = []
for m in range(n_mics):
    nz = np.nonzero(ir[m, :, 0])[0]
    first.append(int(nz[0]) if nz.size else -1)  # -1: outside the room
print("first arrival per mic (ms):",
      [round(b / sr * 1e3, 2) if b >= 0 else None for b in first])
# among mics that heard anything, closer-to-source arrives first —
# checked pairwise with a distance margin: arrival bins quantize to
# sample resolution and first arrivals are multi-bounce paths, so
# near-equidistant mics may tie or swap by a bin
heard = [m for m in range(n_mics) if first[m] >= 0]
d = np.linalg.norm(mics - np.asarray(room.source)[None, :], axis=1)
margin = 2.0 * 343.0 / sr   # two sample bins of path length
for i in heard:
    for j in heard:
        if d[i] + margin < d[j]:
            assert first[i] <= first[j] + 2, (i, j, d[i], d[j],
                                              first[i], first[j])

dry = audio_io.click_clip(1.0, sr, click_times=(0.1, 0.5))
wet = np.asarray(eng.bake(jax.numpy.asarray(dry), state))  # [mics, N+T]
path = os.path.join(args.out, f"array_{g}x{g}.wav")
audio_io.write_wav(path, wet.T, sr)
print(f"wrote {n_mics}-channel {path} ({wet.shape[1]} samples)")
