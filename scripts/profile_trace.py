"""Profile the trace at the reference workload and at the heavy shape.

For each case: steady ms/frame with the profiler off, then one
``jax.profiler`` trace of a steady window, reduced to the device's busy
and idle share over that window and the operations that take the most
device time. Traces are written under ``<out>/<case>``.

    python scripts/profile_trace.py [--top 8] [--out profile_out]
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

import realisticaudioraytracing2d_tpu as art  # noqa: E402
from realisticaudioraytracing2d_tpu.engine import trace_accumulate  # noqa: E402
from realisticaudioraytracing2d_tpu.ops.ir import IRState  # noqa: E402
from realisticaudioraytracing2d_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

WINDOW = "profile_window"

CASES = {  # name: (pad_to, rays, bounces, frames in the traced call)
    "reference": (None, 15000, 5, 20),
    "heavy": (32, 131072, 8, 5),
}


def _union_ns(intervals) -> int:
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(path: str, top: int) -> dict:
    """Busy/idle share of the device over the host ``profile_window``
    span, and device time per kernel name. On the GPU every event of a
    device plane's stream lines is one kernel or copy, named after its
    XLA fusion."""
    pd = jax.profiler.ProfileData.from_file(path)
    window = None
    kernels, ops, lines = [], collections.Counter(), []
    for plane in pd.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == WINDOW:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
            continue
        if not plane.name.startswith("/device"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines.append(f"{plane.name}/{line.name}: {len(evs)}")
            for ev in evs:
                ops[ev.name] += ev.duration_ns
                kernels.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if window is None and kernels:
        window = (min(s for s, _ in kernels), max(e for _, e in kernels))
    span = max(1, window[1] - window[0]) if window else 1
    inside = [(max(s, window[0]), min(e, window[1])) for s, e in kernels
              if window and e > window[0] and s < window[1]]
    busy = _union_ns(inside)
    total_ops = max(1, sum(ops.values()))
    return {"window_ms": span / 1e6, "busy_share": busy / span,
            "idle_share": 1.0 - busy / span, "kernels": len(inside),
            "lines": lines,
            "top": [(n, t / 1e6, t / total_ops)
                    for n, t in ops.most_common(top)]}


def run_case(name: str, top: int, out_dir: str) -> None:
    pad, rays, bounces, frames = CASES[name]
    room = art.rooms.smoll_room(pad_to=pad)
    cfg = art.smoll_room_config()
    params = art.TraceParams.make(room.source, room.listener,
                                  room.listener_radius, 343.0, 1.0)
    zeros = IRState.zeros(cfg.audio.ir_length, 1, 1)
    key = jax.random.PRNGKey(0)

    def call(k):
        return jax.block_until_ready(trace_accumulate(
            room.scene, params, zeros, k, n_rays=rays, max_bounces=bounces,
            sample_rate=cfg.audio.sample_rate, n_frames=frames))

    call(key)
    call(jax.random.fold_in(key, 1))
    t0 = time.perf_counter()
    call(jax.random.fold_in(key, 2))
    ms = (time.perf_counter() - t0) / frames * 1e3
    out = os.path.join(out_dir, name)
    jax.profiler.start_trace(out)
    with jax.profiler.TraceAnnotation(WINDOW):
        call(jax.random.fold_in(key, 3))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    r = reduce_trace(path, top)
    print(f"{name} ({rays} rays x {bounces} bounces, {frames} frames): "
          f"{ms:.3f} ms/frame unprofiled; traced window "
          f"{r['window_ms']:.2f} ms, device busy {r['busy_share']:.1%}, "
          f"idle {r['idle_share']:.1%}, {r['kernels']} device events")
    print(f"    device lines (events): {'; '.join(r['lines'])}")
    for op, t, share in r["top"]:
        print(f"    {share:6.1%}  {t / frames:8.3f} ms/frame  {op}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--out", default="profile_out",
                    help="directory for the traces (one subdirectory per "
                         "case)")
    args = ap.parse_args()
    enable_compile_cache()
    print(f"devices: {jax.devices()}")
    for name in CASES:
        run_case(name, args.top, args.out)


if __name__ == "__main__":
    main()
