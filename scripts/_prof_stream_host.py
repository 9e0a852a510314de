"""Host-loop steady-state cost of `Streamer.stream_clip` per 0.1 s
chunk — the end-to-end number (retrace + convolution + all host-side
per-chunk bookkeeping), as opposed to bench.py's `Streamer.process`
compiled-step cost, for the plain, per-arrival, binaural and composed
stream modes.

Run on the accelerator (one process per card):

    python scripts/_prof_stream_host.py [--chunks 50]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import realisticaudioraytracing2d_tpu as art  # noqa: E402
from realisticaudioraytracing2d_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)


def run_mode(name, *, chunks, binaural=False, doppler=False):
    room = art.rooms.smoll_room(pad_to=32)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    dry = jnp.asarray(np.random.default_rng(0)
                      .uniform(-0.3, 0.3, chunks * n).astype(np.float32))

    src = np.asarray(room.source, np.float64)

    def params_fn(i):
        # gentle source motion so the per-arrival taps actually glide
        return eng.params((src[0] + 0.02 * i, src[1]), room.listener)

    streamer = art.Streamer(room.scene, cfg, jax.random.PRNGKey(0),
                            binaural=binaural)
    stamps = []

    def on_chunk(i, _state):
        stamps.append(time.perf_counter())
        if i % 10 == 0:
            print(f"  [{name}] chunk {i}", file=sys.stderr, flush=True)

    facing_fn = (lambda i: 0.3) if binaural else None

    def one_pass():
        out = streamer.stream_clip(dry, params_fn, pad_tail=False,
                                   on_chunk=on_chunk,
                                   facing_fn=facing_fn, doppler=doppler)
        float(jnp.sum(out))                       # device sync barrier

    one_pass()                                    # compile + warm
    stamps.clear()
    t0 = time.perf_counter()
    one_pass()                                    # timed, fully warm
    wall = (time.perf_counter() - t0) / (len(dry) // n) * 1e3
    lat = np.diff(np.asarray(stamps))[1:] * 1e3
    print(f"{name:8s} wall {wall:6.2f} ms/chunk  dispatch p50 "
          f"{np.median(lat):6.2f} ms  p95 {np.percentile(lat, 95):6.2f} ms"
          f"  ({len(lat) + 1} chunks, sr {sr})", flush=True)
    return wall


MODES = {
    "plain": dict(),
    "pa": dict(doppler="per_arrival"),
    "bi": dict(binaural=True),
    "bpa": dict(binaural=True, doppler="per_arrival"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=50)
    ap.add_argument("--mode", choices=[*MODES, "all"], default="all",
                    help="time one mode only")
    args = ap.parse_args()
    enable_compile_cache()
    print(f"backend: {jax.default_backend()}", flush=True)
    for m, kw in MODES.items():
        if args.mode in (m, "all"):
            run_mode(m, chunks=args.chunks, **kw)


if __name__ == "__main__":
    main()
