"""Benchmark suite — prints ONE JSON line with the headline metric.

Headline: ray-bounce intersection throughput per device on the trace
semantics of ``Raytrace2D.compute:49-156``, counting both the nearest-hit
pass and the NEE occlusion pass. ``vs_baseline`` is the ratio to the
100 M/s figure the project started from.

Secondary diagnostics (IR build ms, streaming xRT at 44.1 kHz, stream
chunk ms per mode, rooms/s sweep rate, large-scene frame ms) go to
stderr, after a line naming the card and its power limit.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def bench_trace(n_rays=131072, max_bounces=8, n_frames=50,
                sample_rate=48000, ir_length=72000):
    """Frame loop runs *inside* one jit (lax.scan over frames) so the
    measurement reflects device throughput, not per-call host dispatch."""
    import realisticaudioraytracing2d_tpu as art
    from realisticaudioraytracing2d_tpu.engine import trace_accumulate
    from realisticaudioraytracing2d_tpu.ops.ir import IRState

    room = art.rooms.smoll_room(pad_to=32)
    n_valid_walls = int(np.asarray(room.scene.n_valid))
    params = art.TraceParams.make(room.source, room.listener,
                                  room.listener_radius, 343.0, 1.0)
    key = jax.random.PRNGKey(0)

    def run(st, k):
        return trace_accumulate(room.scene, params, st, k,
                                n_rays=n_rays, max_bounces=max_bounces,
                                sample_rate=sample_rate, n_frames=n_frames)

    jax.block_until_ready(run(IRState.zeros(ir_length, 1, 1), key))  # compile
    # warm: the first run after a compile is slower than steady state
    jax.block_until_ready(run(IRState.zeros(ir_length, 1, 1),
                              jax.random.fold_in(key, 9)))
    dt = float("inf")
    for trial in range(3):  # best-of-3
        state = IRState.zeros(ir_length, 1, 1)
        t0 = time.perf_counter()
        state = run(state, jax.random.fold_in(key, 1 + trial))
        jax.block_until_ready(state.sum)
        dt = min(dt, time.perf_counter() - t0)

    frame_ms = dt / n_frames * 1e3
    # nearest-hit pass + NEE occlusion pass, valid walls only (padded lanes
    # not counted, though they are computed).
    tests = n_rays * max_bounces * n_valid_walls * 2 * n_frames
    return tests / dt, frame_ms


def bench_quad(n_frames=50, sample_rate=48000, ir_length=72000):
    """4-listener frame cost at the reference workload (all four ears
    share every wall sweep)."""
    import realisticaudioraytracing2d_tpu as art
    from realisticaudioraytracing2d_tpu.engine import trace_accumulate
    from realisticaudioraytracing2d_tpu.ops.ir import IRState

    room = art.rooms.smoll_room(pad_to=32)
    ears = np.asarray([[0.0, -3.68], [0.5, -3.68], [-6.0, 2.0],
                       [8.0, -1.0]], np.float32)
    params = art.TraceParams.make(room.source, ears, 0.5, 343.0, 1.0)

    def run(k):
        return trace_accumulate(room.scene, params,
                                IRState.zeros(ir_length, 4, 1), k,
                                n_rays=15000, max_bounces=5,
                                sample_rate=sample_rate, n_frames=n_frames)

    key = jax.random.PRNGKey(0)
    jax.block_until_ready(run(key).sum)
    t0 = time.perf_counter()
    jax.block_until_ready(run(jax.random.fold_in(key, 1)).sum)
    return (time.perf_counter() - t0) / n_frames * 1e3


def bench_ir_build(n_frames=20, sample_rate=48000, ir_length=72000):
    """IR scatter cost alone: accumulate pre-traced hits."""
    import realisticaudioraytracing2d_tpu as art
    from realisticaudioraytracing2d_tpu.ops import ir as irm
    from realisticaudioraytracing2d_tpu.ops.trace import trace_hits_only

    room = art.rooms.smoll_room(pad_to=32)
    params = art.TraceParams.make(room.source, room.listener, 0.5, 343.0,
                                  1.0)
    hits = trace_hits_only(room.scene, params, jax.random.PRNGKey(0),
                           n_rays=15000, max_bounces=5)
    jax.block_until_ready(hits.valid)
    scatter = jax.jit(lambda h: irm.scatter_hits(h, sample_rate, ir_length))
    jax.block_until_ready(scatter(hits))
    t0 = time.perf_counter()
    for _ in range(n_frames):
        out = scatter(hits)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_frames * 1e3


def bench_streaming_xrt(sample_rate=44100, reverb=1.5, chunk=0.1,
                        n_chunks=20):
    """Streaming conv throughput: chunks/s vs realtime (trace excluded —
    convolution + ring path only, matching the 'streaming convolution xRT'
    metric)."""
    from realisticaudioraytracing2d_tpu.ops.convolve import (
        convolve_chunk_crossfade)

    n = int(sample_rate * chunk)
    t = int(sample_rate * reverb)
    x = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, n),
                    jnp.float32)
    ir = jnp.asarray(np.random.default_rng(1).uniform(0, 1e-3, t),
                     jnp.float32)
    f = jax.jit(lambda a, i1, i2: convolve_chunk_crossfade(a, i1, i2, 1, 1))
    jax.block_until_ready(f(x, ir, ir))
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        out = f(x, ir, ir)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return (n_chunks * chunk) / dt


def bench_sweep(n_rooms=1024, n_rays=4096, max_bounces=6, ir_length=24000):
    """Room-dataset generation rate (config #5: the full 1024-room dataset
    in one vmapped program, which is how a real dataset job runs)."""
    import jax.random

    from realisticaudioraytracing2d_tpu.models.rooms import random_rooms
    from realisticaudioraytracing2d_tpu.parallel.sweep import sweep_rooms

    scenes, sources, listeners = random_rooms(n_rooms, seed=0)
    kw = dict(n_rays=n_rays, max_bounces=max_bounces, sample_rate=16000,
              ir_length=ir_length, n_frames=1)
    irs = sweep_rooms(scenes, sources, listeners, jax.random.PRNGKey(0),
                      **kw)
    jax.block_until_ready(irs)
    t0 = time.perf_counter()
    irs = sweep_rooms(scenes, sources, listeners, jax.random.PRNGKey(1),
                      **kw)
    jax.block_until_ready(irs)
    return n_rooms / (time.perf_counter() - t0)


def bench_stream_chunk(n_chunks=30):
    """Full streaming step (retrace 15k rays + crossfaded convolution +
    ring overlap-add/drain) steady-state cost per 0.1 s chunk."""
    import jax.random

    import realisticaudioraytracing2d_tpu as art

    room = art.rooms.smoll_room(pad_to=32)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener)
    streamer = art.Streamer(room.scene, cfg, jax.random.PRNGKey(0))
    chunk = jnp.zeros((cfg.audio.chunk_samples,), jnp.float32).at[0].set(1.0)
    jax.block_until_ready(streamer.process(chunk, p))          # compile
    jax.block_until_ready(streamer.process(chunk, p))          # warm
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        out = streamer.process(chunk, p)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_chunks * 1e3


def bench_stream_chunk_modes(n_chunks=30):
    """Steady-state chunk cost of the flagship streaming modes
    (round-4/5 paths the bench previously missed): per-arrival Doppler
    (device-sliced dry-history window + gliding tap synthesis),
    binaural (3-virtual-mic spatial trace + ITD/ILD decode), and the
    two composed. Per 0.1 s chunk, like bench_stream_chunk."""
    import jax.random

    import realisticaudioraytracing2d_tpu as art
    from realisticaudioraytracing2d_tpu.streaming import window_scalars

    room = art.rooms.smoll_room(pad_to=32)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener)
    n = cfg.audio.chunk_samples
    dry = jnp.asarray(np.random.default_rng(0)
                      .uniform(-1, 1, 4 * n).astype(np.float32))
    chunk = dry[:n]

    def run_mode(streamer, per_arrival, facing):
        wd = n + streamer.arrival_early + 2

        def window(i):
            if not per_arrival:
                return None
            return (dry,) + window_scalars(i, n, wd, dry.shape[-1],
                                           True) + (True,)

        out = streamer.process(chunk, p, facing=facing, window=window(0))
        jax.block_until_ready(out)                                   # compile
        out = streamer.process(chunk, p, facing=facing, window=window(1))
        jax.block_until_ready(out)                                   # warm
        t0 = time.perf_counter()
        for i in range(n_chunks):
            out = streamer.process(chunk, p, facing=facing,
                                   window=window(2 + i))
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n_chunks * 1e3

    key = jax.random.PRNGKey(0)
    pa = run_mode(art.Streamer(room.scene, cfg, key), True, 0.0)
    bi = run_mode(art.Streamer(room.scene, cfg, key, binaural=True),
                  False, 0.3)
    bpa = run_mode(art.Streamer(room.scene, cfg, key, binaural=True),
                   True, 0.3)
    return pa, bi, bpa


def bench_large_scene(n_boxes=10000, n_rays=131072, max_bounces=6,
                      n_frames=4):
    """Large-scene frame cost through ``engine.trace_accumulate`` on a
    procedural city (``4 * n_boxes + 4`` walls). Returns ``(frame_ms,
    G wall tests/s, n_walls)``, or ``None`` when the compiled program
    needs more device memory than the device has."""
    import jax.random

    import realisticaudioraytracing2d_tpu as art
    from realisticaudioraytracing2d_tpu.engine import trace_accumulate
    from realisticaudioraytracing2d_tpu.models.rooms import city_scene
    from realisticaudioraytracing2d_tpu.ops.ir import IRState

    room = city_scene(n_boxes=n_boxes)
    params = art.TraceParams.make(room.source, room.listener,
                                  room.listener_radius, 343.0, 100.0)
    state = IRState.zeros(24000, 1, 1)
    kw = dict(n_rays=n_rays, max_bounces=max_bounces, sample_rate=16000,
              n_frames=n_frames)
    compiled = trace_accumulate.lower(room.scene, params, state,
                                      jax.random.PRNGKey(0), **kw).compile()
    ma = compiled.memory_analysis()
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
    need = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
            + ma.output_size_in_bytes)
    if limit and need > limit:
        _say(f"large scene ({room.scene.n_walls} walls): needs "
             f"{need / 2**30:.1f} GiB > {limit / 2**30:.1f} GiB; skipped")
        return None
    jax.block_until_ready(compiled(room.scene, params, state,
                                   jax.random.PRNGKey(0)))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(room.scene, params, state,
                                   jax.random.PRNGKey(1)))
    dt = time.perf_counter() - t0
    tests = n_rays * max_bounces * 2 * room.scene.n_walls * n_frames
    return dt / n_frames * 1e3, tests / dt / 1e9, room.scene.n_walls


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main():
    from realisticaudioraytracing2d_tpu.utils.compile_cache import (
        enable_compile_cache)
    from realisticaudioraytracing2d_tpu.utils.profiling import card_line
    enable_compile_cache()
    _say(f"backend={jax.default_backend()} devices={jax.devices()} "
         f"card: {card_line()}")

    rps, frame_ms = bench_trace()
    _say(f"trace frame @131k rays x 8 bounces: {frame_ms:.2f} ms")
    _, ref_frame_ms = bench_trace(n_rays=15000, max_bounces=5)
    _say(f"trace frame @reference workload 15k x 5: {ref_frame_ms:.2f} ms "
         f"(60Hz budget: {'OK' if ref_frame_ms < 16.6 else 'OVER'})")
    _say(f"4-listener: {bench_quad():.2f} ms/frame")
    _say(f"IR scatter: {bench_ir_build():.2f} ms")
    _say(f"streaming conv: {bench_streaming_xrt():.0f}x realtime @44.1kHz")
    _say(f"full stream chunk (retrace+conv+ring): {bench_stream_chunk():.1f}"
         f" ms per 100 ms chunk")
    pa_ms, bi_ms, bpa_ms = bench_stream_chunk_modes()
    _say(f"per-arrival Doppler chunk: {pa_ms:.1f} ms; binaural chunk: "
         f"{bi_ms:.1f} ms; binaural+per-arrival chunk: {bpa_ms:.1f} ms")
    _say(f"room sweep: {bench_sweep():.1f} rooms/s (4096 rays x 6 bounces)")
    large = bench_large_scene()
    if large:
        _say(f"large scene ({large[2]} walls): {large[0]:.1f} ms/frame, "
             f"{large[1]:.1f} G tests/s")

    result = {
        "metric": "ray_bounce_intersections_per_sec_per_chip",
        "value": float(f"{rps:.4g}"),
        "unit": "intersections/s",
        "vs_baseline": float(f"{rps / 100e6:.4g}"),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
