#!/usr/bin/env python
"""On-card smoke test of the main path, at the sizes users run.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded sweep and
                                       # ray-sharded trace only

Phases (one process; the CPU references run on the in-process CPU
backend, so only this process opens the card):

* device  — refuse to run unless ``jax.devices()[0].platform == "gpu"``;
* trace   — ``Engine.trace_frames`` at the reference workload (SmollRoom,
  15,000 rays x 5 bounces, 48 kHz, 72,000-bin IR) and at the heavy shape
  (131,072 rays x 8 bounces x 50 frames, walls padded to 32): compile
  seconds, steady ms/frame, and IR + hit-record parity with the same key
  traced on the CPU;
* determinism — the reference frame twice with one key;
* bake    — ``Engine.bake`` of the bundled dry clip vs the same IR
  convolved on the CPU;
* stream  — ``Streamer.stream_clip`` in plain, per-arrival, binaural and
  binaural + per-arrival modes (ms per 0.1 s chunk), plus the chunked
  reconstruction check of the plain stream;
* live    — ``LivePlayer`` with no audio device;
* sweep   — ``sweep_rooms`` over 1,024 procedural rooms (4,096 rays x 6
  bounces, 24,000 bins at 16 kHz), 4 rooms checked against the CPU;
* fit     — 3 Adam steps of ``diff.fit_materials`` at the reference
  workload;
* memory  — ``memory_analysis()`` of the heavy trace and of a 40,008-wall
  city scene (131,072 rays x 6 bounces).

Everything prints on earlier lines; the last line is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``. Any failed
phase exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

# Parity of a GPU trace against the CPU trace of the same key. Both sides
# draw the same jax.random stream and run the same float32 program with no
# matrix product on the device; what differs is the ulp behaviour of
# sin/cos/arcsin/sqrt, which flips razor-edge wall and listener hits, and
# the order of the atomic scatter-add. Those flips move a few records.
ENERGY_REL_TOL = 0.01       # total IR energy
ENVELOPE_REL_TOL = 0.05     # relative L2 of the 5 ms energy envelope
HIT_DIFF_TOL = 0.005        # share of valid hit records that differ
BAKE_REL_TOL = 1e-4         # cuFFT vs pocketfft, same IR, float32
CHUNK_BUDGET_MS = 100.0     # one 0.1 s chunk of audio

REF_RAYS, REF_BOUNCES = 15000, 5
HEAVY_RAYS, HEAVY_BOUNCES, HEAVY_FRAMES, HEAVY_PAD = 131072, 8, 50, 32
SWEEP_ROOMS, SWEEP_RAYS, SWEEP_BOUNCES = 1024, 4096, 6
SWEEP_SR, SWEEP_IR = 16000, 24000
CITY_BOXES, CITY_RAYS, CITY_BOUNCES = 10001, 131072, 6
STREAM_CHUNKS = 24
LIVE_CHUNKS = 20
FIT_STEPS = 3


# -- parity metrics (pure numpy; unit-tested on the CPU) ---------------------

def first_arrival(ir: np.ndarray) -> int:
    """First bin holding energy above 1e-6 of the IR's peak, -1 if none."""
    ir = np.asarray(ir, np.float64)
    peak = float(ir.max()) if ir.size else 0.0
    if peak <= 0.0:
        return -1
    return int(np.argmax(ir > 1e-6 * peak))


def ir_parity(ir: np.ndarray, ref: np.ndarray, sample_rate: int) -> dict:
    """Compare a 1-D energy IR with its reference: total-energy relative
    error, first-arrival bins and the relative L2 of the 5 ms envelope."""
    ir = np.asarray(ir, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    e_ref = float(ref.sum())
    energy_rel = abs(float(ir.sum()) - e_ref) / e_ref if e_ref > 0 \
        else float(ir.sum() != 0.0)
    win = max(1, sample_rate // 200)
    n = (len(ref) // win) * win
    env = ir[:n].reshape(-1, win).sum(1)
    env_ref = ref[:n].reshape(-1, win).sum(1)
    norm = float(np.linalg.norm(env_ref))
    env_rel = float(np.linalg.norm(env - env_ref)) / norm if norm > 0 \
        else float(np.linalg.norm(env) != 0.0)
    return {"energy_rel": energy_rel, "first": first_arrival(ir),
            "first_ref": first_arrival(ref), "envelope_rel": env_rel}


def parity_failures(m: dict) -> list:
    """The tolerances an :func:`ir_parity` result breaks (empty = pass)."""
    out = []
    if m["energy_rel"] > ENERGY_REL_TOL:
        out.append(f"energy off by {m['energy_rel']:.3%}")
    if m["first"] != m["first_ref"]:
        out.append(f"first arrival bin {m['first']} != {m['first_ref']}")
    if m["envelope_rel"] > ENVELOPE_REL_TOL:
        out.append(f"5 ms envelope off by {m['envelope_rel']:.3%}")
    if "hit_diff" in m and m["hit_diff"] > HIT_DIFF_TOL:
        out.append(f"{m['hit_diff']:.3%} of valid hit records differ")
    return out


def hit_diff_share(valid: np.ndarray, valid_ref: np.ndarray) -> float:
    """Share of hit records valid on either side whose validity differs."""
    valid = np.asarray(valid, bool)
    valid_ref = np.asarray(valid_ref, bool)
    either = int((valid | valid_ref).sum())
    return int((valid != valid_ref).sum()) / max(1, either)


def result_line(devices) -> str:
    """The contract's last line, from the devices JAX reports."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def phases(four_cards: bool) -> list:
    if four_cards:
        return ["four_cards"]
    return ["trace", "determinism", "bake", "stream", "live", "sweep",
            "fit", "memory"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded checks")
    return ap.parse_args(argv)


# -- phases ------------------------------------------------------------------

def _report(name: str, m: dict) -> None:
    fails = parity_failures(m)
    nums = ", ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in m.items())
    print(f"  {name}: {nums} -> {'ok' if not fails else 'FAIL'}")
    if fails:
        raise AssertionError(f"{name}: " + "; ".join(fails))


class Smoke:
    """Phases share the GPU results they produce (the reference IR feeds
    the bake; the reference setup feeds stream, live and fit)."""

    def __init__(self):
        import jax
        import realisticaudioraytracing2d_tpu as art
        self.jax = jax
        self.art = art
        self.cpu = jax.devices("cpu")[0]
        self.gpu = jax.devices()[0]
        self.room = art.rooms.smoll_room()
        self.cfg = art.smoll_room_config()
        self.eng = art.Engine(self.room.scene, self.cfg)
        self.params = self.eng.params(self.room.source, self.room.listener)
        self.key = jax.random.PRNGKey(0)
        self.ref_state = None

    def on_cpu(self, tree):
        return self.jax.device_put(tree, self.cpu)

    def block(self, x):
        return self.jax.block_until_ready(x)

    def _engine(self, scene, n_rays, bounces, device=None):
        cfg = dataclasses.replace(self.cfg, sim=dataclasses.replace(
            self.cfg.sim, ray_count=n_rays, max_bounces=bounces))
        if device is not None:
            scene = self.jax.device_put(scene, device)
        return self.art.Engine(scene, cfg)

    def _trace_case(self, label, scene, params, n_rays, bounces, n_frames,
                    cpu_frames):
        """Time ``Engine.trace_frames`` on the card, then compare its first
        ``cpu_frames`` frames (same key) with the CPU backend."""
        jax = self.jax
        from realisticaudioraytracing2d_tpu.ops import rng as _rng
        from realisticaudioraytracing2d_tpu.ops.trace import trace_hits_only
        sr = self.cfg.audio.sample_rate
        eng = self._engine(scene, n_rays, bounces)
        t0 = time.perf_counter()
        st = self.block(eng.trace_frames(params, self.key, n_frames))
        compile_s = time.perf_counter() - t0
        # the first run after a compile is slower than steady state
        self.block(eng.trace_frames(params, jax.random.fold_in(self.key, 1),
                                    n_frames))
        runs = []
        for i in range(3):
            t0 = time.perf_counter()
            self.block(eng.trace_frames(
                params, jax.random.fold_in(self.key, 2 + i), n_frames))
            runs.append((time.perf_counter() - t0) / n_frames * 1e3)
        print(f"  {label}: compile+first run {compile_s:.2f} s, steady "
              f"{np.median(runs):.3f} ms/frame (median of 3 runs of "
              f"{n_frames} frames; min {min(runs):.3f}, max {max(runs):.3f})")
        gpu_ir = eng.trace_frames(params, self.key, cpu_frames).normalized()
        k0 = _rng.frame_key(self.key, 0)
        gpu_hits = trace_hits_only(scene, params, k0, n_rays=n_rays,
                                   max_bounces=bounces)
        eng_cpu = self._engine(scene, n_rays, bounces, self.cpu)
        with jax.default_device(self.cpu):
            p_cpu = self.on_cpu(params)
            cpu_ir = eng_cpu.trace_frames(p_cpu, self.on_cpu(self.key),
                                          cpu_frames).normalized()
            cpu_hits = trace_hits_only(eng_cpu.scene, p_cpu,
                                       self.on_cpu(k0), n_rays=n_rays,
                                       max_bounces=bounces)
        m = ir_parity(np.asarray(gpu_ir)[0, :, 0],
                      np.asarray(cpu_ir)[0, :, 0], sr)
        m["hit_diff"] = hit_diff_share(np.asarray(gpu_hits.valid),
                                       np.asarray(cpu_hits.valid))
        _report(f"{label} vs CPU ({cpu_frames} frames)", m)
        return st

    def trace(self):
        self.ref_state = self._trace_case(
            f"reference {REF_RAYS} x {REF_BOUNCES}", self.room.scene,
            self.params,
            REF_RAYS, REF_BOUNCES, 50, 2)
        heavy = self.art.rooms.smoll_room(pad_to=HEAVY_PAD)
        hp = self.art.TraceParams.make(heavy.source, heavy.listener,
                                       heavy.listener_radius, 343.0, 1.0)
        self._trace_case(f"heavy {HEAVY_RAYS} x {HEAVY_BOUNCES}",
                         heavy.scene, hp, HEAVY_RAYS,
                         HEAVY_BOUNCES, HEAVY_FRAMES, 1)

    def determinism(self):
        a = self.block(self.eng.trace_frames(self.params, self.key))
        b = self.block(self.eng.trace_frames(self.params, self.key))
        a, b = np.asarray(a.sum), np.asarray(b.sum)
        diff = float(np.max(np.abs(a - b)))
        print(f"  same key twice: bit-equal {np.array_equal(a, b)}, "
              f"max |diff| {diff:.3e} (peak {float(a.max()):.3e})")
        _report("run 2 vs run 1", ir_parity(b[0, :, 0], a[0, :, 0],
                                            self.cfg.audio.sample_rate))

    def bake(self):
        jnp = self.jax.numpy
        from realisticaudioraytracing2d_tpu.engine import bake_audio
        from realisticaudioraytracing2d_tpu.ops.convolve import load_samples
        from realisticaudioraytracing2d_tpu.utils.audio_io import (
            builtin_clip_path, read_audio)
        x, rate = read_audio(builtin_clip_path())
        dry = np.asarray(load_samples(jnp.asarray(x), rate,
                                      self.cfg.audio.sample_rate))
        state = self.ref_state
        t0 = time.perf_counter()
        wet = np.asarray(self.eng.bake(jnp.asarray(dry), state))
        dt = time.perf_counter() - t0
        with self.jax.default_device(self.cpu):
            ref = np.asarray(bake_audio(self.on_cpu(jnp.asarray(dry)),
                                        self.on_cpu(state)))
        rel = float(np.linalg.norm(wet - ref) / np.linalg.norm(ref))
        ok = np.isfinite(wet).all() and rel <= BAKE_REL_TOL
        print(f"  bake {dry.shape[0]} samples x {state.ir_length}-bin IR: "
              f"{dt * 1e3:.1f} ms incl. compile, rel L2 vs CPU {rel:.3e} "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"bake differs from CPU by {rel:.3e}")

    def _dry(self, seconds):
        from realisticaudioraytracing2d_tpu.utils.audio_io import noise_burst
        sr = self.cfg.audio.sample_rate
        return self.jax.numpy.asarray(noise_burst(seconds, sr, seed=5))

    def stream(self):
        jax = self.jax
        art = self.art
        n = self.cfg.audio.chunk_samples
        dry = self._dry(1.0)
        modes = {"plain": ({}, False), "per-arrival": ({}, "per_arrival"),
                 "binaural": ({"binaural": True}, False),
                 "binaural+per-arrival": ({"binaural": True},
                                          "per_arrival")}
        for name, (kw, doppler) in modes.items():
            streamer = art.Streamer(self.room.scene, self.cfg, self.key,
                                    **kw)
            stamps = []

            def on_chunk(i, state):
                jax.block_until_ready(state.ring.data)
                stamps.append(time.perf_counter())

            t0 = time.perf_counter()
            out = np.asarray(streamer.stream_clip(
                dry, lambda i: self.params, loop=True,
                total_chunks=STREAM_CHUNKS, on_chunk=on_chunk,
                doppler=doppler,
                facing_fn=(lambda i: 0.3) if kw else None))
            per = np.diff([t0] + stamps) * 1e3
            steady = float(np.median(per[4:]))
            ok = np.isfinite(out).all() and out.shape[-1] == STREAM_CHUNKS * n
            print(f"  {name}: first chunk {per[0]:.0f} ms (compile), steady "
                  f"median {steady:.2f} ms / p90 "
                  f"{float(np.percentile(per[4:], 90)):.2f} ms per "
                  f"{CHUNK_BUDGET_MS:.0f} ms chunk, out {out.shape} "
                  f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"stream {name}: non-finite output")
        self._stream_reconstruction()

    def _stream_reconstruction(self):
        """Plain chunked stream == host overlap-add of per-chunk crossfaded
        convolutions of IRs traced with the same chunk keys."""
        from realisticaudioraytracing2d_tpu.engine import trace_accumulate
        from realisticaudioraytracing2d_tpu.ops import ir as irm
        from realisticaudioraytracing2d_tpu.ops import rng as _rng
        from realisticaudioraytracing2d_tpu.streaming import _crossfaded_wet
        cfg = self.cfg
        n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
        total = 6
        key = self.jax.random.PRNGKey(11)
        dry = self._dry(total * n / cfg.audio.sample_rate)
        wet = np.asarray(self.art.Streamer(self.room.scene, cfg, key)
                         .stream_clip(dry, lambda i: self.params, loop=False,
                                      total_chunks=total))[0]
        acc = np.zeros(total * n + n + t)
        prev = None
        for i in range(total):
            cur = trace_accumulate(
                self.room.scene, self.params, irm.IRState.zeros(t, 1, 1),
                _rng.frame_key(key, i), n_rays=cfg.sim.ray_count,
                max_bounces=cfg.sim.max_bounces,
                sample_rate=cfg.audio.sample_rate).normalized()
            piece = dry[i * n:(i + 1) * n]
            w = np.asarray(_crossfaded_wet(
                piece[None, :], cur if prev is None else prev, cur))[0]
            acc[i * n:i * n + len(w)] += w
            prev = cur
        err = float(np.max(np.abs(wet - acc[:total * n])))
        ok = np.allclose(wet, acc[:total * n], rtol=2e-3, atol=2e-5)
        print(f"  plain stream vs per-chunk reconstruction ({total} chunks): "
              f"max |diff| {err:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("chunked stream != reconstruction")

    def live(self):
        from realisticaudioraytracing2d_tpu import native
        from realisticaudioraytracing2d_tpu.live import LivePlayer
        dry = self._dry(1.0)
        LivePlayer(self.room.scene, self.cfg, self.key).run(
            dry, total_chunks=1, loop=False, realtime=False,
            params=self.params)                             # compile
        rep = LivePlayer(self.room.scene, self.cfg, self.key).run(
            dry, total_chunks=LIVE_CHUNKS, loop=True, realtime=True,
            params=self.params)
        ok = rep.chunks == LIVE_CHUNKS and np.isfinite(rep.audio).all()
        ring = ("built and used" if native.available()
                else "unavailable (NumPy fallback)")
        print(f"  live: {rep.summary()}; native ring {ring} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("live run incomplete or non-finite")

    def sweep(self):
        jax = self.jax
        from realisticaudioraytracing2d_tpu.models.rooms import random_rooms
        from realisticaudioraytracing2d_tpu.parallel.sweep import sweep_rooms
        scenes, sources, listeners = random_rooms(SWEEP_ROOMS, seed=0)
        kw = dict(n_rays=SWEEP_RAYS, max_bounces=SWEEP_BOUNCES,
                  sample_rate=SWEEP_SR, ir_length=SWEEP_IR, n_frames=1)
        t0 = time.perf_counter()
        irs = self.block(sweep_rooms(scenes, sources, listeners,
                                     self.key, **kw))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.block(sweep_rooms(scenes, sources, listeners,
                               jax.random.PRNGKey(1), **kw))
        rate = SWEEP_ROOMS / (time.perf_counter() - t0)
        irs = np.asarray(irs)
        shape_ok = irs.shape == (SWEEP_ROOMS, 1, SWEEP_IR, 1)
        finite = bool(np.isfinite(irs).all())
        print(f"  {SWEEP_ROOMS} rooms: compile+first run {compile_s:.2f} s, "
              f"{rate:.1f} rooms/s steady, shape {irs.shape}, finite "
              f"{finite}")
        if not (shape_ok and finite):
            raise AssertionError("sweep: bad shape or non-finite IRs")
        head = jax.tree_util.tree_map(lambda x: x[:4], (scenes, sources,
                                                         listeners))
        with jax.default_device(self.cpu):
            ref = np.asarray(sweep_rooms(*self.on_cpu(head),
                                         self.on_cpu(self.key), **kw))
        for r in range(4):
            _report(f"room {r} vs CPU",
                    ir_parity(irs[r, 0, :, 0], ref[r, 0, :, 0], SWEEP_SR))

    def fit(self):
        jax = self.jax
        from realisticaudioraytracing2d_tpu import diff
        a = self.cfg.audio
        scene = self.room.scene
        # target: the shipped materials; start: absorption pulled to 0.2
        target = diff.simulate_ir(scene, self.params, jax.random.PRNGKey(7),
                                  n_rays=REF_RAYS, max_bounces=REF_BOUNCES,
                                  sample_rate=a.sample_rate,
                                  ir_length=a.ir_length, frames=1)
        start = scene._replace(absorption=jax.numpy.full_like(
            scene.absorption, 0.2))
        t0 = time.perf_counter()
        res = diff.fit_materials(start, self.params, target, self.key,
                                 n_rays=REF_RAYS, max_bounces=REF_BOUNCES,
                                 sample_rate=a.sample_rate, steps=FIT_STEPS,
                                 lr=0.05, resample=False)
        losses = np.asarray(res.losses)
        dt = time.perf_counter() - t0
        ok = np.isfinite(losses).all() and losses[-1] < losses[0]
        print(f"  fit {FIT_STEPS} Adam steps in {dt:.1f} s incl. compile: "
              f"losses {', '.join(f'{v:.5f}' for v in losses)} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fit: loss non-finite or not falling")

    def memory(self):
        jax = self.jax
        from realisticaudioraytracing2d_tpu.engine import trace_accumulate
        from realisticaudioraytracing2d_tpu.models.rooms import city_scene
        from realisticaudioraytracing2d_tpu.ops.ir import IRState
        stats = self.gpu.memory_stats() or {}
        limit = stats.get("bytes_limit", 0)
        print(f"  device bytes_limit {limit / 2**30:.2f} GiB")
        heavy = self.art.rooms.smoll_room(pad_to=HEAVY_PAD)
        hp = self.art.TraceParams.make(heavy.source, heavy.listener,
                                       heavy.listener_radius, 343.0, 1.0)
        city = city_scene(n_boxes=CITY_BOXES)
        cp = self.art.TraceParams.make(city.source, city.listener,
                                       city.listener_radius, 343.0, 100.0)
        cases = [
            (f"heavy {HEAVY_RAYS} x {HEAVY_BOUNCES}, {HEAVY_PAD} walls",
             heavy.scene, hp, HEAVY_RAYS,
             HEAVY_BOUNCES, self.cfg.audio.sample_rate,
             self.cfg.audio.ir_length, HEAVY_FRAMES),
            (f"city {city.scene.n_walls} walls, {CITY_RAYS} x "
             f"{CITY_BOUNCES}", city.scene, cp,
             CITY_RAYS, CITY_BOUNCES, SWEEP_SR, SWEEP_IR, 1)]
        for label, scene, p, rays, bounces, sr, t, frames in cases:
            kw = dict(n_rays=rays, max_bounces=bounces, sample_rate=sr,
                      n_frames=frames)
            zeros = IRState.zeros(t, 1, 1)
            compiled = trace_accumulate.lower(scene, p, zeros, self.key,
                                              **kw).compile()
            ma = compiled.memory_analysis()
            need = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
                    + ma.output_size_in_bytes)
            print(f"  {label}: temp {ma.temp_size_in_bytes / 2**30:.3f} GiB,"
                  f" arguments {ma.argument_size_in_bytes / 2**20:.2f} MiB, "
                  f"outputs {ma.output_size_in_bytes / 2**20:.2f} MiB")
            if limit and need > limit:
                print(f"  {label}: needs {need / 2**30:.2f} GiB > limit, "
                      f"does not fit; skipped")
                continue
            self.block(compiled(scene, p, zeros, self.key))
            t0 = time.perf_counter()
            out = self.block(compiled(scene, p, zeros,
                                      jax.random.fold_in(self.key, 1)))
            ms = (time.perf_counter() - t0) / frames * 1e3
            e = float(out.sum.sum())
            print(f"  {label}: {ms:.2f} ms/frame, IR energy {e:.4e}")
            if not np.isfinite(e):
                raise AssertionError(f"{label}: non-finite IR")

    def four_cards(self):
        jax = self.jax
        from realisticaudioraytracing2d_tpu.models.rooms import random_rooms
        from realisticaudioraytracing2d_tpu.ops import ir as irm
        from realisticaudioraytracing2d_tpu.ops.trace import trace_hits_only
        from realisticaudioraytracing2d_tpu.parallel.mesh import make_mesh
        from realisticaudioraytracing2d_tpu.parallel.rays import (
            trace_rays_sharded)
        from realisticaudioraytracing2d_tpu.parallel.sweep import (
            sweep_rooms, sweep_rooms_sharded)
        devs = jax.devices()
        if len(devs) != 4:
            raise AssertionError(f"--four-cards needs 4 GPUs, have {devs}")
        mesh = make_mesh((4,), ("rooms",))
        scenes, sources, listeners = random_rooms(SWEEP_ROOMS, seed=0)
        kw = dict(n_rays=SWEEP_RAYS, max_bounces=SWEEP_BOUNCES,
                  sample_rate=SWEEP_SR, ir_length=SWEEP_IR, n_frames=1)
        t0 = time.perf_counter()
        sh = self.block(sweep_rooms_sharded(scenes, sources, listeners,
                                            self.key, mesh, **kw))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.block(sweep_rooms_sharded(scenes, sources, listeners,
                                       jax.random.PRNGKey(1), mesh, **kw))
        rate = SWEEP_ROOMS / (time.perf_counter() - t0)
        placed = sorted(s.device.id for s in sh.addressable_shards)
        print(f"  sharded sweep: compile+first run {compile_s:.2f} s, "
              f"{rate:.1f} rooms/s on 4 cards, shards on devices {placed}")
        if placed != sorted(d.id for d in devs):
            raise AssertionError(f"shards not one per card: {placed}")
        one = self.block(sweep_rooms(*jax.device_put(
            (scenes, sources, listeners, self.key), devs[0]), **kw))
        sh, one = np.asarray(sh), np.asarray(one)
        print(f"  sharded vs one card: bit-equal {np.array_equal(sh, one)}, "
              f"max |diff| {float(np.max(np.abs(sh - one))):.3e}")
        worst = {"energy_rel": 0.0, "envelope_rel": 0.0}
        for r in range(SWEEP_ROOMS):
            m = ir_parity(sh[r, 0, :, 0], one[r, 0, :, 0], SWEEP_SR)
            if parity_failures(m):
                _report(f"room {r} sharded vs one card", m)
            for k in worst:
                worst[k] = max(worst[k], m[k])
        print(f"  all {SWEEP_ROOMS} rooms within tolerance; worst energy "
              f"{worst['energy_rel']:.3e}, envelope "
              f"{worst['envelope_rel']:.3e}")

        heavy = self.art.rooms.smoll_room(pad_to=HEAVY_PAD)
        hp = self.art.TraceParams.make(heavy.source, heavy.listener,
                                       heavy.listener_radius, 343.0, 1.0)
        rmesh = make_mesh((4,), ("rays",))
        a = self.cfg.audio
        rkw = dict(sample_rate=a.sample_rate, ir_length=a.ir_length)
        t0 = time.perf_counter()
        ir = self.block(trace_rays_sharded(heavy.scene, hp, self.key, rmesh,
                                           n_rays=HEAVY_RAYS,
                                           max_bounces=HEAVY_BOUNCES, **rkw))
        dt = time.perf_counter() - t0
        with jax.default_device(devs[0]):
            ref = 0
            for d in range(4):
                hits = trace_hits_only(heavy.scene, hp,
                                       jax.random.fold_in(self.key, d),
                                       n_rays=HEAVY_RAYS // 4,
                                       max_bounces=HEAVY_BOUNCES)
                ref = ref + np.asarray(irm.scatter_hits(hits, **rkw))
        print(f"  ray-sharded heavy trace: {dt:.2f} s incl. compile")
        _report("ray-sharded vs sum of 4 one-card traces",
                ir_parity(np.asarray(ir)[0, :, 0], ref[0, :, 0],
                          a.sample_rate))


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        # the CPU references run in this same process
        jax.config.update("jax_platforms", plats + ",cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{devices[0].platform} ({devices[0].device_kind})",
              file=sys.stderr)
        return 1
    from realisticaudioraytracing2d_tpu.utils.compile_cache import (
        enable_compile_cache)
    from realisticaudioraytracing2d_tpu.utils.profiling import card_line
    print(f"compile cache: {enable_compile_cache()}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    smoke = Smoke()
    for name in phases(args.four_cards):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return 1
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
