"""Live audio pipeline: sim-clock producer + audio-clock consumer thread.

The reference actually *plays* its wet audio: `ProcessChunk` pushes each
convolved chunk into a mutex-protected ring buffer on the main/sim thread
(``RayTraceManager.cs:91-123`` -> ``AudioManager.PushSamples``,
``AudioManager.cs:45-54``) while Unity's audio thread drains it at DSP-
buffer granularity — 1024 samples per callback
(``AudioManager.OnAudioFilterRead``, ``AudioManager.cs:56-69``;
``ProjectSettings/AudioManager.asset`` m_DSPBufferSize) — duplicating mono
to all channels and zeroing what it consumed.

This module reproduces that two-clock contract end to end: a producer
loop runs the compiled streaming step (trace -> crossfaded convolution) and
overlap-adds wet chunks into the host :class:`~.native.NativeRingBuffer`;
a real consumer thread drains fixed DSP buffers on the audio clock. A
sample index is *drainable* once the chunk whose head covers it has been
pushed (later chunks only add reverb tail into already-final regions —
the overlap-add identity); draining past that frontier is an **underrun**
(the real callback would emit the partial sum), which is counted, not
hidden.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .config import EngineConfig
from .models.scene import Scene
from .native import NativeRingBuffer
from .ops import ir as irm
from .ops import rng as _rng
from .streaming import (_ARRIVAL_MATCH_BINS, _ARRIVAL_TAPS,
                        _ARRIVAL_WINDOW_S, DopplerFeed, _crossfaded_wet,
                        _device_window, _per_arrival_binaural,
                        _per_arrival_parts, dry_chunk, init_arrival_carry,
                        window_scalars)
from .ops.trace import TraceParams


@partial(jax.jit, static_argnames=("n_rays", "max_bounces", "sample_rate",
                                   "frames_per_chunk", "diffraction",
                                   "head_radius", "shadow",
                                   "decorrelate", "arrival_early",
                                   "arrival_taps", "arrival_match_bins",
                                   "window_loop"))
def wet_chunk(scene: Scene, params: TraceParams, prev_ir: jax.Array,
              dry: jax.Array, key: jax.Array, chunk_index: jax.Array, *,
              n_rays: int, max_bounces: int, sample_rate: int,
              frames_per_chunk: int = 1, diffraction: bool = False,
              air_alpha=None, binaural_facing=None,
              head_radius: float = 0.0875, shadow: float = 0.6,
              decorrelate: bool = True, dry_full=None, win_start=None,
              win_prefix=None, win_cut=None, arrival_early: int = 0,
              arrival_taps: int = _ARRIVAL_TAPS,
              arrival_match_bins: float = _ARRIVAL_MATCH_BINS,
              window_loop: bool = False, arrival=None,
              prev_facing=None):
    """One live step fully on-device: retrace a fresh IR for this chunk
    and return ``(wet[L, N+T], cur_ir, new_arrival)`` — the crossfaded
    convolution output *including* its reverb tail, ready for host
    overlap-add (the ``ProcessChunk`` dispatch,
    RayTraceManager.cs:100-122). ``new_arrival`` is the updated
    per-arrival :class:`..streaming.ArrivalCarry` (``None`` unless
    per-arrival Doppler is on).

    ``binaural_facing`` (traced radians; per-chunk head rotation
    recompiles nothing) switches to binaural: ``params`` carry the ONE
    head listener and ``prev_ir`` two ear channels — the chunk traces
    the 3-virtual-mic spatial capture and decodes it
    (see :func:`..streaming.stream_chunk`). ``dry_full`` + the traced
    window scalars switch on per-arrival Doppler exactly as in
    :func:`..streaming.stream_chunk`: the previous chunk's tap table
    and residual ride in ``arrival`` (+ ``prev_facing`` when
    binaural)."""
    from . import spatial as spm
    from .engine import trace_accumulate
    from .streaming import _augment_ir

    l, t, k = prev_ir.shape
    binaural = binaural_facing is not None
    tp = spm.binaural_trace_params(params, l) if binaural else params
    t_l = tp.listeners.shape[0]
    ir_state = trace_accumulate(
        scene, tp, irm.IRState.zeros(t, t_l, k),
        _rng.frame_key(key, chunk_index), n_rays=n_rays,
        max_bounces=max_bounces, sample_rate=sample_rate,
        n_frames=frames_per_chunk)
    cur_ir = _augment_ir(ir_state.normalized(), scene, tp,
                         sample_rate, diffraction, air_alpha)
    cur_sp = None
    if binaural:
        cur_sp = cur_ir
        cur_ir = spm.binaural_decode_ir(
            cur_sp, sample_rate, binaural_facing, head_radius, shadow,
            params.speed_of_sound, decorrelate=decorrelate)
    prev = jnp.where(chunk_index == 0, cur_ir, prev_ir)
    if dry_full is not None:
        # per-arrival Doppler (see streaming._per_arrival_parts): the
        # taps are THIS chunk's output samples, so they join the wet
        # chunk region before the host ring's overlap-add
        n = dry.shape[-1]
        is_first = chunk_index == 0
        window = _device_window(dry_full, n + arrival_early + 2,
                                win_start, win_prefix, win_cut,
                                window_loop)
        if binaural:
            prev_fac = jnp.where(is_first, binaural_facing,
                                 prev_facing)
            wet, taps, new_arrival = _per_arrival_binaural(
                dry, window, arrival, cur_sp, prev_fac, binaural_facing,
                is_first, n, sample_rate, head_radius, shadow,
                params.speed_of_sound, decorrelate, arrival_taps,
                arrival_match_bins)
        else:
            wet, taps, new_arrival = _per_arrival_parts(
                dry, window, arrival, cur_ir, is_first, n, k,
                arrival_taps, arrival_match_bins)
        return wet.at[:, :n].add(taps), cur_ir, new_arrival
    return _crossfaded_wet(dry, prev, cur_ir), cur_ir, None


@dataclass
class LiveReport:
    """What happened during a live run (the observability the reference
    lacks — it silently plays partial buffers)."""

    audio: np.ndarray            # [L, consumed] what the audio thread heard
    underruns: int = 0           # callbacks that outran the producer
    callbacks: int = 0           # total audio-thread drains
    chunks: int = 0              # producer chunks pushed
    producer_seconds: float = 0.0
    realtime_factor: float = 0.0  # produced audio seconds / producer wall s
    max_lead_samples: int = 0    # peak producer lead over the consumer
    late_samples: int = 0        # tail energy dropped: consumer already past

    def summary(self) -> str:
        return (f"{self.chunks} chunks, {self.callbacks} callbacks "
                f"({self.underruns} underruns), producer "
                f"{self.realtime_factor:.2f}x realtime, peak lead "
                f"{self.max_lead_samples} samples, "
                f"{self.late_samples} late samples dropped")


class LivePlayer:
    """Producer/consumer driver for the live pipeline.

    ``realtime=True`` paces the consumer on the wall clock (one drain per
    ``dsp_buffer / sample_rate`` seconds, exactly like the audio thread) —
    underruns happen whenever the producer is slower than realtime.
    ``realtime=False`` paces the consumer on the producer's frontier
    (integrity mode: every sample is final when read), which is the mode
    tests use to check the threaded path is lossless.
    """

    def __init__(self, scene: Scene, config: EngineConfig, key: jax.Array,
                 n_listeners: int = 1, frames_per_chunk: int = 1,
                 dsp_buffer: int = 1024, ring_size: Optional[int] = None,
                 diffraction: bool = False, air_alpha=None,
                 binaural: bool = False, head_radius: float = 0.0875,
                 shadow: float = 0.6, decorrelate: bool = True,
                 arrival_taps: int = _ARRIVAL_TAPS,
                 arrival_window_s: float = _ARRIVAL_WINDOW_S,
                 arrival_match_bins: float = _ARRIVAL_MATCH_BINS):
        if binaural and n_listeners != 1:
            raise ValueError("binaural live takes one head listener")
        if arrival_taps < 1:
            raise ValueError("arrival_taps must be >= 1")
        self.scene = scene
        self.config = config
        self.key = key
        self.n_listeners = 2 if binaural else n_listeners
        self.frames_per_chunk = frames_per_chunk
        self.dsp_buffer = dsp_buffer
        self.diffraction = diffraction
        self.air_alpha = air_alpha
        self.binaural = binaural
        self.head_radius = head_radius
        self.shadow = shadow
        self.decorrelate = decorrelate
        self.arrival_taps = int(arrival_taps)
        self.arrival_match_bins = float(arrival_match_bins)
        self.arrival_early = min(
            config.audio.ir_length,
            int(round(arrival_window_s * config.audio.sample_rate)))
        n = config.audio.chunk_samples
        t = config.audio.ir_length
        if ring_size is None:
            # ring sized like the reference: reverb + 1 s of slack
            # (AudioManager.cs:30-32), floored to hold chunk + tail + buffer
            ring_size = max(t + 2 * n + dsp_buffer,
                            t + config.audio.sample_rate)
        # below this the producer's backpressure wait and the consumer's
        # frontier wait could interlock
        min_size = n + t + dsp_buffer
        if ring_size < min_size:
            raise ValueError(f"ring_size {ring_size} < chunk+tail+dsp "
                             f"minimum {min_size}")
        self.ring = NativeRingBuffer(ring_size, self.n_listeners)

    def run(self, dry: jax.Array, total_chunks: int,
            loop: Optional[bool] = None, realtime: bool = False,
            params_fn: Optional[Callable[[int], TraceParams]] = None,
            params: Optional[TraceParams] = None,
            on_chunk: Optional[Callable[[int, jax.Array], None]] = None,
            prime: int = 1,
            facing_fn: Optional[Callable[[int], float]] = None,
            doppler: bool = False, sink=None, control_fn=None,
            scene_fn=None, record: bool = True) -> LiveReport:
        """``on_chunk(i, cur_ir)`` (optional) runs on the producer thread
        after chunk ``i`` is pushed, with that chunk's normalized IR
        ``[L, T, K]`` — the live-feedback hook (the reference blits the
        DrawIR texture every frame while audio plays,
        RayTraceManager.cs:252-258). Keep it cheap: it runs inside the
        producer's chunk budget.

        ``prime``: in realtime mode the audio clock starts once the first
        ``prime`` chunks are final (a prebuffer, like any streaming
        player) — playback begins one chunk latency after Space, and
        underruns then measure actual producer lag, not startup. 0
        restores the bare clock.

        ``doppler=True`` feeds the producer through the SAME
        :class:`..streaming.DopplerFeed` fractional-rate resampler the
        offline :meth:`..streaming.Streamer.stream_clip` uses — a moving
        pose pitch-shifts identically live and offline (integrity-mode
        live output is sample-exact against the Doppler stream).
        ``doppler="per_arrival"`` likewise mirrors the streamer's
        per-path mode (each dominant early arrival glides at its own
        rate; see :meth:`..streaming.Streamer.stream_clip`): the same
        tap extraction runs inside ``wet_chunk``, so live and stream
        agree here too. K == 1, non-binaural.

        ``sink`` (an object with ``write(block[C, N]) -> frames``, e.g.
        :class:`..native.AudioSink`) receives every drained DSP buffer
        on the consumer thread — audible playback, the reference's
        engine-to-sound-card hop (``AudioManager.cs:56-69``). With a
        real device sink the blocking device write IS the audio clock,
        so the consumer skips the wall-clock sleep in realtime mode
        (underrun accounting unchanged); the drained audio is still
        recorded in the report.

        ``control_fn(i) -> dict`` carries the reference's runtime verbs
        (``RayTraceManager.cs:55-61``) exactly like
        :meth:`..streaming.Streamer.stream_clip`: ``"reset_ir"`` drops
        the producer's IR memory before chunk ``i``; ``"stop"``
        silences the dry feed and ends the run after flushing the
        reverb tail (the consumer's goal shrinks accordingly — the
        report's audio is shorter). ``scene_fn(i) -> Scene`` supplies
        per-chunk geometry (dynamic obstacles / pose-feed geometry
        steering); same padded wall count = no recompile.

        ``record=False`` drops the drained audio instead of keeping the
        whole session in the report (~0.2 MB/s/listener at 48 kHz —
        unbounded for an open-ended live session). Playback through
        ``sink``, underrun/lead accounting, and every other report
        field are unaffected; ``report.audio`` comes back empty. Use it
        whenever the session's sound leaves through the sink rather
        than the return value (it is how ``scripts/soak_live.py`` keeps
        a 10-minute session's RSS flat enough to catch real leaks)."""
        cfg = self.config
        n = cfg.audio.chunk_samples
        t = cfg.audio.ir_length
        sr = cfg.audio.sample_rate
        loop = cfg.audio.loop if loop is None else loop
        if params_fn is None:
            if params is None:
                raise ValueError("pass params or params_fn")
            params_fn = lambda i: params  # noqa: E731

        frontier = 0                      # samples final & drainable
        consumed = 0                      # samples the audio thread drained
        frontier_lock = threading.Condition()
        stop = threading.Event()
        report = LiveReport(audio=np.zeros((self.n_listeners, 0),
                                           np.float32))
        total_samples = total_chunks * n
        # the consumer's goal in samples; shrinks when a control stop
        # ends the run early (read/written under frontier_lock)
        goal = [total_samples]
        prev_ir = jnp.zeros((self.n_listeners, t, self.scene.n_bands),
                            jnp.float32)
        producer_err = []

        per_arrival = doppler == "per_arrival"
        feed = DopplerFeed(dry, params_fn, n, sr, total_chunks,
                           loop) if (doppler and not per_arrival) else None
        wd = n + self.arrival_early + 2
        total_dry = dry.shape[-1]
        tail_chunks = (t + n - 1) // n

        def producer():
            nonlocal frontier, prev_ir
            carry = (init_arrival_carry(t, self.n_listeners,
                                        self.scene.n_bands,
                                        self.arrival_taps, self.binaural)
                     if per_arrival else None)
            prev_fac = (jnp.zeros((), jnp.float32)
                        if (self.binaural and per_arrival) else None)
            stop_at = None
            end_step = total_chunks
            t0 = time.perf_counter()
            try:
                for i in range(total_chunks):
                    if i >= end_step:
                        break
                    if control_fn is not None:
                        ctrl = control_fn(i) or {}
                        if ctrl.get("reset_ir"):
                            prev_ir = jnp.zeros_like(prev_ir)
                            if carry is not None:
                                carry = jax.tree_util.tree_map(
                                    jnp.zeros_like, carry)
                        if ctrl.get("stop") and stop_at is None:
                            stop_at = i * n
                            end_step = min(end_step, i + tail_chunks)
                            with frontier_lock:
                                goal[0] = min(goal[0], end_step * n)
                                frontier_lock.notify_all()
                    if stop_at is not None:
                        piece = jnp.zeros((n,), jnp.float32)
                    else:
                        piece = (feed.chunk(i) if feed is not None
                                 else dry_chunk(dry, i, n, loop))
                    win = window_scalars(i, n, wd, total_dry, loop,
                                         stop_at) if per_arrival \
                        else (None, None, None)
                    # mono dry is broadcast per listener inside wet_chunk
                    facing = None
                    if self.binaural:
                        facing = jnp.asarray(
                            facing_fn(i) if facing_fn is not None
                            else 0.0, jnp.float32)
                    wet, prev_ir, new_carry = wet_chunk(
                        (scene_fn(i) if scene_fn is not None
                         else self.scene), params_fn(i), prev_ir, piece,
                        self.key, jnp.asarray(i, jnp.int32),
                        n_rays=cfg.sim.ray_count,
                        max_bounces=cfg.sim.max_bounces,
                        sample_rate=sr,
                        frames_per_chunk=self.frames_per_chunk,
                        diffraction=self.diffraction,
                        air_alpha=self.air_alpha,
                        binaural_facing=facing,
                        head_radius=self.head_radius,
                        shadow=self.shadow,
                        decorrelate=self.decorrelate,
                        dry_full=dry if per_arrival else None,
                        win_start=win[0], win_prefix=win[1],
                        win_cut=win[2],
                        arrival_early=(self.arrival_early if per_arrival
                                       else 0),
                        arrival_taps=self.arrival_taps,
                        arrival_match_bins=self.arrival_match_bins,
                        window_loop=loop and per_arrival,
                        arrival=carry, prev_facing=prev_fac)
                    if carry is not None:
                        carry = new_carry
                    if prev_fac is not None:
                        prev_fac = facing
                    wet_np = np.asarray(wet)  # device->host readback
                    if wet_np.ndim == 1:
                        wet_np = wet_np[None, :]
                    head = i * n
                    span_end = head + wet_np.shape[-1]
                    with frontier_lock:
                        # Backpressure: a push may only cover live ring
                        # cells [consumed, consumed + size). Without this
                        # a fast producer wraps around and overlap-adds on
                        # top of undrained audio (silent corruption).
                        while (span_end - consumed > self.ring.size
                               and not stop.is_set()):
                            frontier_lock.wait(timeout=1.0)
                        if stop.is_set():
                            break
                        # Clip energy the consumer already played past:
                        # pushing behind the read head would resurface it
                        # one ring cycle later as ghost audio. The real
                        # callback emitted the partial sum; drop the rest.
                        off = max(0, consumed - head)
                        if off < wet_np.shape[-1]:
                            self.ring.push(wet_np[:, off:], head + off)
                        report.late_samples += min(off, wet_np.shape[-1])
                        frontier = (i + 1) * n
                        frontier_lock.notify_all()
                    report.chunks = i + 1
                    if on_chunk is not None:
                        on_chunk(i, prev_ir)
                    if stop.is_set():
                        break
            except Exception as e:          # pragma: no cover - surfaced
                producer_err.append(e)
            finally:
                report.producer_seconds = time.perf_counter() - t0
                with frontier_lock:
                    frontier_lock.notify_all()

        out = []

        def consumer():
            nonlocal consumed
            if realtime and prime > 0:
                # prebuffer: hold the audio clock until the first chunks
                # are final (bounded wait; a dead producer releases us
                # via the notify in its finally block)
                with frontier_lock:
                    while (frontier < min(prime * n, goal[0])
                           and not producer_err):
                        if not frontier_lock.wait(timeout=60.0):
                            break
            next_tick = time.perf_counter()
            period = self.dsp_buffer / sr
            while consumed < goal[0] and not producer_err:
                if realtime:
                    if sink is None:
                        next_tick += period
                        delay = next_tick - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    # else: the device's blocking write paces us — the
                    # drained-audio write below, or the silence write on
                    # a skipped tick
                    skip = False
                    with frontier_lock:
                        if frontier < min(consumed + self.dsp_buffer,
                                          goal[0]):
                            report.underruns += 1
                            skip = frontier <= consumed
                    if skip:
                        # nothing final yet: the real callback emits one
                        # DSP period of silence. The device write blocks
                        # for that period (outside the lock), so a
                        # lagging producer sees a paced consumer, not a
                        # busy-spin pegging the core and inflating the
                        # underrun count once per spin; without a sink
                        # the wall-clock sleep above already paced this
                        # tick.
                        if sink is not None:
                            sink.write(np.zeros(
                                (self.ring.channels, self.dsp_buffer),
                                np.float32))
                        continue
                else:
                    with frontier_lock:
                        while (frontier < min(consumed + self.dsp_buffer,
                                              goal[0])
                               and not producer_err):
                            frontier_lock.wait(timeout=60.0)
                with frontier_lock:
                    # drain under the lock so a concurrent push can never
                    # straddle the advancing read head mid-copy
                    want = min(self.dsp_buffer, goal[0] - consumed)
                    if want <= 0:     # a control stop shrank the goal
                        break
                    buf = self.ring.drain(want)  # read + zero
                    consumed += want
                    report.callbacks += 1
                    report.max_lead_samples = max(
                        report.max_lead_samples, frontier - consumed)
                    frontier_lock.notify_all()
                if record:
                    out.append(buf)
                if sink is not None:
                    # outside the lock: a blocking device write must not
                    # stall the producer's push
                    sink.write(buf)

        tp = threading.Thread(target=producer, name="sim-producer")
        tc = threading.Thread(target=consumer, name="audio-consumer")
        tp.start()
        tc.start()
        tc.join()
        stop.set()
        tp.join()
        if producer_err:
            raise producer_err[0]
        report.audio = (np.concatenate(out, axis=-1) if out
                        else report.audio)
        produced_s = report.chunks * n / sr
        report.realtime_factor = (produced_s / report.producer_seconds
                                  if report.producer_seconds > 0 else 0.0)
        return report
