"""High-level engine: trace -> IR accumulation -> convolution.

The functional replacement of the reference's orchestrators
(``RayTraceManager.RunSimulation``/``OnSimulationFinished``,
``Assets/Script/RayTraceManager.cs:179-244``, and the legacy offline
``BakeAudio`` path, ``RayTraceManagerComplex.cs:170-227``): per-frame state
is an explicit :class:`~.ops.ir.IRState` threaded through pure jitted
steps, multi-frame Monte-Carlo accumulation is a ``lax.scan`` inside one
compiled program, and the offline bake is FFT convolution + peak
normalization.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .config import EngineConfig
from .models.scene import Scene
from .ops import convolve as cv
from .ops import ir as irm
from .ops import rng as _rng
from .ops.trace import DebugPaths, Hits, TraceParams, trace, trace_hits_only


@partial(jax.jit,
         static_argnames=("n_rays", "max_bounces", "sample_rate", "n_frames"))
def trace_accumulate(scene: Scene, params: TraceParams, state: irm.IRState,
                     key: jax.Array, *, n_rays: int, max_bounces: int,
                     sample_rate: int, n_frames: int = 1) -> irm.IRState:
    """Run ``n_frames`` trace frames and accumulate them into ``state`` —
    the Update->RunSimulation->ProcessHits loop as one compiled scan.

    Each frame folds its index into the key (the functional analogue of the
    reference's ``rngStateOffset = Time.frameCount`` reseed,
    RayTraceManager.cs:197), so frames are independent MC samples. Every
    platform runs this one XLA program: the trace of ``ops/trace.py`` and
    the scatter-add deposit of ``ops/ir.py``.
    """
    def body(st, i):
        hits = trace_hits_only(scene, params, _rng.frame_key(key, i),
                               n_rays=n_rays, max_bounces=max_bounces)
        return irm.accumulate(st, hits, sample_rate), None

    state, _ = jax.lax.scan(body, state,
                            jnp.arange(n_frames, dtype=jnp.int32))
    return state


@partial(jax.jit, static_argnames=("normalize",))
def bake_audio(dry: jax.Array, state: irm.IRState, *,
               normalize: bool = True) -> jax.Array:
    """Offline bake: convolve a full dry clip with the accumulated IR.

    Reference: ``BakeAudio`` dispatches the direct-convolution kernel over
    the whole clip then peak-normalizes before playback
    (``RayTraceManagerComplex.cs:170-245``). Here: one FFT convolution
    against the frame-averaged (optionally banded, multi-listener) IR.
    Returns ``[N+T]`` mono or ``[L, N+T]``.
    """
    ir = state.normalized()                  # [L, T, K]
    if ir.shape[0] == 1:
        ir = ir[0]                           # -> [T, K] (mono listener)
    wet = cv.apply_ir(dry, ir, accum_count=1)
    return cv.peak_normalize(wet) if normalize else wet


class Engine:
    """Convenience wrapper binding a scene + config to the pure functions.

    Keeps no mutable simulation state — it only caches static shape info so
    call sites stay terse. All returned values are pytrees you thread
    yourself (or via :class:`~.streaming.Streamer`).
    """

    def __init__(self, scene: Scene, config: EngineConfig,
                 n_listeners: int = 1):
        self.scene = scene
        self.config = config
        self.n_listeners = n_listeners

    # -- state constructors --------------------------------------------------
    def fresh_ir(self) -> irm.IRState:
        return irm.IRState.zeros(self.config.audio.ir_length,
                                 self.n_listeners, self.scene.n_bands)

    def params(self, source, listener, directivity=None,
               mic_directivity=None) -> TraceParams:
        return TraceParams.make(
            source, listener,
            listener_radius=self.config.sim.listener_radius,
            speed_of_sound=self.config.sim.speed_of_sound,
            input_gain=self.config.sim.input_gain,
            directivity=directivity, mic_directivity=mic_directivity)

    # -- simulation ----------------------------------------------------------
    def trace_frames(self, params: TraceParams, key: jax.Array,
                     n_frames: int = 1,
                     state: Optional[irm.IRState] = None) -> irm.IRState:
        state = self.fresh_ir() if state is None else state
        return trace_accumulate(
            self.scene, params, state, key,
            n_rays=self.config.sim.ray_count,
            max_bounces=self.config.sim.max_bounces,
            sample_rate=self.config.audio.sample_rate, n_frames=n_frames)

    def trace_debug(self, params: TraceParams, key: jax.Array,
                    n_debug: int = 100) -> Tuple[Hits, DebugPaths]:
        hits, dbg = trace(self.scene, params, key,
                          n_rays=self.config.sim.ray_count,
                          max_bounces=self.config.sim.max_bounces,
                          n_debug=n_debug)
        return hits, dbg

    def bake(self, dry: jax.Array, state: irm.IRState,
             normalize: bool = True) -> jax.Array:
        return bake_audio(dry, state, normalize=normalize)
