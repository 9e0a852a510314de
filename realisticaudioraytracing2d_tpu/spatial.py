"""Spatial impulse responses: per-bin 2D acoustic intensity (W/X/Y).

The reference records a scalar energy IR per listener — it has no notion
of *where* sound arrives from (``Raytrace2D.compute:74-84,101-119`` keep
only delay + energy). This module adds the 2D analogue of a first-order
Ambisonics / sound-intensity measurement, built entirely from machinery
that already exists and is already tested:

* ``W[t] = sum_h e_h``                 — omnidirectional energy (the
  ordinary IR),
* ``X[t] = sum_h e_h cos(theta_h)``,
* ``Y[t] = sum_h e_h sin(theta_h)``    — the per-bin energy-weighted
  arrival-direction resultant (2D intensity vector),

where ``theta_h`` is the incoming sound direction of hit ``h`` at the
listener and the sums run over the hits landing in IR bin ``t``.

**Exact extraction via virtual microphones.** Signed weights cannot ride
:func:`..ops.directivity.evaluate` directly (it clamps power gains at
zero), but the first-order cardioid family never clamps:
``1 + cos(theta - aim) >= 0``. So each listener is traced as THREE
coincident virtual microphones — omni ``g = 1``, cardioid at 0
``g = 1 + cos(theta)``, cardioid at pi/2 ``g = 1 + sin(theta)`` — using
the per-listener ``mic_directivity`` table, and

``X = IR_cardioid0 - IR_omni``,  ``Y = IR_cardioid90 - IR_omni``

hold *per hit*, hence exactly per bin. No new capture code, no new
scatter: the spatial IR inherits every tested behavior of the capture
paths (direct, NEE, and the diffraction pass, which all honor
``mic_directivity``).

What it buys:

* **post-hoc steering** (:meth:`SpatialIR.steer`): the IR of any
  first-order virtual mic ``g = a + b cos(theta - aim)`` with
  ``|b| <= a`` (so ``g >= 0`` per hit) is the exact linear combination
  ``a W + b (X cos aim + Y sin aim)`` — re-aim a stereo pair without
  retracing;
* **direction-of-arrival analysis** (:meth:`SpatialIR.arrival_angle`):
  ``atan2(Y, X)`` per bin localizes the direct sound and each early
  reflection from one receiver position;
* **diffuseness** (:meth:`SpatialIR.diffuseness`):
  ``1 - |(X, Y)| / W`` per bin — 0 for a single coherent arrival
  direction, -> 1 for isotropic late reverberation (the energy-vector
  form used by DirAC-style spatial-IR analysis);
* **binaural rendering** (:meth:`SpatialIR.binaural`): a DirAC-style
  two-ear decode — per-bin coherent energy gets the free-field
  interaural time difference (fractional two-bin splat) and a
  first-order head-shadow level difference, diffuse energy reaches both
  ears unlateralized. CLI: ``bake --binaural FACING_DEG``.

The capture is one trace with three pattern-weighted listeners at the
head position, through the same :func:`..engine.trace_accumulate` as
any other trace.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .ops import ir as irm
from .ops.trace import TraceParams

#: Virtual-microphone coefficient rows (Fourier power-gain series
#: ``[c0, c_cos, c_sin]``): omni, cardioid aimed at 0, cardioid at pi/2.
_PATTERNS = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 0.0, 1.0))

#: Order-2 extension ``[c0, cos, sin, cos2, sin2]``: the three above plus
#: ``1 + cos(2 theta)`` and ``1 + sin(2 theta)`` — still non-negative per
#: hit, so the per-hit moment identity is exact at second order too.
_PATTERNS2 = ((1.0, 0.0, 0.0, 0.0, 0.0),
              (1.0, 1.0, 0.0, 0.0, 0.0),
              (1.0, 0.0, 1.0, 0.0, 0.0),
              (1.0, 0.0, 0.0, 1.0, 0.0),
              (1.0, 0.0, 0.0, 0.0, 1.0))


def _ear_signs(n_t: int, ear_seed: int):
    """Deterministic per-bin random-sign (Rademacher) pattern ``[T]``
    for one ear's diffuse-stream decorrelator.

    The IR bins are *energies* — the trace discarded the pressure sign
    (``Raytrace2D.compute:164`` sums ``rayInfo.energy``), and the decode
    output is used directly as an amplitude convolution kernel (the
    reference's ``AudioConvolve`` semantics). A real diffuse late field
    has independent random phase at each ear; re-synthesizing it as an
    independent random sign per bin per ear is exactly random-phase
    late-reverb synthesis. (A near-allpass FIR decorrelator — the other
    standard — cannot work HERE: it preserves the DC component, and an
    all-positive energy tail is dominated by DC, which would stay
    interaurally coherent.)

    Per-bin magnitude is untouched, so every energy measure of the
    diffuse stream (per-bin |.|, L1 of |.|, L2) is conserved exactly.
    Deterministic by construction (fixed seed folded with ``ear_seed``)
    so jitted decodes never retrace and repeat runs are bit-identical.
    Returns a host numpy float32 array of +-1 (a compile-time constant
    under jit).
    """
    import numpy as np

    rng = np.random.default_rng(0xD1FF05E ^ (ear_seed * 0x9E3779B9))
    return (rng.integers(0, 2, n_t) * 2.0 - 1.0).astype(np.float32)


class SpatialIR(NamedTuple):
    """Per-bin spatial energy IR. All channels are ``[L, T, K]``;
    ``x2``/``y2`` (second circular moments, present when traced with
    ``order=2``) sharpen DoA — see :func:`two_arrival_bearings`."""

    w: jax.Array  # omni energy (identical to the ordinary IR)
    x: jax.Array  # energy-weighted sum of cos(arrival angle)
    y: jax.Array  # energy-weighted sum of sin(arrival angle)
    x2: Optional[jax.Array] = None  # sum of e cos(2 angle) (order 2)
    y2: Optional[jax.Array] = None  # sum of e sin(2 angle) (order 2)

    @property
    def order(self) -> int:
        return 2 if self.x2 is not None else 1

    @property
    def n_listeners(self) -> int:
        return self.w.shape[0]

    def steer(self, aim, b: float = 1.0, a: float = 1.0,
              c: float = 0.0) -> jax.Array:
        """IR of a virtual mic ``g = a + b cos(theta - aim)
        + c cos(2 (theta - aim))`` at the same position(s), ``[L, T, K]``.

        Exactly equals retracing with that pattern as the
        ``mic_directivity`` Fourier series as long as it is non-negative
        per hit; values that dip negative raise (they would need the
        per-hit clamp a linear combination cannot reproduce). ``c != 0``
        needs an ``order=2`` capture (:func:`spatial_params`) and unlocks
        the sharper second-order family — e.g. the 2D "supercardioid"
        ``a=1, b=4/3, c=1/3`` whose main lobe is ~30% narrower than the
        cardioid's, steered post hoc with no retrace."""
        if _steer_min(a, b, c) < -1e-6 * max(abs(a), abs(b), abs(c), 1.0):
            raise ValueError(
                f"invalid power pattern (a={a}, b={b}, c={c}): "
                f"g = a + b cos + c cos2 goes negative per hit")
        if c and self.x2 is None:
            raise ValueError("second-harmonic steering (c != 0) needs an "
                             "order=2 capture: spatial_params(order=2)")
        aim = jnp.asarray(aim, jnp.float32)
        out = a * self.w + b * (jnp.cos(aim) * self.x +
                                jnp.sin(aim) * self.y)
        if c:
            out = out + c * (jnp.cos(2.0 * aim) * self.x2 +
                             jnp.sin(2.0 * aim) * self.y2)
        return out

    def stereo(self, aim=0.0, spread: float = math.pi / 2
               ) -> Tuple[jax.Array, jax.Array]:
        """(left, right) cardioid-pair IRs, aimed ``aim +- spread/2`` —
        the post-hoc equivalent of the CLI's ``--stereo-aim`` XY pair."""
        half = spread / 2.0
        return self.steer(aim + half), self.steer(aim - half)

    def binaural(self, sample_rate: int, facing: float = 0.0,
                 head_radius: float = 0.0875, shadow: float = 0.6,
                 speed_of_sound: float = 343.0,
                 decorrelate: bool = True
                 ) -> Tuple[jax.Array, jax.Array]:
        """(left, right) ear IRs with interaural time AND level
        differences — a DirAC-style decode of the intensity IR.

        Each bin's energy splits into a coherent part ``|(X, Y)|``
        arriving from ``atan2(Y, X)`` and a diffuse remainder
        ``W - |(X, Y)|``:

        * the coherent part reaches the ear at ``facing +- pi/2`` (left
          ear ``+``) with the free-field plane-wave delay
          ``-+ (r / c) sin(phi)`` (``phi`` = bearing relative to
          ``facing``; a source on the left reaches the left ear
          ``2 r / c`` before the right) as a fractional two-bin splat,
          and with the first-order head-shadow gain
          ``1 +- shadow * sin(phi)``;
        * the diffuse part has no direction: each ear receives its full
          share (an omni microphone in a diffuse field captures the
          whole ``W``; the angle-average of ``1 +- shadow sin`` is 1)
          through a per-ear **decorrelator** (:func:`_ear_signs`): an
          independent deterministic random sign per bin per ear —
          random-phase re-synthesis of the late field — so the two
          ears' diffuse streams are interaurally INCOHERENT. Real
          diffuse reverberation has low interaural cross-correlation; a
          bit-identical diffuse stream in both ears localizes "in the
          head" (DirAC decodes decorrelate for exactly this reason).
          ``decorrelate=False`` restores the pre-round-4 identical
          -diffuse decode; decorrelation is also skipped for the
          degenerate no-head decode (``head_radius == 0 and
          shadow == 0``: coincident ears receive identical signals, so
          ``left == right == W`` holds exactly there).

        Conservation: the coherent path re-splats exactly ``2 coh``
        (per-bin ear gains sum to 2) bit-identically to the
        non-decorrelated decode, and the diffuse stream keeps its exact
        per-bin energy magnitude in both ears (only signs differ) —
        each STREAM is conserved separately. The summed ear IR is a
        SIGNED amplitude kernel, not an energy IR: a bin holding both
        coherent and sign-flipped diffuse energy partially cancels
        inside ``|.|``, so ``sum(|left + right|)`` and per-ear L1 are
        NOT invariants of the decorrelated decode (through the
        convolution the sign/coherent cross terms are zero-mean, so
        delivered energy is conserved in expectation). Run energy
        analysis (EDC/RT60/...) on ``self.w`` or a
        ``decorrelate=False`` decode, whose plain ``left + right`` L1
        identity does hold; feed the decorrelated ears only to the
        convolve/bake pipeline.
        The decode is post-hoc — no retrace — and jit-safe (the sign
        patterns are compile-time constants). Returns two
        ``[L, T, K]`` IRs ready for the standard convolve/bake
        pipeline. ``shadow`` in [0, 1] sets the ILD strength (0 = ITD
        only); the delay model omits head diffraction (Woodworth's wrap
        term) — at ``r`` = 8.75 cm the error is < 0.13 ms."""
        if not 0.0 <= shadow <= 1.0:
            raise ValueError(f"shadow must be in [0, 1], got {shadow}")
        r = jnp.sqrt(self.x * self.x + self.y * self.y)   # coherent
        coh = jnp.minimum(r, self.w)
        diffuse = self.w - coh                            # per ear, full
        phi = jnp.arctan2(self.y, self.x) - facing
        s = jnp.sin(phi)
        n_t = self.w.shape[1]
        bins = jnp.arange(n_t, dtype=jnp.float32)[None, :, None]
        max_shift = head_radius / speed_of_sound * sample_rate
        # Degenerate no-head decode: coincident ears -> identical
        # signals; decorrelating would fabricate an interaural
        # difference a radius-0 head cannot have.
        decorr = (decorrelate
                  and not (head_radius == 0.0 and shadow == 0.0))

        def ear(sign):
            # sign = +1 left ear, -1 right ear
            gain = 1.0 + sign * shadow * s
            # left: earlier for phi>0. Clamp BEFORE computing frac: an
            # unclamped t < 0 (arrival within max_shift bins of bin 0)
            # would make (1-frac) > 1 and frac < 0 — amplified and
            # negative-energy deposits.
            t = jnp.clip(bins - sign * max_shift * s, 0.0,
                         float(n_t - 1))
            lo = jnp.floor(t)
            frac = t - lo
            lo = lo.astype(jnp.int32)
            hi = jnp.minimum(lo + 1, n_t - 1)
            e = coh * gain
            out = jnp.zeros_like(self.w)
            out = out.at[jnp.arange(self.w.shape[0])[:, None, None],
                         lo, jnp.arange(self.w.shape[2])[None, None, :]
                         ].add(e * (1.0 - frac))
            out = out.at[jnp.arange(self.w.shape[0])[:, None, None],
                         hi, jnp.arange(self.w.shape[2])[None, None, :]
                         ].add(e * frac)
            if decorr:
                signs = _ear_signs(n_t, ear_seed=0 if sign > 0 else 1)
                return out + diffuse * jnp.asarray(signs)[None, :, None]
            return out + diffuse

        return ear(1.0), ear(-1.0)

    def arrival_angle(self) -> jax.Array:
        """Dominant arrival bearing per bin, ``atan2(Y, X)`` in
        ``(-pi, pi]``, ``[L, T, K]``. Meaningful where the bin holds
        energy and :meth:`diffuseness` is low."""
        return jnp.arctan2(self.y, self.x)

    def diffuseness(self) -> jax.Array:
        """``1 - |(X, Y)| / W`` per bin in [0, 1]: 0 = one coherent
        direction, 1 = isotropic. Bins with no energy report 1 (nothing
        coherent there). ``[L, T, K]``."""
        r = jnp.sqrt(self.x * self.x + self.y * self.y)
        psi = 1.0 - r / jnp.where(self.w > 0.0, self.w, 1.0)
        return jnp.clip(jnp.where(self.w > 0.0, psi, 1.0), 0.0, 1.0)


def _steer_min(a: float, b: float, c: float) -> float:
    """Exact minimum of ``a + b cos(u) + c cos(2u)`` over ``u`` (used to
    validate steering patterns). With ``t = cos(u)``:
    ``f(t) = a - c + b t + 2 c t^2`` on ``[-1, 1]`` — min over the two
    endpoints and the interior stationary point ``t* = -b / (4c)``."""
    cands = [a + b + c, a - b + c]
    if c != 0.0:
        t = -b / (4.0 * c)
        if -1.0 <= t <= 1.0:
            cands.append(a - c + b * t + 2.0 * c * t * t)
    return min(cands)


def spatial_params(params: TraceParams, order: int = 1) -> TraceParams:
    """Expand ``params`` so each of its ``L`` listeners becomes the
    coincident virtual microphones of the moment capture (pattern-major:
    rows ``[0, L)`` omni, ``[L, 2L)`` cardioid-0, ``[2L, 3L)``
    cardioid-90; ``order=2`` adds ``1 + cos(2 theta)`` and
    ``1 + sin(2 theta)`` rows for the second circular moments — listener
    axis ``3L`` or ``5L``).

    The result can be used anywhere a ``TraceParams`` is —
    ``engine.trace_accumulate``, the streaming chunk step, the
    diffraction pass — with an ``IRState.zeros(T, 3 * L or 5 * L, K)``
    state.

    Raises if ``params`` already has a mic pattern: spatial capture IS a
    mic-pattern assignment, the two cannot compose.
    """
    if params.mic_directivity is not None:
        raise ValueError("spatial capture replaces mic_directivity; "
                         "steer the SpatialIR afterwards instead")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    pats = _PATTERNS if order == 1 else _PATTERNS2
    listeners = params.listeners                       # [L, 2]
    n_l = listeners.shape[0]
    table = jnp.repeat(jnp.asarray(pats, jnp.float32), n_l, axis=0)
    return params._replace(
        listeners=jnp.tile(listeners, (len(pats), 1)),
        mic_directivity=table)


def binaural_trace_params(params: TraceParams,
                          n_channels: int) -> TraceParams:
    """Validate-and-expand for the binaural chunk steps (shared by
    :func:`..streaming.stream_chunk` and :func:`..live.wet_chunk`):
    ``params`` must carry ONE listener (the head) and the stream state
    ``n_channels == 2`` ear channels; returns the 3-virtual-mic
    :func:`spatial_params` expansion."""
    if params.listeners.shape[0] != 1 or n_channels != 2:
        raise ValueError("binaural chunk step: params carry the one "
                         "head listener and the stream state two ear "
                         "channels (n_listeners=2)")
    return spatial_params(params)


def binaural_decode_ir(cur_ir: jax.Array, sample_rate: int, facing,
                       head_radius: float, shadow: float,
                       speed_of_sound,
                       decorrelate: bool = True) -> jax.Array:
    """Split a freshly traced ``[3, T, K]`` spatial IR and decode it to
    the two-ear ``[2, T, K]`` IR — the per-chunk binaural step shared by
    the streaming and live pipelines."""
    sp_ir = spatial_from_ir(cur_ir)
    lft, rgt = sp_ir.binaural(sample_rate, facing, head_radius, shadow,
                              speed_of_sound, decorrelate=decorrelate)
    return jnp.concatenate([lft, rgt], axis=0)


def spatial_from_ir(ir: jax.Array, order: int = 1) -> SpatialIR:
    """Split an IR traced under :func:`spatial_params` — shape
    ``[3L, T, K]`` (or ``[5L, T, K]`` for ``order=2``; normalized or raw
    sum alike, the split is linear) — into :class:`SpatialIR` channels
    ``[L, T, K]``."""
    n_pat = 3 if order == 1 else 5
    if ir.ndim != 3 or ir.shape[0] % n_pat != 0:
        raise ValueError(f"expected [{n_pat}L, T, K] from "
                         f"spatial_params(order={order}), got {ir.shape}")
    n_l = ir.shape[0] // n_pat
    w = ir[:n_l]
    out = SpatialIR(w=w, x=ir[n_l:2 * n_l] - w, y=ir[2 * n_l:3 * n_l] - w)
    if order == 2:
        out = out._replace(x2=ir[3 * n_l:4 * n_l] - w,
                           y2=ir[4 * n_l:5 * n_l] - w)
    return out


def dominant_arrivals(sp_ir: SpatialIR, sample_rate: int, *,
                      listener: int = 0, band: int = 0, n: int = 5,
                      window_bins: int = 16, min_fraction: float = 0.02):
    """Peak-pick the strongest distinct arrivals of one listener/band and
    report where each came from — the DoA summary table.

    Greedy host-side analysis (numpy, not jitted): repeatedly take the
    most energetic remaining bin, aggregate the intensity vector over
    ``+- window_bins`` around it (one reflection's energy smears over a
    few bins), and suppress that window. Stops after ``n`` arrivals or
    when a peak falls below ``min_fraction`` of the strongest.

    Returns a list of dicts with ``time_s``, ``bearing_rad`` (direction
    the sound arrives FROM, in world frame), ``diffuseness``, ``energy``.
    """
    import numpy as np

    w = np.asarray(sp_ir.w)[listener, :, band].copy()
    x = np.asarray(sp_ir.x)[listener, :, band].copy()
    y = np.asarray(sp_ir.y)[listener, :, band].copy()
    out = []
    floor = float(w.max()) * min_fraction
    for _ in range(n):
        peak = int(w.argmax())
        if w[peak] <= max(floor, 0.0):
            break
        lo, hi = max(0, peak - window_bins), peak + window_bins + 1
        # x/y are zeroed alongside w below, so an overlapping later
        # window cannot aggregate a suppressed arrival's intensity
        # vector into its bearing.
        ew, ex, ey = w[lo:hi].sum(), x[lo:hi].sum(), y[lo:hi].sum()
        out.append({
            "time_s": peak / sample_rate,
            "bearing_rad": float(math.atan2(ey, ex)),
            "diffuseness": float(1.0 - min(1.0, math.hypot(ex, ey) /
                                           max(ew, 1e-30))),
            "energy": float(ew),
        })
        w[lo:hi] = 0.0
        x[lo:hi] = 0.0
        y[lo:hi] = 0.0
    return out


def onset_bearing(sp_ir: SpatialIR, time_s: float, sample_rate: int, *,
                  listener: int = 0, band: int = 0, onset_bins: int = 4,
                  background_bins: int = 8, guard_bins: int = 2) -> float:
    """Bearing (radians) of the arrival whose energy ONSET is at
    ``time_s``, with the pre-arrival field subtracted.

    Between discrete reflections the IR is not silent: NEE deposits at
    every bounce form a smoothly decaying directional continuum, and a
    window straddling an echo onset mixes the two. This estimator models
    the continuum as locally constant: the per-bin mean intensity vector
    over ``background_bins`` bins ending ``guard_bins`` before the onset
    is scaled to the onset span and subtracted from the onset's summed
    vector — leaving the new arrival's direction.

    For a listener disc of radius ``r``, capture begins ``r / c`` before
    the center-distance arrival time: pass the rim-corrected onset
    ``(d - r) / c``. Keep ``onset_bins`` SHORT (a few bins): the tracer's
    NEE connects from every wall point, so a wall reflection is the onset
    of a continuum — only the earliest bins are dominated by the
    stationary (specular) wall point; a window covering the full
    ``2 r / c`` disc smear also integrates continuum energy that is
    biased toward the wall end nearer the listener.
    """
    import numpy as np

    x = np.asarray(sp_ir.x)[listener, :, band]
    y = np.asarray(sp_ir.y)[listener, :, band]
    t0 = int(round(time_s * sample_rate))
    lo = max(0, t0 - guard_bins - background_bins)
    hi = max(0, t0 - guard_bins)
    n_bg = max(1, hi - lo)
    bg_x = x[lo:hi].sum() / n_bg
    bg_y = y[lo:hi].sum() / n_bg
    vx = x[t0:t0 + onset_bins].sum() - onset_bins * bg_x
    vy = y[t0:t0 + onset_bins].sum() - onset_bins * bg_y
    return float(math.atan2(vy, vx))


def trace_spatial(scene, params: TraceParams, key: jax.Array, *,
                  n_rays: int, max_bounces: int, sample_rate: int,
                  ir_length: int, n_frames: int = 1,
                  state: Optional[irm.IRState] = None, order: int = 1
                  ) -> Tuple[SpatialIR, irm.IRState]:
    """One-call spatial trace: accumulate ``n_frames`` frames of the
    virtual-mic moment capture (3 mics, or 5 with ``order=2``) and split
    the frame-averaged result.

    Returns ``(SpatialIR, IRState)`` — keep the state to accumulate more
    frames (pass it back as ``state=``).
    """
    from .engine import trace_accumulate
    sp = spatial_params(params, order=order)
    if state is None:
        state = irm.IRState.zeros(ir_length, sp.listeners.shape[0],
                                  scene.n_bands)
    state = trace_accumulate(scene, sp, state, key, n_rays=n_rays,
                             max_bounces=max_bounces,
                             sample_rate=sample_rate, n_frames=n_frames)
    return spatial_from_ir(state.normalized(), order=order), state


def two_arrival_bearings(sp_ir: SpatialIR, lo_bin: int, hi_bin: int, *,
                         listener: int = 0, band: int = 0,
                         grid: int = 360, refine: int = 3):
    """Resolve TWO simultaneous arrivals inside one analysis window from
    the circular moments — what first-order intensity provably cannot do
    (its single vector is the energy-weighted mean direction; two
    arrivals smear into one bearing between them with raised
    diffuseness).

    Model: the window holds arrivals at bearings ``t1, t2`` with
    energies ``e1, e2 >= 0``. The captured moments are
    ``m0 = e1 + e2``, ``m1 = e1 u(t1) + e2 u(t2)``,
    ``m2 = e1 u(2 t1) + e2 u(2 t2)`` (``u`` = unit vector) — 5 real
    knowns, 4 unknowns. Solved by separable least squares: for candidate
    ``(t1, t2)`` the optimal energies are a 2x2 nonnegative linear solve;
    a coarse bearing grid + ``refine`` local refinement passes picks the
    residual minimizer. Host-side analysis (numpy), like
    :func:`dominant_arrivals`.

    Returns ``[(bearing_rad, energy), (bearing_rad, energy)]`` sorted by
    energy (descending). Requires an ``order=2`` capture.
    """
    import numpy as np

    if sp_ir.x2 is None:
        raise ValueError("two_arrival_bearings needs an order=2 capture")
    sl = (listener, slice(lo_bin, hi_bin), band)
    m0 = float(np.asarray(sp_ir.w)[sl].sum())
    m1 = np.array([np.asarray(sp_ir.x)[sl].sum(),
                   np.asarray(sp_ir.y)[sl].sum()])
    m2 = np.array([np.asarray(sp_ir.x2)[sl].sum(),
                   np.asarray(sp_ir.y2)[sl].sum()])

    def residual(t1, t2):
        # design matrix: each arrival contributes (1, u(t), u(2t))
        a = np.array([[1.0, 1.0],
                      [np.cos(t1), np.cos(t2)],
                      [np.sin(t1), np.sin(t2)],
                      [np.cos(2 * t1), np.cos(2 * t2)],
                      [np.sin(2 * t1), np.sin(2 * t2)]])
        b = np.array([m0, m1[0], m1[1], m2[0], m2[1]])
        e, *_ = np.linalg.lstsq(a, b, rcond=None)
        e = np.maximum(e, 0.0)
        return float(((a @ e - b) ** 2).sum()), e

    # Coarse pass, vectorized over all bearing pairs: per-pair optimal
    # energies come from the closed-form 2x2 normal equations (unclamped
    # here; the refine passes use the clamped lstsq).
    ts = np.linspace(-np.pi, np.pi, grid, endpoint=False)
    cols = np.stack([np.ones(grid), np.cos(ts), np.sin(ts),
                     np.cos(2 * ts), np.sin(2 * ts)], axis=1)   # [G, 5]
    b = np.array([m0, m1[0], m1[1], m2[0], m2[1]])
    gram = cols @ cols.T                                        # ci . cj
    cb = cols @ b                                               # ci . b
    ii, jj = np.triu_indices(grid)
    g11 = np.diag(gram)[ii]
    g22 = np.diag(gram)[jj]
    g12 = gram[ii, jj]
    det = g11 * g22 - g12 * g12
    det = np.where(np.abs(det) < 1e-12, np.inf, det)  # t1 == t2: singular
    e1 = (g22 * cb[ii] - g12 * cb[jj]) / det
    e2 = (g11 * cb[jj] - g12 * cb[ii]) / det
    # residual of the exact (unclamped) solve: |b|^2 - e . (A^T b)
    res = (b @ b) - (e1 * cb[ii] + e2 * cb[jj])
    res = np.where(np.isfinite(res), res, np.inf)
    k = int(np.argmin(res))
    r0, e0 = residual(ts[ii[k]], ts[jj[k]])
    best = (r0, ts[ii[k]], ts[jj[k]], e0)
    step = 2 * np.pi / grid
    for _ in range(refine):
        step /= 4.0
        _, t1, t2, _ = best
        for d1 in (-step, 0.0, step):
            for d2 in (-step, 0.0, step):
                r, e = residual(t1 + d1, t2 + d2)
                if r < best[0]:
                    best = (r, t1 + d1, t2 + d2, e)
    _, t1, t2, e = best
    out = sorted([(float(np.arctan2(np.sin(t), np.cos(t))), float(en))
                  for t, en in ((t1, e[0]), (t2, e[1]))],
                 key=lambda p: -p[1])
    return out
