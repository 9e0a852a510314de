"""Real-time streaming pipeline: chunked convolution with live IR updates.

Functional re-design of the reference's streaming path (SURVEY.md section
3.3): ``FixedUpdate`` chunk clock + ``ProcessChunk`` coroutine
(``Assets/Script/RayTraceManager.cs:64-123``) and the ``AudioManager``
overlap-add ring buffer (``Assets/Script/AudioManager.cs:45-69``).

Per audio chunk (0.1 s by default) the compiled :func:`stream_chunk` step:

1. traces ``frames_per_chunk`` Monte-Carlo frames into a fresh IR (the
   reference's double-buffered accumulate-then-reset cycle, made explicit);
2. convolves the dry chunk against the *previous* chunk's IR and the new
   one simultaneously and **crossfades** between them — replacing the
   reference's audible hard IR switch (the improvement BASELINE.json's
   north-star specifies);
3. overlap-adds the wet chunk (including its reverb tail) into a ring
   buffer and drains exactly one chunk for output — add-then-zero, the
   ``PushSamples``/``OnAudioFilterRead`` contract.

Everything lives on-device in one jit per chunk; state is an explicit
pytree (:class:`StreamState`) with donated buffers in the host loop.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .config import EngineConfig
from .models.scene import Scene
from .ops import convolve as cv
from .ops import ir as irm
from .ops import rng as _rng
from .ops.trace import TraceParams

# per-arrival Doppler defaults (see the "per-arrival Doppler" section
# below; exposed as Streamer/LivePlayer kwargs and CLI flags)
_ARRIVAL_TAPS = 6        # taps tracked per listener
_ARRIVAL_WINDOW_S = 0.12  # early window the taps may live in
_ARRIVAL_MATCH_BINS = 64.0  # max bin drift matched chunk-to-chunk


class RingBuffer(NamedTuple):
    """Additive ring buffer ``[L, S]`` (AudioManager.cs:45-69 semantics:
    writes add, reads zero what they consume)."""

    data: jax.Array       # [L, S]
    read_head: jax.Array  # scalar int32

    @staticmethod
    def zeros(size: int, n_listeners: int = 1) -> "RingBuffer":
        return RingBuffer(data=jnp.zeros((n_listeners, size), jnp.float32),
                          read_head=jnp.zeros((), jnp.int32))

    @property
    def size(self) -> int:
        return self.data.shape[-1]

    def push(self, samples: jax.Array, offset: jax.Array) -> "RingBuffer":
        """Overlap-add ``samples[L, N]`` at absolute sample ``offset``
        (wrapped mod size) — ``PushSamples`` (AudioManager.cs:45-54)."""
        n = samples.shape[-1]
        idx = (offset + jnp.arange(n)) % self.size
        return self._replace(data=self.data.at[:, idx].add(samples))

    def drain(self, n: int) -> Tuple[jax.Array, "RingBuffer"]:
        """Read + zero ``n`` samples from the read head —
        ``OnAudioFilterRead`` (AudioManager.cs:56-69)."""
        idx = (self.read_head + jnp.arange(n)) % self.size
        out = self.data[:, idx]
        data = self.data.at[:, idx].set(0.0)
        return out, RingBuffer(data=data,
                               read_head=(self.read_head + n) % self.size)


class ArrivalCarry(NamedTuple):
    """Previous chunk's per-arrival Doppler products, carried so chunk
    ``i`` never recomputes what chunk ``i - 1`` already produced: the
    previous IR's arrival table IS the last chunk's current table, and
    the crossfade's prev-side residual IS the last chunk's cur-side
    residual (binaural: its decoded ears, saving a full
    :func:`..spatial.binaural_decode_ir` — four ``[., T, K]``
    scatter-adds — per chunk).

    ``res`` is the tap-removed residual the crossfade reads ``[L, T,
    K]`` (binaural: the DECODED two-ear residual ``[2, T, K]``);
    ``idx/g3/val`` the arrival table (binaural: of the W channel, so
    the leading axis is 1); ``x3/y3`` the X/Y intensity windows at the
    tap bins (binaural only — they carry each tap's bearing)."""

    res: jax.Array            # [L, T, K] crossfade prev-side residual
    idx: jax.Array            # [Lw, A] int32 tap bins
    g3: jax.Array             # [Lw, A, 3, K] tap window gains
    val: jax.Array            # [Lw, A] bool
    x3: Optional[jax.Array] = None  # [Lw, A, 3, K] (binaural only)
    y3: Optional[jax.Array] = None  # [Lw, A, 3, K] (binaural only)


def init_arrival_carry(ir_length: int, n_listeners: int = 1,
                       n_bands: int = 1, n_taps: int = _ARRIVAL_TAPS,
                       binaural: bool = False) -> ArrivalCarry:
    """All-zero carry (``val`` all False): the next chunk's taps fade in
    fresh and its crossfade rises from silence — the first-chunk /
    post-``reset_ir`` state."""
    lw = 1 if binaural else n_listeners
    # distinct zero buffers per leaf: stream_chunk donates the state, and
    # donating one aliased buffer through several leaves is an error
    zt = lambda: jnp.zeros((lw, n_taps, 3, n_bands), jnp.float32)  # noqa
    return ArrivalCarry(
        res=jnp.zeros((n_listeners, ir_length, n_bands), jnp.float32),
        idx=jnp.zeros((lw, n_taps), jnp.int32),
        g3=zt(),
        val=jnp.zeros((lw, n_taps), bool),
        x3=zt() if binaural else None,
        y3=zt() if binaural else None)


class StreamState(NamedTuple):
    """Carried state of the streaming loop. The stream position is the
    ring's read head (both advance by exactly one chunk per step), which
    wraps mod ring size — no unbounded absolute offset to overflow.

    ``prev_facing`` exists only for binaural streams and ``arrival``
    only for per-arrival Doppler streams (``None`` otherwise — an empty
    pytree leaf, so other jits are untouched): the head facing the
    previous chunk was decoded with, and the previous chunk's
    :class:`ArrivalCarry` (tap table + crossfade residual — recomputing
    them from a carried raw capture, as rounds 4 did, paid a full extra
    binaural decode per composed chunk)."""

    prev_ir: jax.Array        # [L, T, K] previous chunk's normalized IR
    ring: RingBuffer
    chunk_index: jax.Array    # scalar int32
    prev_facing: Optional[jax.Array] = None   # scalar f32 (binaural only)
    arrival: Optional[ArrivalCarry] = None    # per-arrival Doppler only


def init_stream(ir_length: int, chunk_samples: int, n_listeners: int = 1,
                n_bands: int = 1, binaural: bool = False,
                arrival_taps: Optional[int] = None) -> StreamState:
    """Ring sized to hold a full chunk + reverb tail with slack — the
    reference sizes it ``(reverbDuration + 1) s`` (AudioManager.cs:30).
    ``binaural`` allocates the facing carry; ``arrival_taps`` the
    per-arrival Doppler carry (see :class:`StreamState`;
    :meth:`Streamer.process` allocates it lazily on the first
    per-arrival chunk, so plain streams never pay for it)."""
    size = ir_length + 2 * chunk_samples
    return StreamState(
        prev_ir=jnp.zeros((n_listeners, ir_length, n_bands), jnp.float32),
        ring=RingBuffer.zeros(size, n_listeners),
        chunk_index=jnp.zeros((), jnp.int32),
        prev_facing=(jnp.zeros((), jnp.float32) if binaural else None),
        arrival=(init_arrival_carry(ir_length, n_listeners, n_bands,
                                    arrival_taps, binaural)
                 if arrival_taps is not None else None))


def _crossfaded_wet(chunk: jax.Array, ir_prev: jax.Array, ir_cur: jax.Array
                    ) -> jax.Array:
    """Wet chunk [L, N+T]: convolve against both IRs (one input FFT, two
    transfer functions) and linearly crossfade prev->cur across the chunk;
    the reverb tail uses the current IR only."""
    chunk = cv.gate_input(chunk)
    n = chunk.shape[-1]
    t = ir_prev.shape[-2]
    out_length = n + t
    n_fft = cv._next_pow2(out_length)
    x = jnp.fft.rfft(chunk, n_fft)
    h = jnp.stack([cv.combined_transfer(ir_prev, n_fft),
                   cv.combined_transfer(ir_cur, n_fft)])       # [2, L, F]
    y = jnp.fft.irfft(x * h, n_fft)[..., :out_length]           # [2, L, O]
    ramp = jnp.minimum(
        jnp.arange(out_length, dtype=jnp.float32) / jnp.maximum(1, n), 1.0)
    return y[0] * (1.0 - ramp) + y[1] * ramp


def _augment_ir(cur_ir: jax.Array, scene: Scene, params: TraceParams,
                sample_rate: int, diffraction,
                air_alpha) -> jax.Array:
    """Optional physics addenda on a freshly traced chunk IR (all
    jit-safe): edge diffraction (shadow-zone fill — matters exactly when
    a moving pose slips behind an occluder; ``diffraction`` is falsy, 1,
    or 2 = edge-to-edge double diffraction) and ISO 9613-1 atmospheric
    absorption (``air_alpha`` = per-band dB/m, or None)."""
    if diffraction:
        from .ops.diffraction import diffraction_ir
        cur_ir = cur_ir + diffraction_ir(
            scene, params, sample_rate=sample_rate,
            ir_length=cur_ir.shape[-2], order=int(diffraction))
    if air_alpha is not None:
        from .ops.air import apply_air_absorption
        cur_ir = apply_air_absorption(cur_ir, sample_rate, air_alpha,
                                      params.speed_of_sound)
    return cur_ir


# ---- per-arrival Doppler (doppler="per_arrival") ---------------------------
#
# The shared-rate Doppler feed (DopplerFeed) warps the WHOLE dry stream at
# the direct path's rate — physically wrong for reflections, whose path
# lengths change at their own rates (a source approaching the listener
# but receding from the back wall pitch-shifts the direct sound UP and
# the echo DOWN). These helpers give each dominant early arrival its own
# glide: the top-A early peaks of the chunk IR become 3-bin taps (the
# peak bin and its two neighbors, carried with their individual gains,
# so tap + residual reproduce the full IR's convolution EXACTLY whatever
# the window holds — a two-bin scatter_hits splat, a capture-circle
# plateau, overlapping hits), matched mutual-nearest against the
# previous chunk's taps, and synthesized as time-varying fractional-
# delay reads of the dry history with the window delay and per-bin gains
# gliding linearly across the chunk — the delay glide IS the per-path
# Doppler. The tap bins are removed from both IRs so the residual (late
# field + unmatched transients) rides the ordinary crossfaded
# convolution; a diffuse late field has arrivals from every direction,
# so its net shift is ~zero and leaving it unwarped is the physically
# honest default.

def _window3(chan: jax.Array, idx: jax.Array) -> jax.Array:
    """3-bin windows ``[L, A, 3, K]`` of channel ``[L, T, K]`` at tap
    bins ``idx[L, A]``. Out-of-range neighbors are masked to 0 instead
    of letting the clip duplicate the edge bin (an idx=0 or idx=T-1 tap
    would otherwise synthesize more energy than :func:`_remove_taps`
    zeroes)."""
    li = jnp.arange(chan.shape[0])[:, None, None]
    raw = idx[:, :, None] + jnp.arange(-1, 2)[None, None, :]
    cols = jnp.clip(raw, 0, chan.shape[1] - 1)
    in_range = (raw >= 0) & (raw < chan.shape[1])
    return jnp.where(in_range[..., None], chan[li, cols], 0.0)


def _arrival_table(ir: jax.Array, early_bins: int, n_taps: int,
                   rel_floor: float = 1e-3):
    """Top-``n_taps`` early arrivals of an IR ``[L, T, K]``:
    ``(idx[L, A] int32, g3[L, A, 3, K], valid[L, A])``.

    A tap is a local maximum of the BAND-SUMMED energy in the first
    ``early_bins`` bins (all bands share one delay — an arrival is one
    path whatever its spectrum), carrying its per-band 3-bin window
    ``g3 = ir[idx-1 : idx+2, :]`` — exactly the bins
    :func:`_remove_taps` zeroes, so tap + residual reproduce the full
    IR's convolution EXACTLY whatever the window holds (a splat, a
    capture-circle plateau, overlapping hits). Taps within 2 bins of a
    stronger one are suppressed (their windows would overlap), and taps
    below ``rel_floor`` of the listener's strongest are dropped."""
    e = jnp.sum(ir, axis=-1)                             # [L, T]
    # neighbors from the FULL IR so the last window bin is compared
    # against its real right neighbor, not a zero pad (an arrival whose
    # peak sits just past the window must not spawn a rising-edge tap)
    left_e = jnp.pad(e, ((0, 0), (1, 0)))[:, :-1]
    right_e = jnp.pad(e, ((0, 0), (0, 1)))[:, 1:]
    w = e[:, :early_bins]
    left = left_e[:, :early_bins]
    right = right_e[:, :early_bins]
    ismax = (w >= left) & (w > right) & (w > 0)
    score = jnp.where(ismax, w + left + right, -1.0)
    val, idx = jax.lax.top_k(score, n_taps)             # [L, A]
    g3 = _window3(ir, idx)                              # [L, A, 3, K]
    gain = jnp.sum(g3, axis=(-1, -2))
    valid = (val > 0) & (gain > rel_floor
                         * jnp.max(gain, axis=1, keepdims=True))
    # suppress a tap within 2 bins of a stronger (or earlier-ranked
    # equal) one — their 3-bin windows would overlap and double-count
    d = jnp.abs(idx[:, :, None] - idx[:, None, :])
    rank = jnp.arange(n_taps)
    stronger = (gain[:, None, :] > gain[:, :, None]) | (
        (gain[:, None, :] == gain[:, :, None])
        & (rank[None, None, :] < rank[None, :, None]))
    clash = (d <= 2) & stronger & valid[:, None, :]
    valid = valid & ~jnp.any(clash, axis=2)
    return idx, g3, valid


def _match_arrivals(idx_c, valid_c, idx_p, g3_p, valid_p,
                    match_bins: float):
    """Mutual-nearest matching of this chunk's taps to the previous
    chunk's within ``match_bins``. Returns ``(tau0, g0[.., 3, K],
    matched_prev, j, mutual)``: per current tap the previous tap (delay
    + window gains) it glides from; an unmatched current tap fades in
    from gain 0 at its own delay (a new arrival). ``j[L, A]`` is the
    matched previous tap's index (meaningful where ``mutual``) so
    callers can gather extra per-tap fields (the binaural path gathers
    ear delays/gains). Previous taps nobody matched (vanished arrivals;
    ``~matched_prev``) are synthesized by the caller as FADING taps at
    their own delay — they cannot be left to the residual crossfade,
    whose convolution only reads this chunk's dry (the previous chunk
    pushed its tail without their bins), so dropping them would click
    at the boundary."""
    tau_c = idx_c.astype(jnp.float32)
    tau_p = idx_p.astype(jnp.float32)
    d = jnp.abs(tau_c[:, :, None] - tau_p[:, None, :])   # [L, A, A]
    d_cp = jnp.where(valid_p[:, None, :], d, jnp.inf)
    j = jnp.argmin(d_cp, axis=2)                         # cur -> prev
    best = jnp.min(d_cp, axis=2)
    d_pc = jnp.where(valid_c[:, :, None], d, jnp.inf)
    i_back = jnp.argmin(d_pc, axis=1)                    # prev -> cur
    li = jnp.arange(tau_c.shape[0])[:, None]
    a = tau_c.shape[1]
    mutual = ((i_back[li, j] == jnp.arange(a)[None, :])
              & (best <= match_bins) & valid_c)
    tau0 = jnp.where(mutual, tau_p[li, j], tau_c)
    g0 = jnp.where(mutual[..., None, None], g3_p[li, j], 0.0)
    matched_prev = jnp.zeros(tau_p.shape, jnp.int32
                             ).at[li, j].max(mutual.astype(jnp.int32))
    return tau0, g0, matched_prev.astype(bool), j, mutual


def _remove_taps(ir: jax.Array, idx: jax.Array, valid: jax.Array
                 ) -> jax.Array:
    """Zero the 3-bin windows of the given taps across all K bands of an
    IR ``[L, T, K]`` — the residual the crossfaded convolution handles.
    Works row-wise, so a spatial capture ``[3, T, K]`` is cleaned by
    tiling the one head's ``idx``/``valid`` across the 3 pattern rows."""
    li = jnp.arange(ir.shape[0])[:, None, None]
    cols = jnp.clip(idx[:, :, None] + jnp.arange(-1, 2)[None, None, :],
                    0, ir.shape[1] - 1)
    mask = jnp.ones(ir.shape[:2], ir.dtype).at[li, cols].min(
        jnp.where(valid[:, :, None], 0.0, 1.0))
    return ir * mask[..., None]


def _band_windows(window: jax.Array, k: int) -> jax.Array:
    """Split a mono dry-history window ``[Wd]`` into the ``[K, Wd]``
    band signals the banded tap reads need: a banded IR convolves each
    brickwall band of the dry against that band's IR
    (:func:`..ops.convolve.combined_transfer` semantics), so a banded
    tap with per-band gains must read band-filtered dry. Zero-padding
    to ``>= 2 Wd`` keeps the brickwall's circular wrap (the mask's sinc
    tail) out of the window. K == 1 passes the raw window through — the
    scalar path stays bit-identical to the pre-banded implementation."""
    if k == 1:
        return window[None, :]
    wd = window.shape[-1]
    n_fft = cv._next_pow2(2 * wd)
    x = jnp.fft.rfft(window, n_fft)
    masks = cv.band_filterbank(wd, k, n_fft)             # [K, F]
    return jnp.fft.irfft(x[None, :] * masks, n_fft)[:, :wd]


def _tap_chunk(dry_window: jax.Array, tau0, tau1, g0, g1, valid,
               n: int) -> jax.Array:
    """``[L, n]`` sum of time-varying 3-bin taps. ``dry_window`` is
    ``[Wd]`` mono or ``[K, Wd]`` band-split (:func:`_band_windows`),
    ending at the chunk end: its sample ``Wd - n + s`` is the chunk's
    output sample ``s``. Delays/gains come in three generality tiers,
    auto-promoted to the full ``[L, A, 3, K]`` form:

    * ``tau[L, A]`` + ``g[L, A, 3]`` — one gliding window delay per tap
      with per-bin gains at offsets (-1, 0, 1): the scalar per-path
      Doppler tap (K=1);
    * ``tau/g[L, A, 3, K]`` — fully general per-bin per-band delays and
      gains: the binaural ear taps (each window bin deposits at its own
      ITD-shifted position with its own ILD gain, per band).

    Everything glides linearly ``tau0 -> tau1`` / ``g0 -> g1`` across
    the chunk (matching the crossfade's prev->cur ramp); bin ``(a, d,
    k)`` reads band ``k`` of the window at position
    ``Wd - n + s - tau[a, d, k](s)`` with linear interpolation. With
    ``tau0 == tau1`` integer the reads are exact samples and the tap
    equals the removed bins' convolution bit-for-bit; a gliding delay
    advances ``1 - dtau/n`` dry samples per output sample — the
    per-path Doppler rate. Reads before the window (silence before the
    clip) are 0. The two-point reads are one gather per bin (XLA:GPU
    lowers it to parallel loads)."""
    dry_bands = dry_window[None, :] if dry_window.ndim == 1 else dry_window
    if tau0.ndim == 2:
        off = jnp.arange(-1, 2, dtype=jnp.float32)[None, None, :]
        tau0 = tau0[:, :, None] + off
        tau1 = tau1[:, :, None] + off
    if tau0.ndim == 3:
        tau0 = tau0[..., None]
        tau1 = tau1[..., None]
    if g0.ndim == 3:
        g0 = g0[..., None]
        g1 = g1[..., None]
    wd = dry_bands.shape[-1]
    k = dry_bands.shape[0]
    s = jnp.arange(n, dtype=jnp.float32)
    r = s / jnp.float32(max(1, n))
    tau = tau0[..., None] + (tau1 - tau0)[..., None] * r  # [L, A, 3, K, n]
    g = g0[..., None] + (g1 - g0)[..., None] * r          # [L, A, 3, K, n]
    p = (wd - n) + s - tau
    lo = jnp.floor(p)
    frac = p - lo
    lo_i = jnp.clip(lo.astype(jnp.int32), 0, wd - 1)
    hi_i = jnp.clip(lo_i + 1, 0, wd - 1)
    kk = jnp.arange(k)[None, None, None, :, None]
    y = dry_bands[kk, lo_i] * (1.0 - frac) + dry_bands[kk, hi_i] * frac
    y = jnp.where((p >= 0) & (p <= wd - 1), y, 0.0)
    return jnp.sum(jnp.where(valid[:, :, None, None, None], g * y, 0.0),
                   axis=(1, 2, 3))


def _first_chunk_select(is_first, cur, prev):
    """Per-leaf first-chunk selection: chunk 0 has no predecessor, so
    its "previous" products are its own (the fade-in-from-current-IR
    rule every stream mode shares)."""
    return jax.tree_util.tree_map(
        lambda c, p: jnp.where(is_first, c, p), cur, prev)


def _per_arrival_parts(dry_piece: jax.Array, dry_window: jax.Array,
                       carry: ArrivalCarry, cur_ir: jax.Array,
                       is_first, n: int, k: int,
                       n_taps: int = _ARRIVAL_TAPS,
                       match_bins: float = _ARRIVAL_MATCH_BINS):
    """The per-arrival step shared by :func:`stream_chunk` and the live
    pipeline's ``wet_chunk``: extract + match + synthesize the taps and
    convolve the residuals. Returns ``(wet[L, N+T], taps[L, n],
    new_carry)`` — ``wet`` is the crossfaded residual convolution,
    ``taps`` the per-path Doppler signal for THIS chunk's output
    samples, ``new_carry`` this chunk's table + residual for the next
    chunk (the previous chunk's products arrive in ``carry``; nothing
    is recomputed from the previous IR). Banded IRs (K > 1) share one
    delay glide per arrival with per-band window gains, read from
    band-split dry (:func:`_band_windows`)."""
    early_bins = dry_window.shape[-1] - n - 2
    idx_c, g3_c, val_c = _arrival_table(cur_ir, early_bins, n_taps)
    cur_res = _remove_taps(cur_ir, idx_c, val_c)
    new_carry = ArrivalCarry(cur_res, idx_c, g3_c, val_c)
    prev_res, idx_p, g3_p, val_p, _, _ = _first_chunk_select(
        is_first, new_carry, carry)
    tau0, g0, matched_prev, _, _ = _match_arrivals(
        idx_c, val_c, idx_p, g3_p, val_p, match_bins)
    # A vanished arrival (valid in prev, matched by no current tap) must
    # FADE OUT as a tap, not vanish: the previous chunk's convolution
    # tail was pushed WITHOUT its bins (they were that chunk's cur-side
    # taps), so leaving it to the residual crossfade — which only
    # convolves THIS chunk's dry — would drop its dry-history tail and
    # click at the boundary. A gain ramp g3_p -> 0 at its own delay is
    # the crossfade's (1 - r) weight, reading the right history. The
    # fade-outs ride the SAME _tap_chunk call as the current taps
    # (concatenated along the tap axis).
    tau_p = idx_p.astype(jnp.float32)
    vanished = val_p & ~matched_prev
    cat = lambda a, b: jnp.concatenate([a, b], axis=1)   # noqa: E731
    taps = _tap_chunk(_band_windows(cv.gate_input(dry_window), k),
                      cat(tau0, tau_p),
                      cat(idx_c.astype(jnp.float32), tau_p),
                      cat(g0, g3_p),
                      cat(g3_c, jnp.zeros_like(g3_p)),
                      cat(val_c, vanished), n)
    return (_crossfaded_wet(dry_piece, prev_res, cur_res), taps,
            new_carry)


def _ear_fields(w3, x3, y3, idx, facing, sign, sample_rate: int,
                head_radius: float, shadow: float, speed_of_sound,
                n_t: int, decorr: bool):
    """Per-ear DirAC decode of one tap table's window bins — EXACTLY the
    per-bin semantics of :meth:`..spatial.SpatialIR.binaural`, applied
    to the 3-bin windows ``w3/x3/y3 [L, A, 3, K]`` at bins ``idx[L, A]``
    (``sign`` = +1 left ear, -1 right). Each window bin's energy splits
    into a coherent part ``min(|XY|, W)`` deposited at the ITD-shifted
    position ``clip(b - sign * max_shift * sin(phi))`` with the
    head-shadow ILD gain, and a diffuse remainder at the unshifted bin
    through the ear's Rademacher decorrelator. Returns ``(tau_coh,
    g_coh, tau_dif, g_dif)``, each ``[L, A, 3, K]`` — tap parameters
    whose synthesis reproduces the removed bins' ear deposits exactly
    (the tap's linear-interpolated read IS the decode's fractional
    two-bin splat, through the convolution)."""
    from .spatial import _ear_signs
    r = jnp.sqrt(x3 * x3 + y3 * y3)
    coh = jnp.minimum(r, w3)
    dif = w3 - coh
    phi = jnp.arctan2(y3, x3) - facing
    s = jnp.sin(phi)
    raw = idx[:, :, None] + jnp.arange(-1, 2)[None, None, :]  # [L, A, 3]
    bins = raw.astype(jnp.float32)[..., None]                 # [L, A, 3, 1]
    max_shift = head_radius / speed_of_sound * sample_rate
    tau_coh = jnp.clip(bins - sign * max_shift * s, 0.0, float(n_t - 1))
    g_coh = coh * (1.0 + sign * shadow * s)
    tau_dif = jnp.broadcast_to(jnp.clip(bins, 0.0, float(n_t - 1)),
                               g_coh.shape)
    if decorr:
        signs = jnp.asarray(_ear_signs(n_t, ear_seed=0 if sign > 0 else 1))
        g_dif = dif * signs[jnp.clip(raw, 0, n_t - 1)][..., None]
    else:
        g_dif = dif
    return tau_coh, g_coh, tau_dif, g_dif


def _per_arrival_binaural(dry_piece: jax.Array, dry_window: jax.Array,
                          carry: ArrivalCarry, cur_sp: jax.Array,
                          prev_facing, cur_facing, is_first, n: int,
                          sample_rate: int, head_radius: float,
                          shadow: float, speed_of_sound,
                          decorrelate: bool,
                          n_taps: int = _ARRIVAL_TAPS,
                          match_bins: float = _ARRIVAL_MATCH_BINS):
    """Binaural per-arrival Doppler: unify the per-path pitch glides
    with the two-ear decode. Taps are extracted from the spatial
    capture's W channel ``[3, T, K] -> w`` and matched chunk-to-chunk
    exactly like the scalar path; each path tap then becomes FOUR ear
    taps (2 ears x coherent/diffuse) whose per-bin delays carry the
    path Doppler glide PLUS the ear's ITD offset read from X/Y at the
    tap bins (``-+ r sin(phi) / c``, the :meth:`..spatial.SpatialIR.
    binaural` model) and whose gains carry the ILD
    (``1 +- shadow sin(phi)``); the diffuse remainder of each tap bin
    rides its ear's Rademacher decorrelator sign at the unshifted
    delay. The residual spatial IR (tap bins zeroed across all three
    pattern rows) goes through the ordinary binaural decode — the
    decorrelated diffuse late field is untouched — and the crossfaded
    convolution. Returns ``(wet[2, N+T], taps[2, n], new_carry)``.

    The previous chunk's side arrives entirely in ``carry`` (its W
    table, X/Y bearing windows, and DECODED two-ear residual — all
    computed when that chunk was current), so the only full-IR work
    per chunk is the current capture's: one table, one removal, one
    binaural decode. Rounds 4 recomputed all three from a carried raw
    ``[3, T, K]`` capture — a second decode's four scatter-adds every
    chunk.

    With a static scene and facing, prev == cur tap fields and the
    synthesis reproduces the plain binaural stream's removed deposits
    exactly (FFT-vs-direct float noise aside): the two flagship modes
    compose instead of excluding each other."""
    from . import spatial as spm
    k = cur_sp.shape[-1]
    n_t = cur_sp.shape[-2]
    # the far ear's ITD shift ADDS to a tap's delay, but the dry-history
    # window only has 2 bins of slack past the tap window — a tap within
    # max_shift of the window end would read before the window and mute
    # its first samples every chunk. Shrink the EXTRACTION window by a
    # static ITD pad (c >= 100 m/s floor; speed_of_sound is traced)
    # instead of widening the window: arrivals in the last pad bins stay
    # in the residual convolution, which renders any delay exactly —
    # no energy is lost, they just don't glide.
    itd_pad = int(np.ceil(head_radius * sample_rate / 100.0))
    early_bins = max(1, dry_window.shape[-1] - n - 2 - itd_pad)
    sp_c = spm.spatial_from_ir(cur_sp)
    idx_c, g3_c, val_c = _arrival_table(sp_c.w, early_bins, n_taps)
    x3_c = _window3(sp_c.x, idx_c)
    y3_c = _window3(sp_c.y, idx_c)
    rem_c = _remove_taps(cur_sp, jnp.tile(idx_c, (3, 1)),
                         jnp.tile(val_c, (3, 1)))
    res_c = spm.binaural_decode_ir(rem_c, sample_rate, cur_facing,
                                   head_radius, shadow, speed_of_sound,
                                   decorrelate=decorrelate)
    new_carry = ArrivalCarry(res_c, idx_c, g3_c, val_c, x3_c, y3_c)
    res_p, idx_p, g3_p, val_p, x3_p, y3_p = _first_chunk_select(
        is_first, new_carry, carry)
    _, _, matched_prev, j, mutual = _match_arrivals(
        idx_c, val_c, idx_p, g3_p, val_p, match_bins)
    vanished = val_p & ~matched_prev
    decorr = decorrelate and not (head_radius == 0.0 and shadow == 0.0)
    li = jnp.arange(idx_c.shape[0])[:, None]
    mu = mutual[:, :, None, None]
    ear_tau0, ear_tau1, ear_g0, ear_g1 = [], [], [], []
    for sign in (1.0, -1.0):
        tc_c, gc_c, td_c, gd_c = _ear_fields(
            g3_c, x3_c, y3_c, idx_c, cur_facing, sign, sample_rate,
            head_radius, shadow, speed_of_sound, n_t, decorr)
        tc_p, gc_p, td_p, gd_p = _ear_fields(
            g3_p, x3_p, y3_p, idx_p, prev_facing, sign, sample_rate,
            head_radius, shadow, speed_of_sound, n_t, decorr)
        take = lambda a: a[li, j]                        # noqa: E731
        # rows: [cur coherent, cur diffuse, fade-out coherent/diffuse]
        ear_tau0.append(jnp.concatenate(
            [jnp.where(mu, take(tc_p), tc_c),
             jnp.where(mu, take(td_p), td_c), tc_p, td_p], axis=1))
        ear_tau1.append(jnp.concatenate([tc_c, td_c, tc_p, td_p], axis=1))
        ear_g0.append(jnp.concatenate(
            [jnp.where(mu, take(gc_p), 0.0),
             jnp.where(mu, take(gd_p), 0.0), gc_p, gd_p], axis=1))
        ear_g1.append(jnp.concatenate(
            [gc_c, gd_c, jnp.zeros_like(gc_p), jnp.zeros_like(gd_p)],
            axis=1))
    rows_valid = jnp.concatenate([val_c, val_c, vanished, vanished],
                                 axis=1)                 # [1, 4A]
    taps = _tap_chunk(_band_windows(cv.gate_input(dry_window), k),
                      jnp.concatenate(ear_tau0, axis=0),
                      jnp.concatenate(ear_tau1, axis=0),
                      jnp.concatenate(ear_g0, axis=0),
                      jnp.concatenate(ear_g1, axis=0),
                      jnp.concatenate([rows_valid, rows_valid], axis=0),
                      n)                                 # [2, n]
    return (_crossfaded_wet(dry_piece, res_p, res_c), taps,
            new_carry)


def _device_window(dry: jax.Array, wd: int, win_start, win_prefix,
                   win_cut, loop: bool) -> jax.Array:
    """The jit-side dry-history window: ``wd`` samples of the
    device-resident clip ending at the current chunk's end, assembled
    from three TRACED scalars (so per-chunk motion recompiles nothing
    and the host ships no per-chunk index arrays — the round-4 path
    rebuilt an ~8k-sample window on host every chunk, ~1 ms of
    dispatch). ``win_start`` = the window's first clip position (loop:
    pre-wrapped mod total; non-loop: clamped to [-wd, total]),
    ``win_prefix`` = leading samples that are pre-stream silence,
    ``win_cut`` = samples valid from the window start (< wd only after
    a mid-stream stop: post-stop dry is silence). Host-side scalar
    arithmetic stays in Python ints, so nothing overflows int32 however
    long the stream runs (see :func:`window_scalars`)."""
    total = dry.shape[-1]
    pos = jnp.arange(wd)
    ok = (pos >= win_prefix) & (pos < win_cut)
    if loop:
        idx = (win_start + pos) % total
    else:
        g = win_start + pos
        ok = ok & (g >= 0) & (g < total)
        idx = jnp.clip(g, 0, total - 1)
    return jnp.where(ok, dry[..., idx], 0.0)


def window_scalars(i: int, n: int, wd: int, total: int, loop: bool,
                   stop_at: Optional[int] = None):
    """Host-side (exact Python int) scalars for :func:`_device_window`:
    ``(win_start, win_prefix, win_cut)`` for chunk ``i``'s history
    window. ``stop_at`` (absolute dry sample of a mid-stream stop)
    silences everything from that point — arrivals in flight keep
    reading real history before it, so the stop flushes cleanly instead
    of clicking."""
    end = (i + 1) * n
    start = end - wd
    if loop:
        win_start = start % total
        win_prefix = max(0, -start)
    else:
        win_start = max(-wd, min(start, total))
        win_prefix = 0
    win_cut = wd if stop_at is None else max(0, min(wd, stop_at - start))
    return win_start, win_prefix, win_cut


def dry_history_window(dry: jax.Array, i: int, n: int, early_bins: int,
                       loop: bool) -> jax.Array:
    """The ``early_bins + 2 + n`` dry samples ending at chunk ``i``'s
    end — the read window for :func:`_tap_chunk` (+2 slack for the
    centroid's ±1 bin and the interpolation's +1 sample). Positions
    before the clip are silence; ``loop`` wraps them modulo the clip,
    exactly like :func:`dry_chunk`."""
    wd = n + early_bins + 2
    end = (i + 1) * n
    total = dry.shape[-1]
    # positions in host Python ints (arbitrary precision), bounded into
    # [0, total) BEFORE they become device indices — a device arange
    # from (i+1)*n would overflow int32 ~13.5 h into a 44.1 kHz stream
    pos = np.arange(end - wd, end, dtype=np.int64)
    if loop:
        # the loop wrap only ever applies at the clip END (dry_chunk
        # semantics) — history BEFORE the stream started is silence,
        # not the tail of a clip that has not played yet
        idx = jnp.asarray((pos % total).astype(np.int32))
        return jnp.where(jnp.asarray(pos >= 0), dry[..., idx], 0.0)
    ok = (pos >= 0) & (pos < total)
    idx = jnp.asarray(np.clip(pos, 0, total - 1).astype(np.int32))
    return jnp.where(jnp.asarray(ok), dry[..., idx], 0.0)


@partial(jax.jit, static_argnames=("n_rays", "max_bounces", "sample_rate",
                                   "frames_per_chunk", "diffraction",
                                   "head_radius", "shadow",
                                   "decorrelate", "arrival_early",
                                   "arrival_taps", "arrival_match_bins",
                                   "window_loop"),
         donate_argnames=("state",))
def stream_chunk(scene: Scene, params: TraceParams, state: StreamState,
                 dry_chunk: jax.Array, key: jax.Array, *,
                 n_rays: int, max_bounces: int, sample_rate: int,
                 frames_per_chunk: int = 1, diffraction: bool = False,
                 air_alpha=None, binaural_facing=None,
                 head_radius: float = 0.0875,
                 shadow: float = 0.6,
                 decorrelate: bool = True,
                 dry_full=None, win_start=None, win_prefix=None,
                 win_cut=None, arrival_early: int = 0,
                 arrival_taps: int = _ARRIVAL_TAPS,
                 arrival_match_bins: float = _ARRIVAL_MATCH_BINS,
                 window_loop: bool = False
                 ) -> Tuple[jax.Array, StreamState]:
    """One streaming step: retrace -> crossfaded convolution -> overlap-add
    -> drain. Returns ``(out_chunk[L, N], new_state)``. Fully on-device;
    ``state`` buffers are donated so the 60 Hz loop allocates nothing.

    ``binaural_facing`` (a TRACED radians scalar — per-chunk head
    rotation recompiles nothing) switches the step to binaural: ``params``
    must carry ONE listener (the head) and ``state`` TWO channels (the
    ears); the chunk traces the 3-virtual-mic spatial capture and decodes
    it per chunk (:meth:`..spatial.SpatialIR.binaural`) before the
    crossfaded convolution — a moving/rotating head pans smoothly.

    ``dry_full`` (the device-resident dry clip) switches on per-arrival
    Doppler: the chunk's dry-history window is sliced ON DEVICE from the
    traced scalars ``win_start``/``win_prefix``/``win_cut``
    (:func:`window_scalars`; ``arrival_early`` early bins, static), the
    dominant early arrivals leave the convolution and become per-path
    Doppler taps, and the residual IRs ride the ordinary crossfade.
    Composes with ``binaural_facing`` (taps from the W channel, per-tap
    bearings from X/Y driving per-ear ITD/ILD glides —
    :func:`_per_arrival_binaural`)."""
    n = dry_chunk.shape[-1]
    l, t, k = state.prev_ir.shape
    per_arrival = dry_full is not None
    binaural = binaural_facing is not None

    # 1. retrace: fresh IR for this chunk (accumulate-then-reset cycle,
    #    RayTraceManager.cs:82-85) through engine.trace_accumulate.
    from . import spatial as spm
    from .engine import trace_accumulate
    tp = spm.binaural_trace_params(params, l) if binaural else params
    t_l = tp.listeners.shape[0]
    chunk_key = _rng.frame_key(key, state.chunk_index)
    ir_state = trace_accumulate(
        scene, tp, irm.IRState.zeros(t, t_l, k), chunk_key,
        n_rays=n_rays, max_bounces=max_bounces, sample_rate=sample_rate,
        n_frames=frames_per_chunk)
    cur_ir = _augment_ir(ir_state.normalized(), scene, tp,
                         sample_rate, diffraction, air_alpha)  # [L, T, K]
    cur_sp = None
    if binaural:
        cur_sp = cur_ir                                  # [3, T, K] capture
        cur_ir = spm.binaural_decode_ir(
            cur_sp, sample_rate, binaural_facing, head_radius, shadow,
            params.speed_of_sound,
            decorrelate=decorrelate)             # [2, T, K]

    # First chunk has no predecessor: fade in from the current IR itself.
    is_first = state.chunk_index == 0
    prev_ir = jnp.where(is_first, cur_ir, state.prev_ir)

    # 2. convolve + crossfade (per-arrival: taps leave the convolution).
    taps = None
    new_carry = state.arrival
    if per_arrival:
        if state.arrival is None:
            raise ValueError("per-arrival Doppler needs the arrival "
                             "carry: init_stream(..., arrival_taps=A) "
                             "(Streamer.process allocates it lazily)")
        wd = n + arrival_early + 2
        window = _device_window(dry_full, wd, win_start, win_prefix,
                                win_cut, window_loop)
        if binaural:
            if state.prev_facing is None:
                raise ValueError("binaural per-arrival Doppler needs the "
                                 "facing carry: init_stream(..., "
                                 "binaural=True)")
            prev_fac = jnp.where(is_first, binaural_facing,
                                 state.prev_facing)
            wet, taps, new_carry = _per_arrival_binaural(
                dry_chunk, window, state.arrival, cur_sp, prev_fac,
                binaural_facing, is_first, n, sample_rate, head_radius,
                shadow, params.speed_of_sound, decorrelate,
                arrival_taps, arrival_match_bins)
        else:
            wet, taps, new_carry = _per_arrival_parts(
                dry_chunk, window, state.arrival, cur_ir, is_first, n, k,
                arrival_taps, arrival_match_bins)
    else:
        wet = _crossfaded_wet(dry_chunk, prev_ir, cur_ir)       # [L, N+T]

    # 3. overlap-add into the ring at the stream position (== the read
    #    head: both advance one chunk per step), then drain one chunk
    ring = state.ring.push(wet, state.ring.read_head)
    out, ring = ring.drain(n)
    if taps is not None:
        out = out + taps

    new_state = StreamState(
        prev_ir=cur_ir, ring=ring, chunk_index=state.chunk_index + 1,
        prev_facing=(binaural_facing
                     if (binaural and state.prev_facing is not None)
                     else state.prev_facing),
        arrival=new_carry)
    return out, new_state


class Streamer:
    """Host-side driver for the streaming loop — the ergonomic equivalent
    of Space-to-stream (``RayTraceManager.StartStreaming``,
    RayTraceManager.cs:125-133). Poses may change every chunk (moving
    listener, BASELINE.json config #3)."""

    def __init__(self, scene: Scene, config: EngineConfig, key: jax.Array,
                 n_listeners: int = 1, frames_per_chunk: int = 1,
                 diffraction: bool = False, air_alpha=None,
                 binaural: bool = False, head_radius: float = 0.0875,
                 shadow: float = 0.6, decorrelate: bool = True,
                 arrival_taps: int = _ARRIVAL_TAPS,
                 arrival_window_s: float = _ARRIVAL_WINDOW_S,
                 arrival_match_bins: float = _ARRIVAL_MATCH_BINS):
        if binaural and n_listeners != 1:
            raise ValueError("binaural streaming takes one head listener")
        if arrival_taps < 1:
            raise ValueError("arrival_taps must be >= 1")
        self.scene = scene
        self.config = config
        self.key = key
        self.frames_per_chunk = frames_per_chunk
        self.n_listeners = 2 if binaural else n_listeners
        self.diffraction = diffraction
        self.air_alpha = air_alpha
        self.binaural = binaural
        self.head_radius = head_radius
        self.shadow = shadow
        self.decorrelate = decorrelate
        self.arrival_taps = int(arrival_taps)
        self.arrival_match_bins = float(arrival_match_bins)
        # early window the taps may live in (bins; static per stream)
        self.arrival_early = min(
            config.audio.ir_length,
            int(round(arrival_window_s * config.audio.sample_rate)))
        self.state = init_stream(config.audio.ir_length,
                                 config.audio.chunk_samples,
                                 self.n_listeners, scene.n_bands,
                                 binaural=binaural)

    def reset_ir(self) -> None:
        """The reference's R key (``RayTraceManager.cs:58-61`` ->
        ``ClearImpulse``) mid-stream: drop the IR memory — the
        crossfade's previous IR and the per-arrival carry — so the
        next chunk fades in from silence and the room re-blooms from the
        fresh trace. Audio already pushed into the ring keeps playing,
        exactly like the reference (ClearImpulse zeroes the impulse
        texture; the AudioManager ring is untouched)."""
        s = self.state
        self.state = s._replace(
            prev_ir=jnp.zeros_like(s.prev_ir),
            arrival=(jax.tree_util.tree_map(jnp.zeros_like, s.arrival)
                     if s.arrival is not None else None))

    def process(self, dry_chunk: jax.Array, params: TraceParams,
                scene: Optional[Scene] = None,
                facing: float = 0.0, window=None) -> jax.Array:
        """One chunk. ``scene`` overrides the bound scene for this chunk —
        the dynamic-obstacles mode (the reference re-flattens colliders
        every FixedUpdate when ``dynamicObstacles`` is set,
        RayTraceManager.cs:67); as long as the padded wall count is
        unchanged there is no recompile. ``facing`` (radians; traced, so
        rotating the head per chunk recompiles nothing) steers the
        binaural decode when the streamer is binaural. ``window``
        (per-arrival Doppler) is ``(dry_full, win_start, win_prefix,
        win_cut, loop)`` — the device-resident clip plus the traced
        history-window scalars from :func:`window_scalars`."""
        dry_full = win_start = win_prefix = win_cut = None
        window_loop = False
        if window is not None:
            dry_full, win_start, win_prefix, win_cut, window_loop = window
            if self.state.arrival is None:
                # allocate the per-arrival carry on the first per-arrival
                # chunk (plain streams never carry it; the one pytree-
                # structure change happens before the first compile)
                self.state = self.state._replace(arrival=init_arrival_carry(
                    self.config.audio.ir_length, self.n_listeners,
                    self.scene.n_bands, self.arrival_taps, self.binaural))
        out, self.state = stream_chunk(
            scene if scene is not None else self.scene, params, self.state,
            dry_chunk, self.key,
            n_rays=self.config.sim.ray_count,
            max_bounces=self.config.sim.max_bounces,
            sample_rate=self.config.audio.sample_rate,
            frames_per_chunk=self.frames_per_chunk,
            diffraction=self.diffraction, air_alpha=self.air_alpha,
            binaural_facing=(jnp.asarray(facing, jnp.float32)
                             if self.binaural else None),
            head_radius=self.head_radius, shadow=self.shadow,
            decorrelate=self.decorrelate, dry_full=dry_full,
            win_start=win_start, win_prefix=win_prefix, win_cut=win_cut,
            arrival_early=(self.arrival_early if window is not None else 0),
            arrival_taps=self.arrival_taps,
            arrival_match_bins=self.arrival_match_bins,
            window_loop=window_loop)
        return out

    def stream_clip(self, dry: jax.Array, params_fn, scene_fn=None,
                    pad_tail: bool = True, loop: Optional[bool] = None,
                    total_chunks: Optional[int] = None,
                    on_chunk=None, facing_fn=None, doppler=False,
                    control_fn=None):
        """Stream a whole clip; ``params_fn(chunk_index) -> TraceParams``
        supplies (possibly moving) poses and optional
        ``scene_fn(chunk_index) -> Scene`` supplies per-chunk geometry
        (dynamic obstacles). Returns wet audio [L, total].

        ``on_chunk(i, state)`` (optional) is called after every processed
        chunk with the post-chunk :class:`StreamState` — the hook behind
        the CLI's ``--viz-every`` live IR rasters, mirroring the
        reference's per-frame ``DrawIR`` blit while audio streams
        (RayTraceManager.cs:252-258).

        ``doppler=True`` adds the physical pitch shift of a moving pose:
        the dry feed becomes a fractional-rate resampler
        (:func:`warp_chunk`) advancing ``1 - v/c`` dry samples per output
        sample, where ``v`` is the radial velocity of the (first)
        source toward the (first) listener derived from consecutive
        ``params_fn`` poses. The traced IR keeps handling level/reverb;
        the reference (and a plain stream) is Doppler-free because chunk
        convolution is time-invariant within a chunk. All paths share
        the direct-path rate (the standard real-time approximation).
        Rates come from consecutive-pose differences, so the LAST chunk
        reuses the previous chunk's rate (no pose to difference
        against), and a single-chunk stream (``n_steps == 1``) has no
        pose pair at all — it streams at rate 1.0, i.e. no pitch shift.

        ``doppler="per_arrival"`` upgrades that approximation: the
        dominant early arrivals of each chunk's traced IR become
        per-path fractional-delay taps whose delays glide chunk to
        chunk, so the direct sound and each early reflection carry
        their OWN Doppler rates (a source approaching you but receding
        from the back wall shifts the direct sound up and the echo
        down); the late field stays in the crossfaded convolution,
        unwarped — diffuse arrivals come from every direction, so their
        net shift is ~zero. Needs no pose lookahead (rates come from
        the IRs themselves, so this mode also hears geometry-driven
        delay changes a pose difference cannot see, e.g. a moving
        obstacle). K == 1, non-binaural streams only.

        ``loop`` selects the end-of-clip behavior of the reference
        (``RayTraceManager.cs:74-77``): when set, the dry feed restarts at
        the clip head and streaming continues for ``total_chunks`` chunks
        (which must be given — a looped stream has no natural end); when
        clear, the clip plays once and the reverb tail is flushed
        (``pad_tail``). ``loop=None`` honors ``config.audio.loop`` for
        timed streams (``total_chunks`` given) and plays once otherwise —
        a bare ``stream_clip(dry)`` is always a finite single pass.

        ``control_fn(i) -> dict`` (optional) carries the reference's
        runtime control verbs (``RayTraceManager.cs:55-61``): a truthy
        ``"reset_ir"`` applies :meth:`reset_ir` before chunk ``i`` (the
        R key); a truthy ``"stop"`` silences the dry feed from chunk
        ``i`` and flushes the reverb tail for ``ir_length`` worth of
        chunks, then ends the stream early (the Space key) — the output
        is correspondingly shorter."""
        n = self.config.audio.chunk_samples
        total = dry.shape[-1]
        if loop is None:
            loop = self.config.audio.loop and total_chunks is not None
        if loop:
            if total_chunks is None:
                raise ValueError(
                    "loop=True streams forever; pass total_chunks")
            n_steps = total_chunks
        else:
            n_chunks = (total + n - 1) // n
            tail = (self.config.audio.ir_length + n - 1) // n if pad_tail \
                else 0
            n_steps = (n_chunks + tail) if total_chunks is None \
                else total_chunks
        per_arrival = doppler == "per_arrival"
        feed = DopplerFeed(dry, params_fn, n, self.config.audio.sample_rate,
                           n_steps, loop) if (doppler and not per_arrival) \
            else None
        wd = n + self.arrival_early + 2
        tail_chunks = (self.config.audio.ir_length + n - 1) // n
        chunks = []
        stop_at = None
        i, end_step = 0, n_steps
        while i < end_step:
            if control_fn is not None:
                ctrl = control_fn(i) or {}
                if ctrl.get("reset_ir"):
                    self.reset_ir()
                if ctrl.get("stop") and stop_at is None:
                    # Space: dry feed ends NOW; keep stepping only long
                    # enough to flush the ring's reverb tail.
                    stop_at = i * n
                    end_step = min(end_step, i + tail_chunks)
            if stop_at is not None:
                piece = jnp.zeros((n,), jnp.float32)
            else:
                piece = (feed.chunk(i) if feed is not None
                         else dry_chunk(dry, i, n, loop))
            window = ((dry,) + window_scalars(i, n, wd, total, loop,
                                              stop_at) + (loop,)) \
                if per_arrival else None
            scene_i = scene_fn(i) if scene_fn is not None else None
            facing = facing_fn(i) if facing_fn is not None else 0.0
            chunks.append(self.process(piece, params_fn(i), scene_i,
                                       facing=facing, window=window))
            if on_chunk is not None:
                on_chunk(i, self.state)
            i += 1
        return jnp.concatenate(chunks, axis=-1)


@partial(jax.jit, static_argnames=("n", "loop"))
def warp_chunk(dry: jax.Array, base: jax.Array, frac0: jax.Array,
               rate: jax.Array, n: int, loop: bool = False) -> jax.Array:
    """Read ``n`` output samples from the dry clip starting at the
    fractional position ``base + frac0`` (``base`` int32 whole samples,
    ``frac0`` float32 in [0, 1)), advancing ``rate`` dry samples per
    output sample (linear interpolation) — the Doppler dry feed.

    A pose moving at radial velocity ``v`` (positive = receding)
    time-warps the received signal ``y(t) = x(t (1 - v/c) - d0/c)``:
    the constant delay ``d0/c`` lives in the traced IR's direct-path
    bin, the rate ``1 - v/c`` lives here. The split base/frac position
    keeps every traced float small (``frac0 + rate * n`` < one chunk):
    a single f32 absolute position would quantize past ~2^23 samples
    (~190 s at 44.1 kHz) into sample-and-hold steps — the host carries
    the absolute position in float64 (:class:`DopplerFeed`) and hands
    over its exact integer/fraction split. ``loop`` wraps the read
    modulo the clip; otherwise reads past the end produce silence
    (tail flush)."""
    total = dry.shape[-1]
    idx = frac0 + rate * jnp.arange(n, dtype=jnp.float32)
    lo = jnp.floor(idx)
    frac = idx - lo
    lo_i = base + lo.astype(jnp.int32)
    if loop:
        a = dry[..., lo_i % total]
        b = dry[..., (lo_i + 1) % total]
    else:
        valid = (lo_i >= 0) & (lo_i < total)
        valid_b = (lo_i + 1 >= 0) & (lo_i + 1 < total)
        a = jnp.where(valid, dry[..., jnp.clip(lo_i, 0, total - 1)], 0.0)
        b = jnp.where(valid_b, dry[..., jnp.clip(lo_i + 1, 0, total - 1)],
                      0.0)
    return a * (1.0 - frac) + b * frac


class DopplerFeed:
    """Host-side Doppler dry feed — the one rate derivation shared by
    :meth:`Streamer.stream_clip` and :class:`..live.LivePlayer` so the
    two pipelines agree on physics sample-for-sample.

    Per chunk ``i`` the radial velocity of the (first) source toward the
    (first) listener comes from consecutive ``params_fn`` poses:
    ``rate = 1 - (d(i+1) - d(i)) * sr / (n * c)`` dry samples per output
    sample (the final chunk reuses the last rate — ``params_fn``'s
    domain is ``[0, n_steps)``; with ``n_steps == 1`` there is no pose
    pair at all, so a single-chunk Doppler stream plays unshifted). The
    absolute read position accumulates in float64 and is handed to the
    jitted :func:`warp_chunk` as an exact int32 + f32-fraction split.
    """

    def __init__(self, dry: jax.Array, params_fn, n: int, sample_rate: int,
                 n_steps: int, loop: bool):
        self.dry = dry
        self.params_fn = params_fn
        self.n = n
        self.sample_rate = sample_rate
        self.n_steps = n_steps
        self.loop = loop
        self.total = dry.shape[-1]
        self.pos = 0.0            # float64 absolute dry read position
        self.rate = 1.0
        self._d_prev = self._pose_distance(0)

    def _pose_distance(self, i: int) -> float:
        p = self.params_fn(i)
        src = np.asarray(p.source, np.float32).reshape(-1, 2)[0]
        lis = np.asarray(p.listeners, np.float32).reshape(-1, 2)[0]
        return float(np.hypot(*(src - lis)))

    def chunk(self, i: int) -> jax.Array:
        """The ``n`` warped dry samples of chunk ``i`` (call in order)."""
        if i + 1 < self.n_steps:
            c = float(np.asarray(self.params_fn(i).speed_of_sound))
            d_next = self._pose_distance(i + 1)
            self.rate = 1.0 - ((d_next - self._d_prev) * self.sample_rate
                               / (self.n * c))
            self._d_prev = d_next
        pos = self.pos
        if self.loop:
            pos %= float(self.total)
        else:
            # Past-the-end reads are silence regardless of how far past;
            # cap so the int32 base can't overflow on endless streams.
            pos = min(pos, float(self.total) + 1.0)
        base = math.floor(pos)
        piece = warp_chunk(self.dry, jnp.asarray(base, jnp.int32),
                           jnp.asarray(pos - base, jnp.float32),
                           jnp.asarray(self.rate, jnp.float32),
                           self.n, loop=self.loop)
        self.pos += self.rate * self.n
        if self.loop:
            self.pos %= float(self.total)
        return piece


def dry_chunk(dry: jax.Array, i: int, n: int, loop: bool) -> jax.Array:
    """Chunk ``i`` of the dry feed. Looping wraps the clip modulo its
    length — the seam chunk is tail-of-clip + head-of-clip, exactly the
    reference's ``sampleOffset`` reset (RayTraceManager.cs:74-77); without
    loop the post-clip feed is silence (tail flush)."""
    total = dry.shape[-1]
    lo = i * n
    if loop:
        # wrap the unbounded host offset BEFORE the device arange (int32
        # would overflow ~13.5 h into a 44.1 kHz stream)
        idx = ((lo % total) + jnp.arange(n)) % total
        return dry[..., idx]
    piece = dry[..., lo:lo + n] if lo < total else dry[..., :0]
    if piece.shape[-1] < n:
        pad = [(0, 0)] * (piece.ndim - 1) + [(0, n - piece.shape[-1])]
        piece = jnp.pad(piece, pad)
    return piece
