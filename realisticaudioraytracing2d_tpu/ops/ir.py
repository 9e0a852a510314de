"""Impulse-response construction and accumulation.

Replaces the reference's ``ProcessHits`` / ``ClearImpulse`` kernels
(``Assets/Script/Raytrace2D.compute:157-172``): each hit deposits its energy
into IR bin ``floor(timeDelay * SampleRate)``. The reference does this with
a **non-atomic** ``+=`` across GPU threads — racy, so updates are lost
(SURVEY.md section 5); here it's an XLA scatter-add, which loses none. On
the CPU its summation order is fixed and reruns are bit-equal (a
regression test asserts it). On the GPU, XLA lowers a float scatter-add
to atomics whose order varies, so reruns agree to float rounding but not
bit for bit (the README's "Determinism" has the H100 figure).

The banded path generalizes the legacy time x frequency IR
(``RaytraceOcclusion2D.compute:234-252``): energies already arrive per-band
from the banded trace, so the IR is simply ``[T, K]``; the legacy global
``exp(-muffle * freq * scale / W)`` attenuation is also provided verbatim
for parity (:func:`muffle_band_energies`).

Cross-frame Monte-Carlo averaging is explicit state: :class:`IRState` holds
``(sum, frames)`` — the functional form of the reference's mutable
``ImpulseResponse`` buffer plus ``accumFrames`` counter
(``RayTraceManager.cs:233``). Normalization by frame count happens at use
time, exactly like ``AudioConvolve.compute:30``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .trace import Hits


class IRState(NamedTuple):
    """Accumulated impulse response: running energy sum + frame count.

    ``sum`` has shape [L, T, K] (listeners, time bins, bands).
    """

    sum: jax.Array     # [L, T, K] float32
    frames: jax.Array  # scalar int32

    @staticmethod
    def zeros(ir_length: int, n_listeners: int = 1,
              n_bands: int = 1) -> "IRState":
        """Fresh state — the ``ClearImpulse`` + ``accumFrames = 0`` reset
        (``RayTraceManager.cs:169-177``)."""
        return IRState(
            sum=jnp.zeros((n_listeners, ir_length, n_bands), jnp.float32),
            frames=jnp.zeros((), jnp.int32))

    @property
    def ir_length(self) -> int:
        return self.sum.shape[-2]

    def normalized(self) -> jax.Array:
        """Monte-Carlo frame average ``sum / max(1, frames)``
        (``AudioConvolve.compute:30`` semantics)."""
        return self.sum / jnp.maximum(1, self.frames).astype(jnp.float32)


def _flatten_hits(hits: Hits):
    """[B,2,R,L] hit records -> per-listener flat (delay[L,N], valid[L,N],
    energy[L,N,K])."""
    b, s, r, l = hits.valid.shape
    k = hits.energy.shape[-1]
    n = b * s * r
    delay = jnp.moveaxis(hits.delay, -1, 0).reshape(l, n)
    valid = jnp.moveaxis(hits.valid, -1, 0).reshape(l, n)
    energy = jnp.moveaxis(hits.energy, -2, 0).reshape(l, n, k)
    return delay, valid, energy


def scatter_hits(hits: Hits, sample_rate: int, ir_length: int) -> jax.Array:
    """Deposit hits into IR bins: returns ``ir[L, T, K]``.

    Bin index is ``floor(delay * sample_rate)``; out-of-range or invalid
    hits are dropped — matching ``ProcessHits``'s bounds check
    (``Raytrace2D.compute:162-163``) without losing concurrent updates.
    """
    delay, valid, energy = _flatten_hits(hits)
    k = energy.shape[-1]

    bins = jnp.floor(delay * sample_rate).astype(jnp.int32)
    ok = valid & (bins >= 0) & (bins < ir_length)
    # Route dropped hits to a sacrificial bin T (sliced off afterwards);
    # explicit rather than relying on scatter OOB semantics.
    bins = jnp.where(ok, bins, ir_length)
    energy = energy * ok[..., None].astype(energy.dtype)

    def one_listener(bins_l, energy_l):
        ir = jnp.zeros((ir_length + 1, k), jnp.float32)
        return ir.at[bins_l].add(energy_l)[:ir_length]

    return jax.vmap(one_listener)(bins, energy)


def scatter_hits_soft(hits: Hits, sample_rate: int,
                      ir_length: int) -> jax.Array:
    """Differentiable variant of :func:`scatter_hits`: each hit splats
    linearly onto the two adjacent IR bins (``lerp`` weights ``1-frac`` /
    ``frac`` of ``delay * sample_rate``).

    The hard ``floor`` binning of the reference's ``ProcessHits``
    (``Raytrace2D.compute:162``) is piecewise-constant in the hit delay, so
    every gradient that flows through *time* — source/listener position,
    medium speed (ior) — dies at the scatter. The linear splat makes the IR
    piecewise-linear in delay instead, unlocking inverse problems over
    geometry (``diff.localize_source``). Forward it differs from the hard
    scatter by at most one bin of temporal smear, and deposited energy
    matches except at the IR's final bin, where a hit's upper splat share
    falls out of range and is dropped. Not used on any parity/production
    path.
    """
    delay, valid, energy = _flatten_hits(hits)
    k = energy.shape[-1]

    pos = delay * sample_rate
    i0f = jnp.floor(pos)
    frac = pos - i0f
    i0 = i0f.astype(jnp.int32)
    ok0 = valid & (i0 >= 0) & (i0 < ir_length)
    ok1 = valid & (i0 + 1 >= 0) & (i0 + 1 < ir_length)
    b0 = jnp.where(ok0, i0, ir_length)        # sacrificial bin like above
    b1 = jnp.where(ok1, i0 + 1, ir_length)
    e0 = energy * ((1.0 - frac) * ok0)[..., None]
    e1 = energy * (frac * ok1)[..., None]

    def one_listener(b0_l, b1_l, e0_l, e1_l):
        ir = jnp.zeros((ir_length + 1, k), jnp.float32)
        return ir.at[b0_l].add(e0_l).at[b1_l].add(e1_l)[:ir_length]

    return jax.vmap(one_listener)(b0, b1, e0, e1)


def accumulate(state: IRState, hits: Hits, sample_rate: int) -> IRState:
    """One frame of Monte-Carlo IR accumulation (ProcessHits + accumFrames++,
    ``RayTraceManager.cs:220-233``)."""
    ir = scatter_hits(hits, sample_rate, state.ir_length)
    return IRState(sum=state.sum + ir, frames=state.frames + 1)


def muffle_band_energies(energy: jax.Array, muffle: jax.Array,
                         n_bands: int,
                         muffle_scale: float = 5.0) -> jax.Array:
    """Legacy frequency spread: expand scalar hit energies ``[...]`` into
    band energies ``[..., n_bands]`` attenuated as
    ``energy * exp(-muffle * band * muffle_scale / n_bands)`` — verbatim
    ``RaytraceOcclusion2D.compute:248`` (with its ``WindowSize`` = n_bands
    and default ``muffleFactor = 5.0`` from ``RayTraceManagerComplex.cs:28``).
    """
    bands = jnp.arange(n_bands, dtype=jnp.float32)
    att = jnp.exp(-muffle[..., None] * bands * muffle_scale / n_bands)
    return energy[..., None] * att


@partial(jax.jit, static_argnames=("width", "height"))
def rasterize_ir(ir_accum: jax.Array, frames: jax.Array, gain: float = 1000.0,
                 width: int = 1024, height: int = 256) -> jax.Array:
    """Waveform raster of a (possibly banded) IR — the ``DrawIR`` debug
    overlay (``Raytrace2D.compute:174-189``) as a pure function.

    ``ir_accum``: [T] or [T, K] accumulated (unnormalized) IR. Returns a
    float32 image [height, width] with 1.0 where the reference writes green.
    Reference mapping: column x samples bin ``floor(x/W * T)``, bar spans
    ``0.1*h < y < 0.1*h + amp * gain * h`` with ``amp = ir[bin]/accumCount``.
    """
    if ir_accum.ndim == 2:
        ir_accum = jnp.sum(ir_accum, axis=-1)
    t = ir_accum.shape[0]
    xs = (jnp.arange(width, dtype=jnp.float32) / width * t).astype(jnp.int32)
    amp = ir_accum[jnp.clip(xs, 0, t - 1)] / \
        jnp.maximum(1, frames).astype(jnp.float32)
    h = float(height)
    y_top = 0.1 * h + amp * gain * h                       # [W]
    rows = jnp.arange(height, dtype=jnp.float32)[:, None]  # [H, 1]
    img = (rows > 0.1 * h) & (rows < y_top[None, :])
    # Image rows run bottom-up in the reference texture; keep that layout.
    return img.astype(jnp.float32)
