"""First-order edge diffraction (Maekawa knife-edge model).

The reference's propagation model has **hard shadows**: a listener with
no unoccluded (or transmission-sampled) path hears nothing
(`Raytrace2D.compute:101-119` — NEE is killed by any occluder). Real 2D
sound bends around wall endpoints. This module adds the standard
engineering model for that as a deterministic, vectorized pass:

* Candidate edges are the endpoints of every real wall.
* A path ``source -> edge -> listener`` contributes when the direct
  ``source -> listener`` segment is occluded (shadow zone), both legs of
  the bent path are unoccluded, and the endpoint is a true silhouette
  edge (interior junctions of collinear walls are excluded; coincident
  corner endpoints shared by several walls are counted once).
* The deposit is the reference's own spreading law over the bent path
  length (``input_gain / max(1, d_tot^2)``, `Raytrace2D.compute:110`)
  times the Maekawa barrier attenuation ``1 / (3 + 20 N)`` with Fresnel
  number ``N = 2 delta f / c`` (``delta`` = path detour) — frequency
  dependent, so it maps naturally onto the banded IR axis.

Modeling notes (documented approximations): first order only (no
edge-to-edge double diffraction); the visibility tests treat every wall
as opaque (transmission through walls is already modeled stochastically
by the trace — this pass only fills shadow zones); legs propagate at the
ambient speed of sound (no medium tracking). The pass is deterministic —
independent of rays/frames — so it composes with the Monte-Carlo IR as a
per-frame additive term (see :func:`diffraction_ir` and the CLI's
``--diffraction``). Cost: O(W^2) ray-wall visibility tests + an O(W^2)
endpoint-coincidence pass, fine for room-scale scenes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from .geometry import EPS, pairwise_ray_segment_t
from .trace import TraceParams

# Endpoints closer than this are "the same corner"; wall pairs with
# |cross| below this (per unit length) are collinear.
_COINCIDENT_TOL = 1e-4
_COLLINEAR_TOL = 1e-3


def _segment_clear(p: jnp.ndarray, q: jnp.ndarray, scene: Scene,
                   slack: float = 1e-3) -> jnp.ndarray:
    """True where the open segment ``p -> q`` hits no wall.

    ``p``/``q`` are ``[..., 2]`` (broadcast leading dims). ``slack``
    trims both ends so a segment *ending on* a wall (at an edge) does
    not count its own wall as an occluder — mirroring the reference's
    NEE slack (`Raytrace2D.compute:106`, ``dist - 0.1``) but scaled to
    the edge problem.
    """
    d = q - p
    length = jnp.linalg.norm(d, axis=-1, keepdims=True)
    dn = d / jnp.maximum(length, EPS)
    t = pairwise_ray_segment_t(p, dn, scene.a, scene.b)     # [..., W]
    return ~jnp.any(t < (length - slack), axis=-1)


def edge_table(scene: Scene):
    """Silhouette-edge candidates from a scene: returns
    ``(points[E, 2], weight[E])`` with ``E = 2 W``; ``weight`` is 0 for
    invalid edges (padding walls, interior collinear junctions) and
    ``1/multiplicity`` for corner points shared by several walls."""
    pts = jnp.concatenate([scene.a, scene.b], axis=0)           # [E, 2]
    # Direction from the endpoint INTO its wall.
    into = jnp.concatenate([scene.b - scene.a, scene.a - scene.b], axis=0)
    length = jnp.linalg.norm(into, axis=-1)                     # [E]
    valid = jnp.concatenate([scene.mask, scene.mask]) & (length > EPS)

    diff = pts[:, None, :] - pts[None, :, :]                    # [E, E, 2]
    coincident = (jnp.sum(diff * diff, axis=-1)
                  < _COINCIDENT_TOL ** 2) & valid[None, :]      # [E, E]

    # Interior junction: a DIFFERENT wall's endpoint at the same corner
    # whose wall continues collinearly on the other side (into-dirs
    # antiparallel) — sound does not diffract through a straight seam.
    n_into = into / jnp.maximum(length, EPS)[..., None]
    cross = (n_into[:, None, 0] * n_into[None, :, 1]
             - n_into[:, None, 1] * n_into[None, :, 0])         # [E, E]
    dot = jnp.sum(n_into[:, None, :] * n_into[None, :, :], axis=-1)
    not_self = ~jnp.eye(pts.shape[0], dtype=bool)
    straight_seam = jnp.any(coincident & not_self
                            & (jnp.abs(cross) < _COLLINEAR_TOL)
                            & (dot < 0.0), axis=-1)

    valid = valid & ~straight_seam
    multiplicity = jnp.sum(coincident & valid[None, :], axis=-1)
    weight = jnp.where(valid & (multiplicity > 0),
                       1.0 / jnp.maximum(multiplicity, 1), 0.0)
    return pts, weight


def diffraction_paths(scene: Scene, params: TraceParams,
                      band_freqs) -> tuple:
    """Evaluate all first-order edge paths.

    Returns ``(delay[L, E], energy[L, E, K], valid[L, E])`` for ``E =
    2 W`` candidate edges and the listener axis of ``params``.
    ``band_freqs`` maps the scene's band axis to Hz (``[K]``).
    """
    pts, weight = edge_table(scene)                             # [E, 2]
    src = params.source
    lis = jnp.atleast_2d(params.listeners)                      # [L, 2]
    c = params.speed_of_sound
    freqs = jnp.asarray(band_freqs, jnp.float32)

    d1 = jnp.linalg.norm(pts - src, axis=-1)                    # [E]
    src_clear = _segment_clear(jnp.broadcast_to(src, pts.shape), pts,
                               scene)                           # [E]

    def per_listener(li):
        d_dir = jnp.linalg.norm(li - src)
        direct_blocked = ~_segment_clear(src[None, :], li[None, :],
                                         scene)[0]
        leg_clear = _segment_clear(pts, jnp.broadcast_to(li, pts.shape),
                                   scene)                       # [E]
        d2 = jnp.linalg.norm(li - pts, axis=-1)                 # [E]
        d_tot = d1 + d2
        delta = jnp.maximum(d_tot - d_dir, 0.0)
        fresnel = 2.0 * delta[:, None] * freqs[None, :] / c     # [E, K]
        base = params.input_gain / jnp.maximum(1.0, d_tot * d_tot)
        energy = (weight * base)[:, None] / (3.0 + 20.0 * fresnel)
        valid = (weight > 0) & src_clear & leg_clear & direct_blocked
        return d_tot / c, energy * valid[:, None], valid

    delay, energy, valid = jax.vmap(per_listener)(lis)
    energy = energy * _pattern_weights(params, pts, lis)[..., None]
    return delay, energy, valid


def _pattern_weights(params: TraceParams, pts: jnp.ndarray,
                     lis: jnp.ndarray) -> jnp.ndarray:
    """Directivity weights ``[L, E]`` for bent paths whose middle point
    is ``pts``: source pattern at the departure angle (source -> edge)
    times mic pattern at the arrival angle (listener -> edge = incoming
    direction of the bent path's last leg)."""
    w = jnp.ones((lis.shape[0], pts.shape[0]), jnp.float32)
    if params.directivity is not None:
        from .directivity import evaluate
        out = pts - params.source                               # [E, 2]
        w = w * evaluate(params.directivity,
                         jnp.arctan2(out[:, 1], out[:, 0]))[None, :]
    if params.mic_directivity is not None:
        from .directivity import evaluate
        inc = pts[None, :, :] - lis[:, None, :]                 # [L, E, 2]
        ang = jnp.arctan2(inc[..., 1], inc[..., 0])             # [L, E]
        c = jnp.asarray(params.mic_directivity, jnp.float32)
        if c.ndim == 2:
            c = c[:, None, :]                 # [L, 1, C] vs ang [L, E]
        w = w * evaluate(c, ang)
    return w


def diffraction_paths2(scene: Scene, params: TraceParams,
                       band_freqs) -> tuple:
    """Second-order (edge-to-edge) paths ``S -> E1 -> E2 -> L``.

    This is what rounds a THICK obstacle: first order clips the far
    corner (both single-edge legs are occluded), second order bends at
    both corners. Attenuation is the Maekawa cascade — each wedge gets
    its own Fresnel factor ``1/(3 + 20 N)``, with the detour of its
    local triangle (``N1`` from ``S->E1->E2`` vs straight ``S->E2``,
    ``N2`` from ``E1->E2->L`` vs straight ``E1->L``) — the standard
    double-barrier engineering approximation. Cost is O(W^3) visibility
    (all edge pairs against all walls, evaluated row-by-row via
    ``lax.map`` to bound memory): opt-in, sized for room-scale scenes.

    Returns ``(delay[L, E, E], energy[L, E, E, K], valid[L, E, E])``.
    """
    pts, weight = edge_table(scene)                             # [E, 2]
    e = pts.shape[0]
    src = params.source
    lis = jnp.atleast_2d(params.listeners)
    c = params.speed_of_sound
    freqs = jnp.asarray(band_freqs, jnp.float32)

    d1 = jnp.linalg.norm(pts - src, axis=-1)                    # [E]
    src_clear = _segment_clear(jnp.broadcast_to(src, pts.shape), pts,
                               scene)                           # [E]
    d12 = jnp.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    pair_clear = jax.lax.map(
        lambda p: _segment_clear(jnp.broadcast_to(p, pts.shape), pts,
                                 scene), pts)                   # [E, E]
    distinct = d12 > _COINCIDENT_TOL
    # straight-line references for the two local detours
    s_to_e2 = jnp.linalg.norm(pts - src, axis=-1)               # [E]

    def per_listener(li):
        direct_blocked = ~_segment_clear(src[None, :], li[None, :],
                                         scene)[0]
        leg_clear = _segment_clear(pts, jnp.broadcast_to(li, pts.shape),
                                   scene)                       # [E]
        d2 = jnp.linalg.norm(li - pts, axis=-1)                 # [E]
        e1_to_l = d2                                            # [E]
        d_tot = d1[:, None] + d12 + d2[None, :]                 # [E, E]
        delta1 = jnp.maximum(d1[:, None] + d12 - s_to_e2[None, :], 0.0)
        delta2 = jnp.maximum(d12 + d2[None, :] - e1_to_l[:, None], 0.0)
        n1 = 2.0 * delta1[..., None] * freqs / c                # [E,E,K]
        n2 = 2.0 * delta2[..., None] * freqs / c
        att = 1.0 / ((3.0 + 20.0 * n1) * (3.0 + 20.0 * n2))
        base = params.input_gain / jnp.maximum(1.0, d_tot * d_tot)
        w2d = weight[:, None] * weight[None, :]
        valid = ((w2d > 0) & distinct & src_clear[:, None] & pair_clear
                 & leg_clear[None, :] & direct_blocked)
        energy = (w2d * base)[..., None] * att * valid[..., None]
        return d_tot / c, energy, valid

    delay, energy, valid = jax.vmap(per_listener)(lis)
    if params.directivity is not None:
        from .directivity import evaluate
        out = pts - src
        g = evaluate(params.directivity,
                     jnp.arctan2(out[:, 1], out[:, 0]))        # [E1]
        energy = energy * g[None, :, None, None]
    if params.mic_directivity is not None:
        from .directivity import evaluate
        inc = pts[None, :, :] - lis[:, None, :]                 # [L, E2, 2]
        ang = jnp.arctan2(inc[..., 1], inc[..., 0])
        cm = jnp.asarray(params.mic_directivity, jnp.float32)
        if cm.ndim == 2:
            cm = cm[:, None, :]
        energy = energy * evaluate(cm, ang)[:, None, :, None]
    return delay, energy, valid


def _scatter_paths(delay, energy, sample_rate: int, ir_length: int,
                   k: int) -> jnp.ndarray:
    """Bin path families ``delay[L, ...]`` / ``energy[L, ..., K]`` into an
    IR ``[L, T, K]`` (invalid paths carry zero energy)."""
    l = delay.shape[0]
    delay = delay.reshape(l, -1)
    energy = energy.reshape(l, -1, k)
    bins = jnp.floor(delay * sample_rate).astype(jnp.int32)
    ok = (bins >= 0) & (bins < ir_length)
    bins = jnp.where(ok, bins, ir_length)
    energy = energy * ok[..., None]

    def one_listener(b, en):
        out = jnp.zeros((ir_length + 1, k), jnp.float32)
        return out.at[b].add(en)[:ir_length]

    return jax.vmap(one_listener)(bins, energy)


@partial(jax.jit, static_argnames=("sample_rate", "ir_length", "order"))
def diffraction_ir(scene: Scene, params: TraceParams, *,
                   sample_rate: int, ir_length: int,
                   band_freqs=None, order: int = 1) -> jnp.ndarray:
    """Deterministic diffraction IR ``[L, T, K]``.

    Add it to a traced frame's IR (or ``frames *`` it into an
    :class:`~..ops.ir.IRState`'s accumulated sum — it has no Monte-Carlo
    variance). ``band_freqs`` defaults to the log-spaced band centers of
    :func:`..ops.air.band_frequencies`. ``order=2`` adds edge-to-edge
    double diffraction (:func:`diffraction_paths2` — O(W^3), opt-in).
    """
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    k = scene.n_bands
    if band_freqs is None:
        from .air import band_frequencies
        band_freqs = band_frequencies(k)
    delay, energy, _ = diffraction_paths(scene, params, band_freqs)
    ir = _scatter_paths(delay, energy, sample_rate, ir_length, k)
    if order >= 2:
        delay2, energy2, _ = diffraction_paths2(scene, params, band_freqs)
        ir = ir + _scatter_paths(delay2, energy2, sample_rate, ir_length,
                                 k)
    return ir
