"""The flagship trace kernel: batched 2D acoustic path tracing.

Behavioral spec: the reference's ``Trace`` compute kernel
(``Assets/Script/Raytrace2D.compute:49-156``) — stratified angular emission,
fixed-depth bounce loop with nearest-wall intersection, direct listener-circle
capture while outside walls, next-event estimation (NEE) to the listener with
occlusion checking, per-material absorption with an energy cutoff,
probabilistic transmission with Snell refraction and medium speed change, and
a specular/diffuse reflection lerp.

Array-program re-design (not a translation):

* one GPU thread per ray  ->  a single ``lax.scan`` over bounces whose body
  operates on struct-of-arrays ray state ``[R]`` / ``[R, 2]``;
* per-thread ``break``/``continue``  ->  ``alive`` masks and ``jnp.where``;
* brute-force wall loop  ->  one ``[R, W]`` elementwise pass
  (:func:`..geometry.pairwise_ray_segment_t`) reduced by min/argmin;
* ``AppendStructuredBuffer`` hits  ->  fixed-shape masked hit records
  ``[bounces, 2, rays, listeners]`` (slot 0 = direct capture, 1 = NEE);
* scalar energy  ->  optional frequency-banded energy ``[R, K]`` with
  per-material per-band absorption (generalizing the legacy banded IR of
  ``RaytraceOcclusion2D.compute:234-252``);
* one listener  ->  an ``L`` listener axis (stereo = 2 ear circles) sharing
  the wall-intersection work.

Everything is pure and jit/vmap/shard_map-compatible; no data-dependent
shapes escape.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from . import rng as _rng
from .geometry import (EPS, INF, PI, dot2, nearest_hit, normalize,
                       pairwise_ray_segment_t, ray_circle_intersect, reflect,
                       refract, rotate)

# Cutoffs verbatim from the reference kernel.
ENERGY_CUTOFF = 1e-3       # Raytrace2D.compute:122
NEE_CONTRIB_CUTOFF = 1e-5  # Raytrace2D.compute:111
OCCLUSION_SLACK = 0.1      # checkVis tolerance, Raytrace2D.compute:44


class TraceParams(NamedTuple):
    """Dynamic (traced) trace inputs. Static shape knobs (ray count, bounce
    count, band count) live in function arguments / scene shapes instead."""

    source: jax.Array            # [2] source position
    listeners: jax.Array         # [L, 2] listener centers
    listener_radius: jax.Array   # scalar
    speed_of_sound: jax.Array    # scalar
    input_gain: jax.Array        # scalar
    # Optional source directivity: Fourier power-gain coefficients
    # [2M+1] (ops/directivity.py), or None for the reference's omni
    # emission. Weighted in _emit — deposits are linear in a ray's
    # initial energy, so this is exact. None/array changes the pytree
    # structure, which is what lets engine routing act on it.
    directivity: Optional[jax.Array] = None
    # Optional microphone (listener) pickup pattern: [2M+1] shared or
    # [L, 2M+1] per listener. Weighted at both capture sites by the
    # INCOMING sound direction at the listener (direct capture and NEE;
    # the diffraction pass applies it to its bent paths too).
    mic_directivity: Optional[jax.Array] = None

    @staticmethod
    def make(source, listeners, listener_radius=0.5, speed_of_sound=343.0,
             input_gain=1.0, directivity=None,
             mic_directivity=None) -> "TraceParams":
        listeners = jnp.atleast_2d(jnp.asarray(listeners, jnp.float32))
        return TraceParams(
            source=jnp.asarray(source, jnp.float32),
            listeners=listeners,
            listener_radius=jnp.asarray(listener_radius, jnp.float32),
            speed_of_sound=jnp.asarray(speed_of_sound, jnp.float32),
            input_gain=jnp.asarray(input_gain, jnp.float32),
            directivity=None if directivity is None
            else jnp.asarray(directivity, jnp.float32),
            mic_directivity=None if mic_directivity is None
            else jnp.asarray(mic_directivity, jnp.float32))


class Hits(NamedTuple):
    """Fixed-shape hit records, the functional replacement of the
    reference's append buffer (``Raytrace2D.compute:31,82,116``).

    Axes: [bounce, slot, ray, listener] with slot 0 = direct circle capture,
    slot 1 = NEE. ``energy`` carries an extra trailing band axis [K].
    """

    delay: jax.Array    # [B, 2, R, L] seconds
    energy: jax.Array   # [B, 2, R, L, K]
    valid: jax.Array    # [B, 2, R, L] bool

    @property
    def n_bands(self) -> int:
        return self.energy.shape[-1]


class DebugPaths(NamedTuple):
    """Per-bounce positions/energies of the first ``n_debug`` rays — the
    equivalent of the reference's ``debugRays`` gizmo buffer
    (``Raytrace2D.compute:63-64,87-88,96-97``)."""

    pos: jax.Array      # [B+1, D, 2]
    energy: jax.Array   # [B+1, D] (max over bands)
    alive: jax.Array    # [B+1, D] bool


class _RayState(NamedTuple):
    pos: jax.Array      # [R, 2]
    dir: jax.Array      # [R, 2]
    energy: jax.Array   # [R, K]
    time: jax.Array     # [R] accumulated seconds
    dist: jax.Array     # [R] accumulated path length
    speed: jax.Array    # [R] current medium speed
    depth: jax.Array    # [R] int32 wall nesting depth
    alive: jax.Array    # [R] bool


def _emit(params: TraceParams, n_rays: int, n_bands: int,
          emit_jitter: jax.Array) -> _RayState:
    """Stratified-jittered angular emission (``Raytrace2D.compute:52``):
    angle_i = (i + u_i) / R * 2*pi."""
    idx = jnp.arange(n_rays, dtype=jnp.float32)
    angle = (idx + emit_jitter) / n_rays * (2.0 * PI)
    direction = jnp.stack([jnp.cos(angle), jnp.sin(angle)], axis=-1)
    gain = jnp.asarray(params.input_gain, jnp.float32)
    if params.directivity is not None:
        from .directivity import evaluate
        gain = gain * evaluate(params.directivity, angle)[:, None]
    return _RayState(
        pos=jnp.broadcast_to(params.source, (n_rays, 2)).astype(jnp.float32),
        dir=direction,
        energy=jnp.broadcast_to(gain, (n_rays, n_bands)).astype(jnp.float32),
        time=jnp.zeros((n_rays,), jnp.float32),
        dist=jnp.zeros((n_rays,), jnp.float32),
        speed=jnp.full((n_rays,), params.speed_of_sound, jnp.float32),
        depth=jnp.zeros((n_rays,), jnp.int32),
        alive=jnp.ones((n_rays,), bool),
    )


def _bounce(scene: Scene, params: TraceParams, st: _RayState,
            u: jax.Array,
            transmission_surrogate: bool = False) -> Tuple[_RayState, Tuple]:
    """One bounce for all rays. ``u[R, 3]`` are this bounce's uniforms
    (transmission test / refraction jitter / diffuse angle).

    ``transmission_surrogate=True`` swaps the hard ``u < transmission``
    branch (``Raytrace2D.compute:124`` — zero pathwise gradient a.e.) for
    an importance-sampled relaxation: the branch is drawn from a DETACHED
    proposal ``q`` and the smooth likelihood ratio ``t/q`` resp.
    ``(1-t)/(1-q)`` rides the continuing ray's energy, so the expected IR
    is unchanged while ``d/d(transmission)`` flows exactly through the
    weight (docs/DIFF.md). With every transmission exactly 0 the
    surrogate is bit-identical to the hard branch (q = 0, weight = 1)."""
    listeners = params.listeners                     # [L, 2]
    c = params.speed_of_sound

    # --- nearest wall (hot x hot: rays x walls, Raytrace2D.compute:69-72) --
    t_wall = pairwise_ray_segment_t(st.pos, st.dir, scene.a, scene.b)
    closest, hit_idx = nearest_hit(t_wall)           # [R], [R]
    hit_wall = (hit_idx >= 0) & st.alive

    # --- direct listener capture, only outside walls (compute:74-84) -------
    t_lis = ray_circle_intersect(st.pos[:, None, :], st.dir[:, None, :],
                                 listeners[None, :, :],
                                 params.listener_radius)   # [R, L]
    direct_valid = (st.alive & (st.depth == 0))[:, None] \
        & (t_lis < closest[:, None]) & (t_lis < INF)
    total_d = st.dist[:, None] + t_lis
    direct_energy = st.energy[:, None, :] / \
        jnp.maximum(1.0, total_d * total_d)[..., None]     # [R, L, K]
    if params.mic_directivity is not None:
        # incoming sound direction at the listener = -ray direction
        from .directivity import evaluate
        ang = jnp.arctan2(-st.dir[:, 1], -st.dir[:, 0])[:, None]  # [R, 1]
        direct_energy = direct_energy \
            * evaluate(params.mic_directivity, ang)[..., None]
    direct_delay = st.time[:, None] + t_lis / st.speed[:, None]

    # --- advance to the wall (compute:92-94) --------------------------------
    adv = jnp.where(hit_wall, closest, 0.0)
    pos = st.pos + st.dir * adv[:, None]
    time = st.time + adv / st.speed
    dist = st.dist + adv

    # --- gather hit-wall attributes -----------------------------------------
    widx = jnp.maximum(hit_idx, 0)
    w_n = scene.normal[widx]            # [R, 2]
    w_abs = scene.absorption[widx]      # [R, K]
    w_scat = scene.scattering[widx]     # [R]
    w_trans = scene.transmission[widx]  # [R]
    w_ior = scene.ior[widx]             # [R]

    # --- NEE with occlusion check (compute:101-119) -------------------------
    # Shadow ray starts offset along the *unflipped* wall normal; direction
    # is normalized by the unoffset distance — both reference quirks kept.
    nee_src = pos + w_n * EPS                                # [R, 2]
    to_lis = listeners[None, :, :] - pos[:, None, :]         # [R, L, 2]
    dist_lis = jnp.sqrt(jnp.maximum(dot2(to_lis, to_lis), 1e-20))  # [R, L]
    vis_dir = (listeners[None, :, :] - nee_src[:, None, :]) \
        / dist_lis[..., None]
    t_occ = pairwise_ray_segment_t(nee_src[:, None, :], vis_dir,
                                   scene.a, scene.b)          # [R, L, W]
    occ_min = jnp.min(t_occ, axis=-1)
    visible = occ_min >= dist_lis - OCCLUSION_SLACK

    eff_sign = jnp.where(dot2(st.dir, w_n) > 0.0, -1.0, 1.0)  # [R]
    eff_n = w_n * eff_sign[:, None]
    cos_t = jnp.maximum(0.0, dot2(eff_n[:, None, :],
                                  to_lis / dist_lis[..., None]))  # [R, L]
    total_d_nee = dist[:, None] + dist_lis
    geom = cos_t * 0.5 / (total_d_nee * total_d_nee)          # [R, L]
    nee_energy = st.energy[:, None, :] * (1.0 - w_abs)[:, None, :] \
        * geom[..., None]                                     # [R, L, K]
    # The contribution cutoff is a *path importance* test
    # (Raytrace2D.compute:111 applies it to the raw contribution), so it
    # runs BEFORE any mic pickup weighting — all virtual mics at one
    # position agree on which paths exist (spatial.py relies on this).
    nee_valid = hit_wall[:, None] & (st.depth == 0)[:, None] & visible \
        & (jnp.max(nee_energy, axis=-1) > NEE_CONTRIB_CUTOFF)
    if params.mic_directivity is not None:
        # incoming direction at the listener = listener -> bounce point
        from .directivity import evaluate
        ang = jnp.arctan2(-to_lis[..., 1], -to_lis[..., 0])   # [R, L]
        nee_energy = nee_energy \
            * evaluate(params.mic_directivity, ang)[..., None]
    # Listener leg uses the *rest-frame* speed of sound, matching the
    # reference (compute:114 divides by speedOfSound, not curSpeed).
    nee_delay = time[:, None] + dist_lis / c

    # --- absorption + cutoff (compute:121-122) ------------------------------
    energy = st.energy * jnp.where(hit_wall[:, None], 1.0 - w_abs, 1.0)
    alive = hit_wall & (jnp.max(energy, axis=-1) >= ENERGY_CUTOFF)

    # --- transmission w/ refraction (compute:124-147) -----------------------
    entering = dot2(st.dir, w_n) < 0.0
    n_eff = w_n * jnp.where(entering, 1.0, -1.0)[:, None]
    wall_speed = c / w_ior
    next_speed = jnp.where(entering, wall_speed,
                           jnp.where(st.depth <= 1, c, wall_speed))
    eta = next_speed / st.speed
    refr, refr_ok = refract(st.dir, n_eff, eta)
    if transmission_surrogate:
        t_det = jax.lax.stop_gradient(w_trans)
        # proposal: follow detached t, clipped away from 0/1 so both
        # branches keep support wherever t is strictly inside (0, 1);
        # q = 0 where t == 0 exactly (static non-transmissive walls)
        # keeps those rays on the hard reflect branch with weight 1.
        q = jnp.where(t_det > 0.0, jnp.clip(t_det, 0.05, 0.95), 0.0)
        transmit = (u[:, 0] < q) & refr_ok
        w_branch = jnp.where(transmit,
                             w_trans / jnp.maximum(q, 1e-6),
                             (1.0 - w_trans) / (1.0 - q))
        w_branch = jnp.where(refr_ok, w_branch, 1.0)
    else:
        transmit = (u[:, 0] < w_trans) & refr_ok
    jitter = (u[:, 1] - 0.5) * 2.0 * w_scat
    trans_dir = normalize(rotate(refr, jitter))

    # --- reflection: specular/diffuse lerp (compute:149-154) ----------------
    spec_dir = reflect(st.dir, n_eff)
    diff_ang = jnp.arcsin(jnp.clip(2.0 * u[:, 2] - 1.0, -1.0, 1.0))
    diff_dir = rotate(n_eff, diff_ang)
    refl_dir = normalize(spec_dir +
                         (diff_dir - spec_dir) * w_scat[:, None])

    if transmission_surrogate:
        # the likelihood ratio rides the CONTINUING energy only — this
        # bounce's NEE/direct contributions predate the branch. The
        # energy cutoff above stays on the unweighted energy (a detached
        # routing decision; keeps low-weight paths alive to contribute
        # their correctly-weighted expectation).
        energy = energy * w_branch[:, None]
    new_dir = jnp.where(transmit[:, None], trans_dir, refl_dir)
    new_speed = jnp.where(transmit, next_speed, st.speed)
    new_depth = jnp.where(
        transmit,
        jnp.where(entering, st.depth + 1, jnp.maximum(0, st.depth - 1)),
        st.depth)
    pos = pos + jnp.where(transmit[:, None], new_dir * EPS, n_eff * EPS)

    sel = alive
    st_next = _RayState(
        pos=jnp.where(sel[:, None], pos, st.pos),
        dir=jnp.where(sel[:, None], new_dir, st.dir),
        energy=jnp.where(sel[:, None], energy, st.energy),
        time=jnp.where(sel, time, st.time),
        dist=jnp.where(sel, dist, st.dist),
        speed=jnp.where(sel, new_speed, st.speed),
        depth=jnp.where(sel, new_depth, st.depth),
        alive=sel,
    )

    out = (jnp.stack([direct_delay, nee_delay]),            # [2, R, L]
           jnp.stack([direct_energy, nee_energy]),          # [2, R, L, K]
           jnp.stack([direct_valid, nee_valid]),            # [2, R, L]
           pos, hit_wall)
    return st_next, out


@partial(jax.jit,
         static_argnames=("n_rays", "max_bounces", "n_debug",
                          "transmission_surrogate"))
def trace(scene: Scene, params: TraceParams, key: jax.Array, *,
          n_rays: int, max_bounces: int, n_debug: int = 0,
          transmission_surrogate: bool = False
          ) -> Tuple[Hits, Optional[DebugPaths]]:
    """Trace ``n_rays`` stochastic rays for ``max_bounces`` bounces.

    Returns fixed-shape :class:`Hits` (and :class:`DebugPaths` when
    ``n_debug > 0``). Deterministic for a given key: same key -> bit-equal
    hits (fixing the reference's non-atomic scatter race, SURVEY.md section 5).
    """
    n_bands = scene.n_bands
    emit_jitter, u = _rng.bounce_uniforms(key, max_bounces, n_rays)
    st0 = _emit(params, n_rays, n_bands, emit_jitter)

    def body(st, u_b):
        st_next, (delay, energy, valid, pos, hit_wall) = \
            _bounce(scene, params, st, u_b,
                    transmission_surrogate=transmission_surrogate)
        dbg = None
        if n_debug > 0:
            # Miss rays draw an escape stub of length 20 like the reference
            # gizmo path (compute:87-88).
            esc = st.pos[:n_debug] + st.dir[:n_debug] * 20.0
            dbg = (jnp.where(hit_wall[:n_debug, None], pos[:n_debug], esc),
                   jnp.max(st_next.energy[:n_debug], axis=-1),
                   st_next.alive[:n_debug])
        return st_next, (delay, energy, valid, dbg)

    st_final, (delay, energy, valid, dbg) = jax.lax.scan(body, st0, u)
    hits = Hits(delay=delay, energy=energy, valid=valid)

    debug = None
    if n_debug > 0:
        p0 = jnp.broadcast_to(params.source, (n_debug, 2))
        e0 = jnp.max(st0.energy[:n_debug], axis=-1)
        debug = DebugPaths(
            pos=jnp.concatenate([p0[None], dbg[0]], axis=0),
            energy=jnp.concatenate([e0[None], dbg[1]], axis=0),
            alive=jnp.concatenate(
                [jnp.ones((1, n_debug), bool), dbg[2]], axis=0))
    return hits, debug


def trace_hits_only(scene: Scene, params: TraceParams, key: jax.Array, *,
                    n_rays: int, max_bounces: int,
                    transmission_surrogate: bool = False) -> Hits:
    """Hits-only wrapper, convenient under vmap/shard_map."""
    hits, _ = trace(scene, params, key, n_rays=n_rays,
                    max_bounces=max_bounces, n_debug=0,
                    transmission_surrogate=transmission_surrogate)
    return hits
