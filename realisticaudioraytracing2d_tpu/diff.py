"""Differentiable acoustics: ``jax.grad`` through the trace.

This module is a capability the reference cannot express: the Unity/HLSL
pipeline (``Assets/Script/Raytrace2D.compute``) runs on a graphics queue
with no autodiff, so inverse problems (estimate wall materials from a
measured impulse response) need external black-box search. Here the whole
forward simulation — emission, bounces, NEE, IR binning — is a pure JAX
function, so material estimation is plain gradient descent.

What is differentiable, and why it is sound:

* **absorption** scales ray energy multiplicatively every bounce
  (``Raytrace2D.compute:121`` -> ``ops/trace.py::_bounce``) — smooth.
* **scattering** lerps specular->diffuse reflection directions and the
  refraction jitter (``compute:149-154``) — directions move continuously,
  so the pathwise derivative exists. (It ignores visibility-boundary terms,
  the standard bias of differentiable path tracing without edge sampling;
  in practice EDC-style losses average it out.)
* **transmission** only enters through the discrete branch
  ``u < transmission`` (``compute:124``): the hard branch's pathwise
  gradient is zero almost everywhere, so it is excluded from the default
  fit fields. It IS fittable via the importance-sampled surrogate forward
  (``simulate_ir(transmission_surrogate=True)``, auto-enabled by
  ``fit_materials(fields=(..., "transmission"))``): the branch is drawn
  from a detached proposal and the smooth likelihood ratio rides the
  continuing ray's energy — same expected IR, exact pathwise gradient in
  the transmission probability (docs/DIFF.md).
* **ior** and **positions** (source/listener) act mostly through hit
  *delays*, which the hard ``floor`` binning flattens to zero gradient;
  the soft two-bin splat (``simulate_ir(soft=True)``) restores them —
  see :func:`localize_source` and ``fields=("ior",)`` + ``loss="blur"``.

Geometric selections (nearest wall, listener capture, energy cutoffs) are
piecewise-constant in the material parameters; their a.e. derivative is
exactly zero, which autodiff reproduces. Gradients here were validated
against central finite differences (see ``tests/test_diff.py``).

The whole forward is the plain jnp trace + deposit, so every platform
differentiates the same XLA program. Fitting runs typically use small ray
budgets (stochastic gradients).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models.scene import Scene
from .ops import ir as irm
from .ops.trace import TraceParams, trace_hits_only

_LOGIT_EPS = 1e-4

# Fields of MaterialParams with usable pathwise gradients under the PLAIN
# forward. "transmission" is fittable via the surrogate forward (enabled
# automatically when requested in fields); "ior" is fittable too, but only
# with the soft splat (its signal is mostly delay) — opt in via
# fields=(..., "ior") plus soft=True.
DEFAULT_FIT_FIELDS: Tuple[str, ...] = ("absorption", "scattering")

# The reference's ior slider range (AudioMaterial.cs:20).
IOR_MIN, IOR_MAX = 0.01, 4.0


def _logit(v: jax.Array, lo: float = 0.0, hi: float = 1.0) -> jax.Array:
    v = jnp.clip((v - lo) / (hi - lo), _LOGIT_EPS, 1.0 - _LOGIT_EPS)
    return jnp.log(v) - jnp.log1p(-v)


def infer_material_groups(scene: Scene) -> Tuple[np.ndarray, int]:
    """Recover per-wall material-group ids from a built :class:`Scene`.

    Walls sharing an identical acoustic signature (banded absorption,
    scattering, transmission, ior) get one shared parameter group — the
    inverse of the reference's one-material-per-collider binding
    (``AudioSurface.cs``). Host-side and static: returns a numpy ``[W]``
    int32 array plus the group count. Padding walls (mask False) are
    grouped too but :func:`apply_materials` never lets them influence the
    trace (degenerate segments + mask guard).
    """
    sig = np.concatenate([
        np.asarray(scene.absorption, np.float64),
        np.asarray(scene.scattering, np.float64)[:, None],
        np.asarray(scene.transmission, np.float64)[:, None],
        np.asarray(scene.ior, np.float64)[:, None],
    ], axis=1)
    _, groups = np.unique(sig, axis=0, return_inverse=True)
    groups = groups.astype(np.int32)
    return groups, int(groups.max()) + 1


class MaterialParams(NamedTuple):
    """Unconstrained (logit-space) per-group material parameters.

    Logit parametrization keeps every constrained value inside the
    reference's [0, 1] ranges (``AudioMaterial.cs:6-20``) for free during
    unconstrained gradient descent.
    """

    absorption: jax.Array    # [G, K] logits
    scattering: jax.Array    # [G] logits
    transmission: jax.Array  # [G] logits
    ior: jax.Array           # [G] logits over [IOR_MIN, IOR_MAX]

    @property
    def n_groups(self) -> int:
        return self.absorption.shape[0]

    @staticmethod
    def from_scene(scene: Scene, groups: np.ndarray,
                   n_groups: int) -> "MaterialParams":
        """Initialize from a scene's current materials (first wall of each
        group wins; groups are signature-uniform by construction when they
        come from :func:`infer_material_groups`)."""
        first = np.zeros((n_groups,), np.int32)
        seen = set()
        for w, g in enumerate(np.asarray(groups)):
            if int(g) not in seen:
                seen.add(int(g))
                first[int(g)] = w
        first_j = jnp.asarray(first)
        return MaterialParams(
            absorption=_logit(scene.absorption[first_j]),
            scattering=_logit(scene.scattering[first_j]),
            transmission=_logit(scene.transmission[first_j]),
            ior=_logit(scene.ior[first_j], IOR_MIN, IOR_MAX))

    def constrained(self) -> Tuple[jax.Array, jax.Array, jax.Array,
                                   jax.Array]:
        """(absorption [G, K], scattering [G], transmission [G]) in [0, 1]
        plus ior [G] in [IOR_MIN, IOR_MAX]."""
        return (jax.nn.sigmoid(self.absorption),
                jax.nn.sigmoid(self.scattering),
                jax.nn.sigmoid(self.transmission),
                IOR_MIN + jax.nn.sigmoid(self.ior) * (IOR_MAX - IOR_MIN))


def apply_materials(scene: Scene, groups: jax.Array, params: MaterialParams,
                    fields: Sequence[str] = DEFAULT_FIT_FIELDS) -> Scene:
    """Differentiably rebind wall materials from ``params``.

    Only ``fields`` are replaced; everything else (and every padding wall,
    via the mask guard) keeps the scene's original values, so padding stays
    inert exactly as ``Scene.pad_to`` built it.
    """
    groups = jnp.asarray(groups)
    absorption, scattering, transmission, ior = params.constrained()
    mask1 = scene.mask
    mask2 = scene.mask[:, None]
    updates = {}
    if "absorption" in fields:
        updates["absorption"] = jnp.where(
            mask2, absorption[groups], scene.absorption)
    if "scattering" in fields:
        updates["scattering"] = jnp.where(
            mask1, scattering[groups], scene.scattering)
    if "transmission" in fields:
        updates["transmission"] = jnp.where(
            mask1, transmission[groups], scene.transmission)
    if "ior" in fields:
        updates["ior"] = jnp.where(mask1, ior[groups], scene.ior)
    return scene._replace(**updates)


@partial(jax.jit, static_argnames=("n_rays", "max_bounces", "sample_rate",
                                   "ir_length", "frames", "remat", "soft",
                                   "transmission_surrogate"))
def simulate_ir(scene: Scene, params: TraceParams, key: jax.Array, *,
                n_rays: int, max_bounces: int, sample_rate: int,
                ir_length: int, frames: int = 1,
                remat: bool = True, soft: bool = False,
                transmission_surrogate: bool = False) -> jax.Array:
    """Differentiable forward model: mean IR histogram ``[L, T, K]`` over
    ``frames`` Monte-Carlo frames.

    Frames run under ``lax.map`` with ``jax.checkpoint`` on the per-frame
    body (``remat=True``), so reverse-mode memory stays one-frame-sized
    instead of storing every bounce residual of every frame — the
    memory-friendly way to differentiate long accumulations on device.

    ``soft=True`` swaps the hard ``floor`` binning for the two-bin linear
    splat (:func:`~..ops.ir.scatter_hits_soft`) so gradients flow through
    hit *delays* as well as energies — required when differentiating with
    respect to positions or medium speed (:func:`localize_source`).

    ``transmission_surrogate=True`` swaps the hard ``u < transmission``
    branch for the expectation-preserving importance relaxation
    (:func:`~..ops.trace._bounce`) — required when differentiating with
    respect to wall *transmission* (whose hard-branch pathwise gradient
    is zero a.e.; see the module docstring and docs/DIFF.md).
    """
    scatter = irm.scatter_hits_soft if soft else irm.scatter_hits

    def one_frame(k):
        hits = trace_hits_only(scene, params, k, n_rays=n_rays,
                               max_bounces=max_bounces,
                               transmission_surrogate=transmission_surrogate)
        return scatter(hits, sample_rate, ir_length)

    if frames == 1:
        return one_frame(key)
    body = jax.checkpoint(one_frame) if remat else one_frame
    keys = jax.random.split(key, frames)
    return jnp.mean(jax.lax.map(body, keys), axis=0)


# -- losses ------------------------------------------------------------------

def ir_mse(pred: jax.Array, target: jax.Array) -> jax.Array:
    """Plain L2 on the energy histograms."""
    return jnp.mean(jnp.square(pred - target))


def edc(ir: jax.Array, axis: int = -2) -> jax.Array:
    """Schroeder energy-decay curve: reversed cumulative sum of the energy
    histogram along time. The standard observable for reverberation /
    material estimation — much smoother in the materials than the raw
    binned IR, since it integrates out bin-placement noise."""
    rev = jnp.flip(ir, axis=axis)
    return jnp.flip(jnp.cumsum(rev, axis=axis), axis=axis)


def log_edc_loss(pred: jax.Array, target: jax.Array,
                 floor: float = 1e-8) -> jax.Array:
    """L2 between log10 energy-decay curves (dB-scale match)."""
    return jnp.mean(jnp.square(
        jnp.log10(edc(pred) + floor) - jnp.log10(edc(target) + floor)))


def combined_loss(pred: jax.Array, target: jax.Array,
                  mse_weight: float = 2000.0) -> jax.Array:
    """log-EDC + weighted raw-IR MSE. EDC constrains the overall decay
    rate; the raw-IR term keeps the early-reflection amplitude structure
    that EDC integrates away — in two-group recovery experiments each term
    alone leaves one group on a trade-off plateau, together they pin both
    (see ``examples/inverse_materials.py``). The default weight puts both
    terms at comparable magnitude for normalized single-frame IRs."""
    return log_edc_loss(pred, target) + mse_weight * ir_mse(pred, target)


_LOSSES = {"mse": ir_mse, "edc": log_edc_loss, "edc+mse": combined_loss}


# -- fitting -----------------------------------------------------------------

class FitResult(NamedTuple):
    params: MaterialParams   # fitted logits
    scene: Scene             # input scene with fitted materials applied
    losses: jax.Array        # [steps] loss trajectory


def fit_materials(scene: Scene, trace_params: TraceParams,
                  target_ir: jax.Array, key: jax.Array, *,
                  n_rays: int, max_bounces: int, sample_rate: int,
                  frames: int = 1,
                  groups: Optional[np.ndarray] = None,
                  init: Optional[MaterialParams] = None,
                  fields: Sequence[str] = DEFAULT_FIT_FIELDS,
                  loss: str = "edc", steps: int = 100, lr: float = 0.05,
                  resample: bool = True, soft: bool = False,
                  blur_sigma0: float = 16.0, blur_sigma_min: float = 1.0,
                  blur_anneal_steps: float = 25.0) -> FitResult:
    """Estimate wall materials from a target IR by gradient descent.

    ``target_ir`` is an ``[L, T, K]`` energy histogram (e.g. a normalized
    :class:`~realisticaudioraytracing2d_tpu.ops.ir.IRState` sum, or a
    measured/banded EDC-compatible response). Optimizes Adam in logit space;
    ``resample=True`` folds the step index into the RNG key each step
    (unbiased stochastic gradients), ``False`` fixes the noise (common
    random numbers — deterministic loss, converges tighter on synthetic
    targets). Transmission is excluded from ``fields`` by default (the
    hard branch has zero pathwise gradient); passing
    ``fields=(..., "transmission")`` automatically switches the forward
    to the importance-sampled surrogate
    (``simulate_ir(transmission_surrogate=True)``), whose expected IR
    matches the hard forward while the branch probability becomes a
    smooth energy weight — so synthetic targets can still be produced
    with the plain forward. Prefer ``resample=True`` here: the surrogate
    gradient is stochastic through which rays take the branch.

    Fitting **ior** needs delay gradients: pass ``fields=(..., "ior")``
    together with ``soft=True`` (two-bin splat forward) and
    ``loss="blur"`` — relative L2 between Gaussian-blurred IRs with sigma
    annealed ``blur_sigma0 -> blur_sigma_min`` bins over
    ``blur_anneal_steps``-step halvings (coarse-to-fine, same recipe as
    :func:`localize_source`).
    """
    import optax

    unknown = set(fields) - {"absorption", "scattering", "transmission",
                             "ior"}
    if unknown:
        raise ValueError(f"unknown material fields {sorted(unknown)}; "
                         "pick from absorption/scattering/transmission/ior")
    if loss == "blur":
        loss_fn = _blur_rel_l2
    elif loss in _LOSSES:
        base = _LOSSES[loss]
        loss_fn = lambda pred, tgt, sigma: base(pred, tgt)  # noqa: E731
    else:
        raise ValueError(
            f"loss={loss!r}; pick from {sorted(_LOSSES) + ['blur']}")
    if groups is None:
        groups, n_groups = infer_material_groups(scene)
    else:
        groups = np.asarray(groups, np.int32)
        n_groups = int(groups.max()) + 1
    if init is None:
        init = MaterialParams.from_scene(scene, groups, n_groups)
    groups_j = jnp.asarray(groups)
    target_ir = jnp.asarray(target_ir, jnp.float32)
    ir_length = target_ir.shape[-2]
    fields = tuple(fields)

    opt = optax.adam(lr)

    surrogate = "transmission" in fields

    def objective(mp: MaterialParams, k: jax.Array,
                  sigma: jax.Array) -> jax.Array:
        fitted = apply_materials(scene, groups_j, mp, fields)
        pred = simulate_ir(fitted, trace_params, k, n_rays=n_rays,
                           max_bounces=max_bounces, sample_rate=sample_rate,
                           ir_length=ir_length, frames=frames, soft=soft,
                           transmission_surrogate=surrogate)
        return loss_fn(pred, target_ir, sigma)

    @jax.jit
    def step(mp, opt_state, k, sigma):
        value, grads = jax.value_and_grad(objective)(mp, k, sigma)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(mp, updates), opt_state, value

    mp = init
    opt_state = opt.init(mp)
    losses = []
    sigmas = _sigma_schedule(steps, blur_sigma0, blur_sigma_min,
                             blur_anneal_steps)
    for i in range(steps):
        k = jax.random.fold_in(key, i) if resample else key
        mp, opt_state, value = step(mp, opt_state, k, sigmas[i])
        losses.append(value)

    fitted_scene = apply_materials(scene, groups_j, mp, fields)
    return FitResult(params=mp, scene=fitted_scene,
                     losses=jnp.stack(losses))


# -- source localization -------------------------------------------------------

def gaussian_blur_time(ir: jax.Array, sigma: jax.Array,
                       radius: int = 96) -> jax.Array:
    """Blur an ``[L, T, K]`` IR along time with a Gaussian of (traced)
    ``sigma`` bins. Multi-scale smoothing is what makes position fitting
    tractable: a raw IR is a train of near-delta spikes whose L2 distance
    has no gradient until spikes overlap; blurred at ``sigma`` bins, delay
    mismatches attract from ~``sigma`` bins away. ``radius`` (static)
    bounds the kernel support."""
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    kern = jnp.exp(-0.5 * jnp.square(x / jnp.maximum(sigma, 0.25)))
    kern = kern / jnp.sum(kern)
    # Explicit zero-pad + 'valid' always returns T samples; 'same' would
    # return the KERNEL length whenever T < 2*radius+1 (short IRs),
    # silently re-centering the time axis.
    blur_row = lambda row: jnp.convolve(  # noqa: E731
        jnp.pad(row, radius), kern, mode="valid")
    return jax.vmap(jax.vmap(blur_row, in_axes=-1, out_axes=-1))(ir)


def _blur_rel_l2(pred: jax.Array, target: jax.Array, sigma: jax.Array,
                 scale_invariant: bool = False) -> jax.Array:
    """Relative L2 between Gaussian-blurred IRs — the shared coarse-to-fine
    objective of :func:`fit_materials` (``loss="blur"``) and
    :func:`localize_source`. ``scale_invariant=True`` first scales the
    blurred prediction by its optimal least-squares gain
    ``<pb, tb> / <pb, pb>`` (the closed-form projection), making the loss
    independent of the target's absolute level — for measured IRs with
    unknown calibration."""
    pb = gaussian_blur_time(pred, sigma)
    tb = gaussian_blur_time(target, sigma)
    if scale_invariant:
        g = jnp.sum(pb * tb) / jnp.maximum(jnp.sum(pb * pb), 1e-20)
        pb = pb * g
    return jnp.mean(jnp.square(pb - tb)) / \
        jnp.maximum(jnp.mean(jnp.square(tb)), 1e-20)


def _sigma_schedule(steps: int, sigma0: float, sigma_min: float,
                    anneal_steps: float) -> jax.Array:
    """Coarse-to-fine blur widths: ``sigma0`` halving every
    ``anneal_steps`` steps, floored at ``sigma_min``."""
    i = jnp.arange(steps, dtype=jnp.float32)
    return (sigma0 * 0.5 ** (i / anneal_steps) + sigma_min).astype(
        jnp.float32)


def first_arrival_times(ir: np.ndarray, sample_rate: int,
                        threshold_frac: float = 0.02) -> np.ndarray:
    """Per-listener first-arrival time (seconds) of an ``[L, T, K]`` energy
    IR: first bin reaching ``threshold_frac`` of that listener's peak
    (band-summed). Host-side; used to build the trilateration term of the
    localization loss from a measured/binned target IR. Raises on a
    listener with an all-zero IR — a silent bin-0 "arrival" would pull the
    fit onto that listener's radius circle."""
    e = np.asarray(ir).sum(axis=-1)                     # [L, T]
    peak = e.max(axis=1, keepdims=True)
    if (peak <= 0.0).any():
        empty = np.flatnonzero(peak[:, 0] <= 0.0).tolist()
        raise ValueError(
            f"listeners {empty} have an all-zero target IR — no first "
            "arrival to localize against (trace with more bounces/rays or "
            "a longer IR)")
    bins = np.argmax(e >= peak * threshold_frac, axis=1)  # [L]
    return (bins + 0.5) / float(sample_rate)


def scene_bounds(scene: Scene, shrink: float = 0.05) -> np.ndarray:
    """AABB of the real (non-padding) walls, shrunk by ``shrink`` of its
    extent per side — the default search box for :func:`localize_source`.
    For rooms whose walls are thick boxes, this outer hull includes the
    wall band, where a hypothesis traces nothing and its loss plateaus —
    pass explicit interior ``bounds`` there (essential for
    ``n_sources > 1``, where every point of a hypothesis must land
    inside)."""
    mask = np.asarray(scene.mask)
    pts = np.concatenate([np.asarray(scene.a)[mask],
                          np.asarray(scene.b)[mask]], axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = (hi - lo) * shrink
    return np.stack([lo + pad, hi - pad])               # [2(lo/hi), 2(xy)]


class LocalizeResult(NamedTuple):
    position: jax.Array   # [2] (or [N, 2] for n_sources=N) best fit
    loss: jax.Array       # its final loss
    positions: jax.Array  # [S, 2] / [S, N, 2] every start's fit
    losses: jax.Array     # [S] every start's final loss


def localize_source(scene: Scene, trace_params: TraceParams,
                    target_ir: jax.Array, key: jax.Array, *,
                    n_rays: int, max_bounces: int, sample_rate: int,
                    n_starts: int = 8, steps: int = 200, lr: float = 0.08,
                    bounds: Optional[np.ndarray] = None,
                    sigma0: float = 24.0, sigma_min: float = 1.0,
                    anneal_steps: float = 30.0,
                    arrival_weight: float = 1.0,
                    ir_weight: float = 30.0,
                    starts_key: Optional[jax.Array] = None,
                    starts: Optional[jax.Array] = None,
                    gain_invariant: bool = False,
                    n_sources: int = 1,
                    mesh=None, axis: str = "rooms") -> LocalizeResult:
    """Estimate the *source position* from a target IR by gradient descent
    through the ray tracer — differentiable echoes as a localization sensor.

    The capability the soft splat buys: with hard binning every
    position gradient is zero a.e.; with :func:`scatter_hits_soft` the IR
    moves continuously with the source, so ``jax.grad`` works. Even a
    SINGLE listener localizes: its first arrival fixes a range circle and
    the wall-reflection pattern picks the point on it (see
    ``examples/locate_source.py``).

    Loss = ``arrival_weight`` x trilateration (closed-form direct-path
    delay ``(|s - l| - r) / c`` vs the target's first arrivals, in ms^2)
    + ``ir_weight`` x relative L2 between Gaussian-blurred IRs, with sigma
    annealed ``sigma0 -> sigma_min`` over ``anneal_steps`` halvings
    (coarse-to-fine). The landscape is multi-modal, so ``n_starts`` Adam
    runs start from a uniform draw over ``bounds`` (default: the scene's
    wall AABB) and run batched under one ``vmap`` — multi-start is a batch
    axis, not a host loop. Fixed RNG key (common random numbers) keeps the
    per-start objective deterministic.

    Pass a ``jax.sharding.Mesh`` as ``mesh`` to shard the starts over
    ``mesh[axis]`` with ``shard_map``: each device runs its local starts
    through the same vmapped fit — embarrassingly parallel, matching the
    unsharded run to float tolerance (XLA fuses the two programs
    differently; the axis size must divide ``n_starts`` evenly).
    Inverse problems scale across chips the same way the forward sweeps
    do.

    ``gain_invariant=True`` makes the IR term independent of the target's
    absolute level via the closed-form optimal gain (the first-arrival
    term already is, its threshold being relative to the peak) — use for
    measured IRs with unknown calibration.

    ``n_sources=N`` localizes N SIMULTANEOUS sources jointly from one
    mixed IR (propagation is linear in the emission, so the predicted IR
    is the sum of per-source IRs). Each start is then an ``[N, 2]``
    hypothesis and ``position`` comes back ``[N, 2]`` (up to source
    permutation). The trilateration term only applies to N = 1 — a mixed
    IR's first arrival is the min over sources, not per-source.

    Assumption: the trilateration term models the first arrival as a
    LINE-OF-SIGHT path at speed ``c``. With the direct path occluded or
    refracted through transmissive walls (e.g. SmollRoom's source behind
    its slanted ior-0.6 wall), set ``arrival_weight=0`` and rely on the
    blurred-IR term, with ``sigma0`` scaled to the room's size in bins.

    ``trace_params.source`` is ignored; listeners/radius/speeds are used.
    """
    target_ir = jnp.asarray(target_ir, jnp.float32)
    ir_length = target_ir.shape[-2]
    if bounds is None:
        bounds = scene_bounds(scene)
    bounds = np.asarray(bounds, np.float32)
    fa_target = jnp.asarray(
        first_arrival_times(target_ir, sample_rate), jnp.float32)  # [L]

    if starts is not None:
        # Explicit starts (e.g. warm-starting a tracking loop from the
        # previous chunk's estimate) override the random draw. Accepted
        # shapes: [2], [S, 2] (single source), [S, N, 2].
        starts = jnp.asarray(starts, jnp.float32).reshape(-1, n_sources, 2)
        n_starts = starts.shape[0]
    else:
        if starts_key is None:
            starts_key = jax.random.fold_in(key, 0x10C8)
        starts = jax.random.uniform(
            starts_key, (n_starts, n_sources, 2),
            minval=jnp.asarray(bounds[0]), maxval=jnp.asarray(bounds[1]))
    if mesh is not None and n_starts % mesh.shape[axis] != 0:
        raise ValueError(f"{n_starts} starts not divisible by "
                         f"{axis}={mesh.shape[axis]}")
    sigmas = _sigma_schedule(steps, sigma0, sigma_min, anneal_steps)
    program = _localize_program(
        n_rays, max_bounces, sample_rate, ir_length, lr,
        arrival_weight, ir_weight, gain_invariant, mesh, axis)
    # Target/starts/schedule are traced ARGUMENTS of one cached jit — a
    # tracking loop (new target every chunk) compiles once, not per call.
    positions, losses = program(starts, scene, trace_params, target_ir,
                                fa_target, key, sigmas)
    if n_sources == 1:  # keep the single-source [2]/[S, 2] API
        positions = positions[:, 0, :]
    best = jnp.argmin(losses)
    return LocalizeResult(position=positions[best], loss=losses[best],
                          positions=positions, losses=losses)


@partial(jax.jit, static_argnames=(
    "n_rays", "max_bounces", "sample_rate", "ir_length", "lr",
    "arrival_weight", "ir_weight", "gain_invariant"))
def _localize_fit(starts, scene, trace_params, target_ir, fa_target, key,
                  sigmas, *, n_rays, max_bounces, sample_rate, ir_length,
                  lr, arrival_weight, ir_weight, gain_invariant):
    """The batched multi-start fit behind :func:`localize_source`, with
    every per-call value (starts, target, schedule) as a traced argument
    so the compiled program is reused across calls."""
    import optax

    def loss_fn(srcs: jax.Array, sigma: jax.Array) -> jax.Array:
        # srcs [N, 2]: the predicted IR of N simultaneous sources is the
        # SUM of per-source IRs (propagation is linear in the emission),
        # each with its own RNG stream.
        def one(src, k):
            p = trace_params._replace(source=src)
            return simulate_ir(scene, p, k, n_rays=n_rays,
                               max_bounces=max_bounces,
                               sample_rate=sample_rate,
                               ir_length=ir_length, soft=True)

        if srcs.shape[0] == 1:
            pred = one(srcs[0], key)  # N=1 keeps the caller's exact stream
        else:
            pred = jnp.sum(
                jax.vmap(one)(srcs, jax.random.split(key, srcs.shape[0])),
                axis=0)
        l_ir = _blur_rel_l2(pred, target_ir, sigma,
                            scale_invariant=gain_invariant)
        if srcs.shape[0] > 1:
            # The target's first arrival is the min over sources — not a
            # per-source observable; trilateration only applies to N = 1.
            return ir_weight * l_ir
        d = jnp.linalg.norm(trace_params.listeners - srcs[0][None, :],
                            axis=-1)
        fa_pred = jnp.maximum(d - trace_params.listener_radius, 0.0) \
            / trace_params.speed_of_sound
        l_fa = jnp.mean(jnp.square((fa_pred - fa_target) * 1e3))  # ms^2
        return arrival_weight * l_fa + ir_weight * l_ir

    def fit_one(src0: jax.Array):
        adam = optax.adam(lr)

        def step(carry, sigma):
            src, st = carry
            value, grad = jax.value_and_grad(loss_fn)(src, sigma)
            updates, st = adam.update(grad, st)
            return (optax.apply_updates(src, updates), st), value

        (src, _), values = jax.lax.scan(step, (src0, adam.init(src0)),
                                        sigmas)
        # Score every start at the SAME final sigma so argmin compares
        # like with like.
        return src, loss_fn(src, sigmas[-1])

    return jax.vmap(fit_one)(starts)


@lru_cache(maxsize=32)
def _localize_program(n_rays, max_bounces, sample_rate, ir_length, lr,
                      arrival_weight, ir_weight, gain_invariant,
                      mesh, axis):
    """Bind :func:`_localize_fit`'s static config; wrap in ``shard_map``
    over the starts axis when a mesh is given (check_vma off: replicated
    operands mix with the sharded starts inside lax.scan — same pattern as
    parallel/sweep.py; outputs are genuinely starts-sharded). lru_cache
    keeps the returned callable — and therefore its jit cache — stable
    across calls with the same config."""
    bound = partial(_localize_fit, n_rays=n_rays, max_bounces=max_bounces,
                    sample_rate=sample_rate, ir_length=ir_length, lr=lr,
                    arrival_weight=arrival_weight, ir_weight=ir_weight,
                    gain_invariant=gain_invariant)
    if mesh is None:
        return bound
    from jax.sharding import PartitionSpec as P
    rep = P()
    return jax.jit(jax.shard_map(
        bound, mesh=mesh,
        in_specs=(P(axis), rep, rep, rep, rep, rep, rep),
        out_specs=(P(axis), P(axis)), check_vma=False))
