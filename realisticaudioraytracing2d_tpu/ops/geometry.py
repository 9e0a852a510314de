"""L0 geometry primitives: ray-segment / ray-circle intersection, reflection,
refraction, rotation.

Behavioral spec comes from the reference's HLSL math library
(``Assets/Script/Common.hlsl:14-43``), re-expressed as pure, fully
broadcastable jax.numpy functions. Nothing here loops: the pairwise forms
are written as outer-product style broadcasts so XLA can fuse them into a
single elementwise pass over [rays, walls] feeding the min reductions.

Conventions
-----------
* Points and directions are float32 arrays whose last axis is 2 (x, y).
* "Missing" intersections return ``INF`` (1e8), exactly like the reference,
  so min-reductions need no special casing.
* All functions are total: denominators are guarded, so no NaN/Inf leaks
  into gradients or min-reductions even for degenerate inputs.
"""

from __future__ import annotations

import jax.numpy as jnp

# Constants match Common.hlsl:4-6.
EPS = 1e-4
INF = 1e8
PI = 3.14159265


def perp(d: jnp.ndarray) -> jnp.ndarray:
    """90-degree counter-clockwise rotation: (x, y) -> (-y, x)."""
    return jnp.stack([-d[..., 1], d[..., 0]], axis=-1)


def dot2(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]


def cross2(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """z-component of the 2D cross product."""
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def rotate(v: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Rotate 2D vectors by ``angle`` radians (broadcasts over leading dims)."""
    s, c = jnp.sin(angle), jnp.cos(angle)
    return jnp.stack(
        [v[..., 0] * c - v[..., 1] * s, v[..., 0] * s + v[..., 1] * c],
        axis=-1,
    )


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize; zero vectors stay zero."""
    n2 = dot2(v, v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return v * inv[..., None]


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """HLSL ``reflect``: d - 2*dot(d, n)*n."""
    return d - 2.0 * dot2(d, n)[..., None] * n


def ray_segment_intersect(o: jnp.ndarray, d: jnp.ndarray,
                          a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Parametric distance along ray ``o + t*d`` to segment ``[a, b]``.

    Returns ``t`` when ``t >= EPS`` and the segment parameter lies in [0, 1];
    otherwise ``INF``. Matches ``Common.hlsl:14-21`` (perpendicular method),
    including the near-parallel ``|dot| < eps -> INF`` early-out.
    Broadcasts over any leading dims shared by the four operands.
    """
    v1 = o - a
    v2 = b - a
    v3 = perp(d)
    dotp = dot2(v2, v3)
    safe = jnp.where(jnp.abs(dotp) < EPS, 1.0, dotp)
    t1 = cross2(v2, v1) / safe
    t2 = dot2(v1, v3) / safe
    valid = (jnp.abs(dotp) >= EPS) & (t1 >= EPS) & (t2 >= 0.0) & (t2 <= 1.0)
    return jnp.where(valid, t1, INF)


def pairwise_ray_segment_t(o: jnp.ndarray, d: jnp.ndarray,
                           a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs ray-segment distances: rays ``[R, 2]`` x segments ``[W, 2]``
    -> ``t[R, W]``.

    Same math as :func:`ray_segment_intersect` but decomposed into rank-1
    outer products so the only [R, W]-shaped tensors are scalar fields
    (never [R, W, 2] vectors); XLA fuses the whole thing into one
    elementwise pass. This is the hot inner computation of the trace loop
    (reference hot loop: ``Raytrace2D.compute:69-72``).
    """
    ox, oy = o[..., 0:1], o[..., 1:2]          # [R, 1]
    dx, dy = d[..., 0:1], d[..., 1:2]          # [R, 1]
    ax, ay = a[..., 0], a[..., 1]              # [W]
    v2x = b[..., 0] - ax                        # [W]
    v2y = b[..., 1] - ay                        # [W]

    # dotp = v2 . perp(d) = v2x*(-dy) + v2y*dx                       [R, W]
    dotp = v2y * dx - v2x * dy
    safe = jnp.where(jnp.abs(dotp) < EPS, 1.0, dotp)

    # cross(v2, v1) = v2x*(oy - ay) - v2y*(ox - ax)
    #              = (v2x*oy - v2y*ox) - (v2x*ay - v2y*ax)           [R, W]
    cross_const = v2x * ay - v2y * ax           # [W]
    t1 = (v2x * oy - v2y * ox - cross_const) / safe

    # dot(v1, v3) = (o - a) . perp(d) = (oy*dx - ox*dy) - (ay*dx - ax*dy)
    t2 = ((oy * dx - ox * dy) - (ay * dx - ax * dy)) / safe

    valid = (jnp.abs(dotp) >= EPS) & (t1 >= EPS) & (t2 >= 0.0) & (t2 <= 1.0)
    return jnp.where(valid, t1, INF)


def ray_circle_intersect(o: jnp.ndarray, d: jnp.ndarray,
                         center: jnp.ndarray,
                         radius: jnp.ndarray) -> jnp.ndarray:
    """Nearest positive distance along ray to a circle, else ``INF``.

    Matches ``Common.hlsl:23-36``: behind-ray (tca < 0) and miss (d2 > r2)
    return INF; entry point ``t0`` preferred when > EPS, else exit ``t1``.
    Broadcasts over leading dims (e.g. rays x listeners).
    """
    L = center - o
    tca = dot2(L, d)
    d2 = dot2(L, L) - tca * tca
    r2 = radius * radius
    inside = (tca >= 0.0) & (d2 <= r2)
    # Double-where keeps reverse-mode AD finite: wherever sqrt would be
    # evaluated at exactly 0 — misses (d2 > r2, where the old clamp pinned
    # it to 0) AND exact float32 tangency (d2 == r2) — its backward is inf,
    # and the masked result downstream turns that into inf * 0 = NaN (hit
    # by diff.py's scattering gradients). Feed sqrt a safe positive
    # argument on every branch whose value is discarded; forward values
    # are bit-identical (tangent hits still get thc = 0).
    pos = (r2 - d2) > 0.0
    disc = jnp.where(inside & pos, r2 - d2, 1.0)
    thc = jnp.where(inside & pos, jnp.sqrt(disc), 0.0)
    t0 = tca - thc
    t1 = tca + thc
    t = jnp.where(t0 > EPS, t0, jnp.where(t1 > EPS, t1, INF))
    return jnp.where(inside, t, INF)


def refract(i: jnp.ndarray, n: jnp.ndarray,
            eta: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Snell refraction of direction ``i`` across normal ``n`` with relative
    index ``eta`` (= next_speed / cur_speed in the acoustic analogy).

    Returns ``(t, ok)`` where ``ok`` is False on total internal reflection
    and ``t`` is the zero vector there — mirroring ``Common.hlsl:38-43``
    which returns ``t * (cost2 > 0)``.
    """
    cosi = -dot2(i, n)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    ok = cost2 > 0.0
    t = eta[..., None] * i + (eta * cosi -
                              jnp.sqrt(jnp.abs(cost2)))[..., None] * n
    return t * ok[..., None].astype(t.dtype), ok


def nearest_hit(t: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reduce pairwise distances ``t[..., W]`` to (closest[...], index[...]).

    Index is -1 when nothing was hit (all INF), matching the reference's
    ``hitIdx == -1`` miss sentinel (``Raytrace2D.compute:67-71``).
    """
    closest = jnp.min(t, axis=-1)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    return closest, jnp.where(closest >= INF, jnp.int32(-1), idx)
