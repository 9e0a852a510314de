"""Counter-based random number generation.

The production path uses ``jax.random`` (threefry) keys folded with the
frame counter — the reproducible, platform-independent analogue of the
reference's ``rngStateOffset = Time.frameCount`` per-frame reseeding
(``RayTraceManager.cs:197``).

For cross-checking emission/scattering *distributions* against the
reference, :func:`hlsl_random` reimplements the exact PCG-style hash the
HLSL kernels use (``Assets/Script/Common.hlsl:8-12``) on uint32 lanes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_MUL1 = jnp.uint32(747796405)
_INC = jnp.uint32(2891336453)
_MUL2 = jnp.uint32(277803737)
_U32_MAX = 4294967295.0


def hlsl_random(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One step of the reference's inout-state hash RNG.

    ``state`` is uint32 (any shape). Returns ``(value in [0, 1], new_state)``.
    Bit-exact port of ``Common.hlsl:8-12``:
        state = state * 747796405 + 2891336453
        res   = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
        value = ((res >> 22) ^ res) / 4294967295
    """
    state = state.astype(jnp.uint32)
    state = state * _MUL1 + _INC
    shift = (state >> jnp.uint32(28)) + jnp.uint32(4)
    res = ((state >> shift) ^ state) * _MUL2
    res = (res >> jnp.uint32(22)) ^ res
    return res.astype(jnp.float32) / jnp.float32(_U32_MAX), state


def ray_init_state(n_rays: int, frame: jnp.ndarray) -> jnp.ndarray:
    """Reference per-ray seed: ``id.x + rngStateOffset * 719393``
    (``Raytrace2D.compute:51``)."""
    ids = jnp.arange(n_rays, dtype=jnp.uint32)
    return ids + jnp.uint32(719393) * frame.astype(jnp.uint32)


def frame_key(base_key: jax.Array, frame: jnp.ndarray | int) -> jax.Array:
    """Per-frame key: deterministic fold-in of the frame counter, the
    functional analogue of the reference's frame-count reseed."""
    return jax.random.fold_in(base_key, frame)


def bounce_uniforms(key: jax.Array, max_bounces: int, n_rays: int,
                    n_listeners: int = 1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pre-draw every uniform the trace consumes.

    Returns ``(emit_jitter[n_rays], u[max_bounces, n_rays, 3])`` where the
    3 slots per bounce are: transmission test, refraction scatter-jitter,
    diffuse reflection angle — the same three draws the reference makes per
    bounce (``Raytrace2D.compute:129, 137, 150``). Drawing up front keeps
    the scan body free of key-splitting plumbing and lets XLA schedule the
    RNG off the critical path.
    """
    k_emit, k_bounce = jax.random.split(key)
    emit = jax.random.uniform(k_emit, (n_rays,), dtype=jnp.float32)
    u = jax.random.uniform(k_bounce, (max_bounces, n_rays, 3),
                           dtype=jnp.float32)
    return emit, u
