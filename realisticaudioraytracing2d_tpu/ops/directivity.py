"""Source directivity patterns (angular emission weighting).

The reference's source radiates omnidirectionally — emission picks a
stratified angle and every ray starts with the same energy
(``Raytrace2D.compute:52,59``). Real sources (voices, speakers,
instruments) do not. This module adds directivity as a **power gain over
emission angle**, represented as a truncated Fourier series

``g(theta) = c[0] + sum_n c[2n-1] cos(n theta) + c[2n] sin(n theta)``

clamped at zero. The representation is a plain ``[2M+1]`` float array —
a *traced* quantity, so rotating a source (e.g. chunk by chunk while
streaming) recompiles nothing.

Because IR deposits are linear in a ray's initial energy, weighting
emission by ``g`` is exact: every path from ray ``r`` scales by
``g(theta_r)``. The weighting lives in the trace's emission
(:func:`..trace._emit`) and at both capture sites (microphone patterns).

Presets return exact coefficients; :func:`from_function` projects any
callable pattern onto ``n_harmonics`` via FFT. ``mean power = c[0]``,
so patterns with ``c[0] = 1`` radiate the same total energy as an omni
source (the presets are normalized this way).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import jax.numpy as jnp


def evaluate(coeffs: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Power gain ``g(angle)`` (>= 0).

    ``coeffs`` is ``[2M+1]`` (one pattern) or ``[..., 2M+1]`` (batched —
    e.g. one pattern per listener); the coefficient batch dims broadcast
    against ``angle``'s shape (a ``[L, C]`` table against ``[R, L]``
    angles yields ``[R, L]`` gains)."""
    c = jnp.asarray(coeffs, jnp.float32)
    angle = jnp.asarray(angle, jnp.float32)
    g = jnp.broadcast_to(c[..., 0], jnp.broadcast_shapes(
        c[..., 0].shape, angle.shape)).astype(jnp.float32)
    m = (c.shape[-1] - 1) // 2
    for n in range(1, m + 1):
        g = g + c[..., 2 * n - 1] * jnp.cos(n * angle) \
              + c[..., 2 * n] * jnp.sin(n * angle)
    return jnp.maximum(g, 0.0)


def omni() -> np.ndarray:
    return np.array([1.0], np.float32)


def cardioid(aim: float = 0.0) -> np.ndarray:
    """Cardioid power pattern aimed at ``aim`` (radians):
    ``g = 1 + cos(theta - aim)`` — exact two-harmonic series, mean 1."""
    return np.array([1.0, np.cos(aim), np.sin(aim)], np.float32)


def figure_eight(aim: float = 0.0) -> np.ndarray:
    """Figure-of-eight power pattern ``g = 2 cos^2(theta - aim)``
    (nulls perpendicular to ``aim``), mean 1."""
    return np.array([1.0, 0.0, 0.0,
                     np.cos(2 * aim), np.sin(2 * aim)], np.float32)


def from_function(fn: Callable[[np.ndarray], np.ndarray],
                  n_harmonics: int = 8, normalize: bool = True,
                  resolution: int = 4096) -> np.ndarray:
    """Project an arbitrary power pattern ``fn(theta) -> gain`` onto the
    first ``n_harmonics`` Fourier harmonics (FFT on a fine grid).
    ``normalize`` rescales so the mean power (c[0]) is 1."""
    theta = np.linspace(0.0, 2.0 * np.pi, resolution, endpoint=False)
    g = np.asarray(fn(theta), np.float64)
    if np.any(g < 0):
        raise ValueError("power pattern must be non-negative")
    spec = np.fft.rfft(g) / resolution
    c = np.empty(2 * n_harmonics + 1, np.float64)
    c[0] = spec[0].real
    for n in range(1, n_harmonics + 1):
        c[2 * n - 1] = 2.0 * spec[n].real
        c[2 * n] = -2.0 * spec[n].imag
    if normalize:
        if c[0] <= 0:
            raise ValueError("pattern has zero mean power")
        c = c / c[0]
    return c.astype(np.float32)
