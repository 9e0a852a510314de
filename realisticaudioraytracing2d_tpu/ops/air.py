"""Atmospheric absorption (ISO 9613-1) for traced impulse responses.

The reference's propagation model loses energy only at wall interactions
and by inverse-square spreading (``Raytrace2D.compute:78,110``); the air
itself is lossless, which overstates high-frequency reverb in large
rooms (Big Room's 400 m paths would really lose ~40 dB at 10 kHz). This
module adds the standard atmospheric model as a *post-pass* on the IR:

* :func:`iso9613_alpha` — the pure-tone attenuation coefficient
  ``alpha(f)`` in dB/m from ISO 9613-1 (O2/N2 relaxation + classical
  absorption) given temperature, relative humidity, and pressure.
* :func:`apply_air_absorption` — attenuate each IR time bin by
  ``10^(-alpha * c * t / 10)`` (energy bins, so 10·log10). A hit's bin
  delay *is* its path time, so this equals per-path attenuation exactly
  (up to bin quantization, and up to media where the local sound speed
  differs from ``c`` — inside refractive obstacles the air model is
  nominal anyway). Because it never touches the trace, it composes with
  any traced IR, including already-accumulated or checkpointed ones.
* :func:`band_frequencies` — log-spaced band centers for mapping the
  scene's abstract ``n_bands`` axis onto physical frequencies.
"""

from __future__ import annotations

import numpy as np

# ISO 9613-1 reference conditions.
_T0 = 293.15      # K (20 C)
_T01 = 273.16     # K (triple point)
_PR = 101.325     # kPa


def iso9613_alpha(freqs_hz, temperature_c: float = 20.0,
                  rel_humidity: float = 50.0,
                  pressure_kpa: float = _PR) -> np.ndarray:
    """Pure-tone atmospheric attenuation coefficient in dB/m.

    ISO 9613-1 section 6.2: classical (viscous/thermal) absorption plus
    the O2 and N2 vibrational-relaxation terms, with relaxation
    frequencies set by the water-vapor molar concentration. Valid for
    50 Hz..10 MHz, -20..50 C, and the humidity/pressure ranges of the
    standard. ``alpha`` attenuates sound pressure LEVEL: intensity (our
    IR bins) scales by ``10^(-alpha * d / 10)`` over distance ``d``.
    """
    f = np.asarray(freqs_hz, np.float64)
    t = temperature_c + 273.15
    pa = pressure_kpa / _PR           # normalized pressure
    tr = t / _T0                      # normalized temperature

    # Water-vapor molar concentration h (%): saturation pressure ratio
    # from the standard's magnus-style fit.
    psat_over_pr = 10.0 ** (-6.8346 * (_T01 / t) ** 1.261 + 4.6151)
    h = rel_humidity * psat_over_pr / pa

    # Relaxation frequencies of O2 and N2 (Hz).
    fr_o = pa * (24.0 + 4.04e4 * h * (0.02 + h) / (0.391 + h))
    fr_n = pa / np.sqrt(tr) * (
        9.0 + 280.0 * h * np.exp(-4.170 * (tr ** (-1.0 / 3.0) - 1.0)))

    alpha = 8.686 * f * f * (
        1.84e-11 / pa * np.sqrt(tr)
        + tr ** (-2.5) * (
            0.01275 * np.exp(-2239.1 / t) / (fr_o + f * f / fr_o)
            + 0.1068 * np.exp(-3352.0 / t) / (fr_n + f * f / fr_n)))
    return alpha


def band_frequencies(n_bands: int, f_min: float = 125.0,
                     f_max: float = 16000.0) -> np.ndarray:
    """Log-spaced center frequencies mapping the scene's abstract band
    axis to physical bands; a single band sits at the geometric mean
    (~1.4 kHz for the defaults, the broadband reference point)."""
    if n_bands == 1:
        return np.array([np.sqrt(f_min * f_max)])
    return np.geomspace(f_min, f_max, n_bands)


def air_attenuation_curve(ir_length: int, sample_rate: int,
                          alpha_db_per_m, speed_of_sound: float = 343.0):
    """Per-bin energy attenuation factors ``[T, K]`` for
    :func:`apply_air_absorption` (exposed for tests/inspection)."""
    import jax.numpy as jnp

    alpha = jnp.atleast_1d(jnp.asarray(alpha_db_per_m, jnp.float32))
    t = jnp.arange(ir_length, dtype=jnp.float32) / sample_rate
    dist = t * speed_of_sound                             # [T]
    return 10.0 ** (-dist[:, None] * alpha[None, :] / 10.0)


def apply_air_absorption(ir, sample_rate: int, alpha_db_per_m,
                         speed_of_sound: float = 343.0):
    """Attenuate an energy IR ``[..., T, K]`` by atmospheric absorption.

    ``alpha_db_per_m`` is scalar or per-band ``[K]`` (e.g. from
    :func:`iso9613_alpha` at :func:`band_frequencies`). Linear in the
    IR, so applying it to an accumulated ``IRState.sum`` or a normalized
    IR is equivalent.
    """
    import jax.numpy as jnp

    x = jnp.asarray(ir)
    att = air_attenuation_curve(x.shape[-2], sample_rate, alpha_db_per_m,
                                speed_of_sound)
    if att.shape[-1] not in (1, x.shape[-1]):
        raise ValueError(f"alpha has {att.shape[-1]} bands, IR has "
                         f"{x.shape[-1]}")
    return x * att
