"""Closed-form wavelet spectra and time-domain formulas as pure jnp functions.

Each function is the on-device equivalent of one reference formula
(``/root/reference/ninwavelets/wavelets.py``), written to be stable in
float32: the Generalized Morse spectrum is evaluated in log-space because
``omega ** beta`` overflows float32 at ``omega > ~148`` for ``beta = 17.5``
while the float64 reference survives on range alone.

All functions broadcast over their first argument and are safe under
``jax.vmap`` over the analysis frequency, which is how the (F, N) bank is
synthesized on device in one shot.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

_PI_M14 = math.pi ** (-0.25)


# ----------------------------------------------------------------------------
# Generalized Morse (reference: wavelets.py:65-74, mode=Reverse)
# ----------------------------------------------------------------------------

def morse_spectrum(freq_grid: jnp.ndarray, freq, b: float = 17.5,
                   r: float = 3.0) -> jnp.ndarray:
    """``2 * H(w) * w**b * exp((b/r) * (1 - w**r))`` with ``w = grid / freq``.

    Peak-normalized form (amplitude 2 at w == 1), matching the reference's
    non-textbook normalization exactly (wavelets.py:71-74).  Evaluated as
    ``2 * exp(b*log(w) + (b/r)*(1 - w**r))`` so float32 never sees the
    intermediate ``w**b`` overflow; ``w <= 0`` maps to 0 (Heaviside with
    H(0) = 0, as ``np.heaviside(w, w)`` gives at the origin).
    """
    w = freq_grid / jnp.asarray(freq, freq_grid.dtype)
    b = float(b)
    r = float(r)
    safe_w = jnp.where(w > 0, w, 1.0)
    log_mag = b * jnp.log(safe_w) + (b / r) * (1.0 - safe_w ** r)
    return jnp.where(w > 0, 2.0 * jnp.exp(log_mag), 0.0)


def morse_taper_spectrum(freq_grid: jnp.ndarray, freq, b: float = 17.5,
                         r: float = 3.0, order: int = 0) -> jnp.ndarray:
    """Order-``k`` generalized Morse wavelet (Olhede & Walden 2002) in the
    engine's Morse convention: the ``order`` orthogonal companions of the
    reference Morse multiply it by a generalized Laguerre polynomial,

        M_k(w) = 2 rho_k * w**b * exp((b/r)(1 - w**r)) * L_k^c(2(b/r)w**r)

    with ``c = (2b+1)/r - 1`` and ``rho_k = sqrt(k! Gamma(c+1) /
    Gamma(k+c+1))`` the energy-equalizing ratio of the Olhede-Walden
    unit-energy constants.  ``order=0`` reproduces ``morse_spectrum``
    exactly; distinct orders are mutually L2-orthogonal on the half line
    (eigenfunctions of the same time-frequency localization operator), so
    averaging their scalograms is the wavelet analog of multitapering.

    Evaluated with the Laguerre three-term recurrence after damping: the
    recurrence argument is zeroed wherever the log-magnitude has already
    underflowed (< -60 nats) so the polynomial can never overflow float32
    in a region whose output is 0 anyway.
    """
    k = int(order)
    if k == 0:
        return morse_spectrum(freq_grid, freq, b, r)
    b = float(b)
    r = float(r)
    c = (2.0 * b + 1.0) / r - 1.0
    log_rho = 0.5 * (math.lgamma(k + 1.0) + math.lgamma(c + 1.0)
                     - math.lgamma(k + c + 1.0))
    w = freq_grid / jnp.asarray(freq, freq_grid.dtype)
    safe_w = jnp.where(w > 0, w, 1.0)
    log_mag = b * jnp.log(safe_w) + (b / r) * (1.0 - safe_w ** r) + log_rho
    live = (w > 0) & (log_mag > -60.0)
    x = jnp.where(live, 2.0 * (b / r) * safe_w ** r, 0.0)
    prev, cur = jnp.ones_like(x), 1.0 + c - x
    for m in range(2, k + 1):
        prev, cur = cur, ((2 * m - 1 + c - x) * cur
                          - (m - 1 + c) * prev) / m
    lag = cur
    return jnp.where(live, 2.0 * jnp.exp(log_mag) * lag, 0.0)


# ----------------------------------------------------------------------------
# Morlet / Gabor (reference: wavelets.py:110-144, mode=Both)
# ----------------------------------------------------------------------------

def morlet_norm_constants(sigma: float, gabor: bool = False):
    """The reference's ``c`` and ``k`` (wavelets.py:118-122).

    Note the quirk kept for parity: ``c`` uses ``exp(-sigma**2)`` (not the
    textbook ``exp(-sigma**2 / 2)`` that the reference README shows) —
    wavelets.py:118-121 wins over README.md:402-405.
    """
    sigma = float(sigma)
    c = (1.0 + math.exp(-sigma * sigma)
         - 2.0 * math.exp(-0.75 * sigma * sigma)) ** (-0.5)
    k = 0.0 if gabor else math.exp(-(sigma ** 2) / 2.0)
    return c, k


def morlet_peak_freq(freq, sigma: float):
    """``sigma / (1 - exp(-sigma * freq))`` (wavelets.py:143-144)."""
    sigma = float(sigma)
    return sigma / (1.0 - jnp.exp(-sigma * jnp.asarray(freq, jnp.float32)))


def morlet_spectrum(freq_grid: jnp.ndarray, freq, sigma: float = 7.0,
                    gabor: bool = False) -> jnp.ndarray:
    """Frequency-domain Morlet (wavelets.py:132-136):
    ``c * pi**(-1/4) * (exp(-(sigma - s)**2 / 2) - k * exp(-s**2 / 2))``
    with ``s = grid / freq * peak_freq(freq)``.
    """
    c, k = morlet_norm_constants(sigma, gabor)
    s = freq_grid / jnp.asarray(freq, freq_grid.dtype) * morlet_peak_freq(freq, sigma)
    sigma = float(sigma)
    out = jnp.exp(-0.5 * jnp.square(sigma - s))
    if k != 0.0:
        out = out - k * jnp.exp(-0.5 * jnp.square(s))
    return (c * _PI_M14) * out


def morlet_time(timeline: jnp.ndarray, sigma: float = 7.0,
                gabor: bool = False) -> jnp.ndarray:
    """Time-domain Morlet (wavelets.py:138-141):
    ``c * pi**(-1/4) * exp(-t**2/2) * (exp(i*sigma*t) - k)``.
    """
    c, k = morlet_norm_constants(sigma, gabor)
    sigma = float(sigma)
    envelope = jnp.exp(-0.5 * jnp.square(timeline))
    carrier = jnp.exp(1j * sigma * timeline.astype(jnp.complex64))
    return (c * _PI_M14) * envelope * (carrier - k)


# ----------------------------------------------------------------------------
# Mexican hat (reference: wavelets.py:219-228, mode=Normal)
# ----------------------------------------------------------------------------

MEXICAN_HAT_PEAK_FREQ = math.sqrt(6.0) / (math.pi * math.pi)


def mexican_hat_time(timeline: jnp.ndarray, sigma: float = 7.0) -> jnp.ndarray:
    """``(1 - (t/sigma)**2) * exp(-t**2 / sigma**2 / 2)`` (wavelets.py:219-221).

    Real-valued (the reference's Normal-mode wavelets are real arrays).
    """
    sigma = float(sigma)
    tc = timeline / sigma
    return (1.0 - jnp.square(tc)) * jnp.exp(-0.5 * jnp.square(tc))


# ----------------------------------------------------------------------------
# Shannon (reference: wavelets.py:256-262, mode=Reverse)
# ----------------------------------------------------------------------------

def shannon_spectrum(freq_grid: jnp.ndarray, freq=1.0) -> jnp.ndarray:
    """Brick-wall on the *grid values*, not physical Hz — the reference
    ignores its ``freq`` argument entirely and passes the raw grid
    (wavelets.py:256-262).  Kept as-is for coefficient parity; the grid value
    at FFT bin i is ``i * sfreq / n`` Hz, so only bins at <= 1 "grid unit"
    pass.
    """
    del freq  # parity quirk: the reference never uses it
    return (freq_grid <= 1.0).astype(freq_grid.dtype)


# ----------------------------------------------------------------------------
# Haar (reference: wavelets.py:272-280, mode=Normal)
# ----------------------------------------------------------------------------

def haar_time(timeline: jnp.ndarray) -> jnp.ndarray:
    """Step function: +1 on (0, 1], -1 on (-1, 0], 0 elsewhere
    (wavelets.py:272-280, loop replaced by a fused select).
    """
    t = timeline
    pos = (t > 0.0) & (t <= 1.0)
    neg = (t > -1.0) & (t <= 0.0)
    return jnp.where(pos, 1.0, jnp.where(neg, -1.0, 0.0)).astype(t.dtype)
