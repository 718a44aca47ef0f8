"""Scalogram statistics à la Torrence & Compo (1998): cone of influence,
global wavelet spectrum, and AR(1) red-noise significance levels.

No reference counterpart (the reference stops at the raw power plane);
these are the standard companions every wavelet-analysis workflow applies
to a TFR before interpreting it, formulated for this engine's
frequency-parameterized banks (T&C work in scales; here everything is a
function of the analysis frequency).

Design notes:
* significance thresholds and the background spectrum are tiny (F,)
  vectors — computed with jnp so they fuse into the same program as the
  power reduction when jitted;
* the chi-square 95% point for 2 DOF is closed-form (``-2 ln(1-p)``), so
  no scipy dependency;
* the cone of influence needs the wavelet's envelope e-folding time — a
  host-side float64 probe of the frequency-domain formula (same machinery
  as ``parallel.chunked.halo_samples``), cached per (wavelet, freq grid).
"""
from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

__all__ = [
    "ar1_coefficient", "red_noise_spectrum", "background_power",
    "significance_level", "significant_mask", "global_spectrum",
    "efolding_times", "coi_mask", "itc_pvalue", "itc_threshold",
]


def ar1_coefficient(x: np.ndarray) -> float:
    """Lag-1 autoregressive coefficient of a (host) 1-D series.

    T&C §5's red-noise fit: ``alpha = (r1 + sqrt(r2)) / 2`` from the lag-1
    and lag-2 autocorrelations (using r2 tempers the bias of a pure lag-1
    estimate for short series).  Clipped to [0, 1).
    """
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    denom = float(np.dot(x, x))
    if denom == 0.0:
        return 0.0
    r1 = float(np.dot(x[:-1], x[1:])) / denom
    r2 = float(np.dot(x[:-2], x[2:])) / denom
    alpha = (r1 + math.sqrt(max(r2, 0.0))) / 2.0
    return min(max(alpha, 0.0), 0.999999)


def red_noise_spectrum(freqs, sfreq: float, alpha: float) -> jnp.ndarray:
    """Normalized AR(1) ("red noise") power spectrum at the analysis
    frequencies (T&C eq. 16):

        P(f) = (1 - alpha^2) / (1 + alpha^2 - 2 alpha cos(2 pi f / sfreq))

    ``alpha = 0`` gives flat white noise.  Mean over frequency is ~1, so
    multiplying by the series variance gives an absolute background.
    """
    f = jnp.asarray(freqs, jnp.float32)
    a = jnp.float32(alpha)
    return (1.0 - a * a) / (1.0 + a * a
                            - 2.0 * a * jnp.cos(2.0 * jnp.pi * f / sfreq))


def _chi2_ppf_2dof(p: float) -> float:
    """Inverse CDF of chi-square with 2 DOF — closed form: -2 ln(1-p)."""
    return -2.0 * math.log(1.0 - p)


def _chi2_ppf(p: float, dof: int) -> float:
    """Inverse chi-square CDF: exact for 2 DOF; the Wilson-Hilferty cube
    approximation otherwise (relative error ~1e-3 for dof >= 4 at the
    quantiles used here) — keeps the module scipy-free."""
    if dof == 2:
        return _chi2_ppf_2dof(p)
    from statistics import NormalDist
    z = NormalDist().inv_cdf(p)
    a = 2.0 / (9.0 * dof)
    return dof * (1.0 - a + z * math.sqrt(a)) ** 3


def background_power(bank_r: jnp.ndarray, sfreq: float, alpha: float,
                     variance: float) -> jnp.ndarray:
    """Expected scalogram power (F,) of AR(1) noise through THIS bank.

    The engine's bank rows are peak-normalized (amplitude 2), not
    unit-energy, so the null level is bank-dependent:

        E|W_f[n]|^2 = (variance / N) * sum_k |B_f[k]|^2 * P_alpha(nu_k)

    with ``nu_k`` the physical FFT-bin frequencies (``P_alpha`` is even
    and sfreq-periodic, so the one-sided bin grid works for both halves).
    """
    from .grids import fft_bin_freqs
    bank = jnp.asarray(bank_r)
    n = bank.shape[-1]
    p_bins = red_noise_spectrum(fft_bin_freqs(n, sfreq), sfreq, alpha)
    return (float(variance) / n) * jnp.sum(
        jnp.square(jnp.abs(bank)) * p_bins, axis=-1)


def significance_level(bank_r: jnp.ndarray, sfreq: float, alpha: float,
                       variance: float, p: float = 0.95,
                       n_epochs: int = 1) -> jnp.ndarray:
    """Pointwise scalogram significance threshold (F,) — power above it is
    significant at level ``p`` against an AR(1) background of the given
    lag-1 coefficient and series variance (T&C eq. 18, adapted to this
    engine's bank normalization via ``background_power``).

    Analytic (complex) wavelets: each single-trial point is exponential
    (chi-square, 2 DOF); the EPOCH-MEAN power over E independent trials is
    chi-square with 2E DOF scaled by 1/(2E), so
    ``threshold = E|W|^2 * chi2_ppf(p, 2E) / (2E)`` — pass ``n_epochs``
    when gating the epoch-mean TFR (``EpochsWavelet.power`` /
    ``mean_power``), which tightens the threshold toward the mean as E
    grows.
    """
    dof = 2 * int(n_epochs)
    return background_power(bank_r, sfreq, alpha, variance) \
        * (_chi2_ppf(p, dof) / dof)


def significant_mask(power: jnp.ndarray, bank_r: jnp.ndarray, sfreq: float,
                     alpha: float, variance: float,
                     p: float = 0.95, n_epochs: int = 1) -> jnp.ndarray:
    """Boolean (..., F, N) mask of scalogram points significant at ``p``.

    ``power`` is the |cwt|^2 plane from this engine (``ops.cwt.power`` /
    the fused kernel, or the epoch MEAN with ``n_epochs`` set) computed
    with the same ``bank_r``.
    """
    thr = significance_level(bank_r, sfreq, alpha, variance, p, n_epochs)
    return jnp.asarray(power) > thr[..., :, None]


def global_spectrum(power: jnp.ndarray,
                    mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Time-averaged ("global") wavelet spectrum: mean power per frequency
    row (T&C eq. 22).  With ``mask`` (e.g. the COI mask), the average runs
    over unmasked samples only — rows fully outside the mask return 0.
    """
    power = jnp.asarray(power)
    if mask is None:
        return power.mean(axis=-1)
    m = jnp.asarray(mask, power.dtype)
    count = jnp.maximum(m.sum(axis=-1), 1.0)
    return (power * m).sum(axis=-1) / count


def efolding_times(wdef, freqs, sfreq: float) -> np.ndarray:
    """Envelope e-folding time (seconds) of each analysis wavelet — the
    COI half-width.  The time-domain envelope is probed from the
    frequency-domain formula in float64 on host (one jitted spectrum
    evaluation per probe length, like ``parallel.chunked.halo_samples``)
    and the first crossing of ``peak / e`` is returned per frequency.

    T&C give closed forms per family (e.g. sqrt(2)*s for Morlet); the
    numeric probe reproduces those and extends to every family this
    engine ships, including user-defined ones.
    """
    from ..parallel.chunked import _probe_spectrum
    from .grids import fft_bin_freqs

    freqs = np.asarray(freqs, np.float64)
    out = np.empty(freqs.shape, np.float64)
    for i, f in enumerate(freqs):
        probe_seconds = max(16.0 / f, 2.0)
        n = int(2 ** np.ceil(np.log2(sfreq * probe_seconds)))
        grid = fft_bin_freqs(n, sfreq, dtype=jnp.float32)
        sr, si = _probe_spectrum(wdef, grid, jnp.float32(f))
        spec = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
        env = np.abs(np.fft.ifft(spec))
        # Wavelet is centered at sample 0 with wrap-around tails; fold the
        # two sides to a one-sided envelope and find the first e-folding.
        half = n // 2
        one_sided = np.maximum(env[:half], env[::-1][:half])
        peak = one_sided.max()
        below = np.nonzero(one_sided <= peak / math.e)[0]
        out[i] = (below[0] if below.size else half) / sfreq
    return out


def coi_mask(n: int, sfreq: float, efold_s: np.ndarray) -> np.ndarray:
    """(F, N) boolean host mask: True inside the cone of influence (edge
    effects negligible), i.e. at least ``efold_s[f]`` seconds from both
    record edges."""
    t = np.arange(n) / sfreq
    dist = np.minimum(t, t[::-1])
    return dist[None, :] >= np.asarray(efold_s, np.float64)[:, None]


def itc_pvalue(itc, n_epochs: int):
    """Rayleigh-test p-value plane for inter-trial coherence: under the
    null of uniform phases, ``p = exp(-E * ITC^2)`` (the classic
    approximation; excellent for E >= 10).  The matching critical value
    is ``itc_threshold``.  Extension — the reference reports raw ITC
    with no inferential calibration."""
    itc = jnp.asarray(itc, jnp.float32)
    return jnp.exp(-float(n_epochs) * itc * itc)


def itc_threshold(alpha: float, n_epochs: int) -> float:
    """ITC value above which the Rayleigh p falls below ``alpha``:
    ``sqrt(-ln(alpha) / E)``."""
    return float(np.sqrt(-np.log(alpha) / float(n_epochs)))
