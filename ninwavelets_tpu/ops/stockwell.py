"""Stockwell transform (S-transform; Stockwell, Mansinha & Lowe, IEEE
TSP 1996): the hybrid of the STFT and the CWT — a frequency-scaled
Gaussian window like a Morlet wavelet, but with ABSOLUTELY-referenced
phase (the phase at (f, t) is measured against e^{-i 2 pi f t} at t = 0,
not against the wavelet's own clock), which is why S-transform phase
maps read like Fourier phase and the transform integrates back to the
exact Fourier spectrum.

No reference counterpart.  Layout: identical to the CWT engine —
S(f_k, t) = ifft_nu[ X(nu + f_k) * exp(-2 pi^2 nu^2 / f_k^2) ], i.e. a
ROLLED signal spectrum times a closed-form Gaussian row, one batched
iFFT for all rows; the frequency-row gather is one take() of the
circularly-extended spectrum.  Rows at analysis frequency 0 would be
the plain mean (window collapses) and are excluded.

The exact inverse property ``mean_t S(f, t) = X(f) / N`` (the Gaussian
window has unit area in nu) is the oracle the tests gate, alongside a
literal numpy transcription.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["stockwell", "stockwell_ri", "istockwell"]


@partial(jax.jit, static_argnames=("sfreq",))
def _stockwell_jit(signal, bins, *, sfreq):
    n = signal.shape[-1]
    spec = jnp.fft.fft(signal)                         # (..., N)
    nu = jnp.fft.fftfreq(n, 1.0 / sfreq)               # (N,) Hz, fft order
    # rolled spectra: row k holds X(nu + f_k) -> gather at (j + bin_k) % N
    idx = (jnp.arange(n)[None, :] + bins[:, None]) % n  # (F, N)
    shifted = spec[..., idx]                            # (..., F, N)
    f_k = bins.astype(jnp.float32) * (sfreq / n)        # (F,) Hz
    gauss = jnp.exp(-2.0 * (jnp.pi * nu[None, :]) ** 2
                    / jnp.maximum(f_k[:, None], 1e-20) ** 2)
    st = jnp.fft.ifft(shifted * gauss, axis=-1)
    return jnp.real(st), jnp.imag(st)


def _bins(freqs, n, sfreq) -> np.ndarray:
    b = np.rint(np.asarray(freqs, np.float64) * n / sfreq).astype(np.int64)
    if np.any(b <= 0) or np.any(b >= n // 2 + 1):
        raise ValueError("analysis frequencies must round to FFT bins in "
                         "(0, Nyquist]")
    return b


def stockwell_ri(signal_r, freqs, sfreq: float):
    """S-transform of a real (..., N) signal at the given analysis
    frequencies (rounded to FFT bins): (real, imag) (..., F, N) pair
    (float program boundary).  ``abs(...)**2`` is the S-spectrogram;
    the complex phase is absolutely referenced."""
    signal_r = jnp.asarray(signal_r, jnp.float32)
    bins = _bins(freqs, signal_r.shape[-1], sfreq)
    return _stockwell_jit(signal_r, jnp.asarray(bins), sfreq=float(sfreq))


def stockwell(signal_r, freqs, sfreq: float) -> np.ndarray:
    """Complex (..., F, N) S-transform (host-assembled from the float
    pair, the package's boundary convention)."""
    r, i = stockwell_ri(signal_r, freqs, sfreq)
    return np.asarray(r) + 1j * np.asarray(i)


@partial(jax.jit, static_argnames=("n",))
def _istockwell_jit(st_r, st_i, bins, *, n):
    coef_r = jnp.mean(st_r, axis=-1) * n               # (..., F)
    coef_i = jnp.mean(st_i, axis=-1) * n
    spec_r = jnp.zeros((*st_r.shape[:-2], n)).at[..., bins].set(coef_r)
    spec_i = jnp.zeros((*st_r.shape[:-2], n)).at[..., bins].set(coef_i)
    # Hermitian completion (real signals): X(-f) = conj X(f)
    spec_r = spec_r.at[..., (n - bins) % n].set(coef_r)
    spec_i = spec_i.at[..., (n - bins) % n].set(-coef_i)
    # complex only INSIDE the compiled program
    return jnp.real(jnp.fft.ifft(spec_r + 1j * spec_i))


def istockwell(st_r, st_i, freqs, sfreq: float, n: int) -> jnp.ndarray:
    """Least-action inverse over the covered rows: time-average each row
    back to its Fourier coefficient (``mean_t S(f, t) = X(f) / N``),
    rebuild the covered part of the spectrum (Hermitian completion) and
    inverse-FFT.  Exact for signals whose energy lies entirely on the
    analyzed bins (tested); band-limited projection otherwise."""
    bins = _bins(freqs, n, sfreq)
    return _istockwell_jit(jnp.asarray(st_r), jnp.asarray(st_i),
                           jnp.asarray(bins), n=int(n))
