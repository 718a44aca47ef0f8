"""Multitaper wavelet spectrograms: averaging the scalograms of the
orthogonal generalized Morse family (Olhede & Walden 2002, IEEE Trans.
Signal Process. 50:2661).

No reference counterpart — the reference computes a single-taper (order-0
Morse) scalogram whose per-pixel estimate is chi-square with 2 DOF.  The
higher orders of the SAME Morse family are mutually orthogonal wavelets
with near-identical time-frequency concentration, so the average of their
K scalograms keeps the resolution while cutting estimator variance ~1/K
(2K DOF): the wavelet analog of Thomson multitapering, and the standard
single-trial variance-reduction tool.

Layout: taper k is just F more rows of the ordinary frequency-domain
bank machinery, so the K-taper transform is ONE (K·F, N) bank through the
same jitted mean-power path as everything else —
stacked F-major, which also keeps each frequency's K rows on one shard
when the row axis is sharded over ``freq``.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .bank import WaveletDef, WaveletMode, make_fft_bank_ri
from .cwt import mean_power_from_bank, power_from_bank
from .spectra import morse_taper_spectrum

__all__ = ["morse_taper_def", "multitaper_banks",
           "multitaper_power_from_banks", "multitaper_power",
           "multitaper_mean_power", "multitaper_coherence_matrix",
           "multitaper_partial_coherence"]


@lru_cache(maxsize=None)
def morse_taper_def(b: float, r: float, order: int) -> WaveletDef:
    """WaveletDef of the order-``k`` Morse taper (cached — WaveletDef is a
    static jit key, so repeated calls must hand back one object)."""
    def tf(grid, freq=1.0):
        return morse_taper_spectrum(grid, freq, b, r, order)

    return WaveletDef(mode=WaveletMode.Reverse, trans_formula=tf,
                      params=("morse-taper", float(b), float(r),
                              int(order)))


@lru_cache(maxsize=64)
def _banks_np(freqs_key: tuple, n: int, sfreq: float, b: float, r: float,
              n_tapers: int, interpolate: bool,
              real_wave_length: float) -> np.ndarray:
    """NUMPY bank cache: synthesis runs hundreds of eager device ops
    (Laguerre recurrences), which would otherwise dominate every
    ``multitaper_mean_power`` call.  Cache numpy, never device arrays
    created inside a trace (they would leak tracers)."""
    freqs = jnp.asarray(freqs_key, jnp.float32)
    rows = []
    for k in range(int(n_tapers)):
        br, bi = make_fft_bank_ri(morse_taper_def(float(b), float(r), k),
                                  freqs, int(n), float(sfreq),
                                  bool(interpolate),
                                  float(real_wave_length))
        if bi is not None:  # pragma: no cover - Reverse-mode banks are real
            raise ValueError("Morse taper banks must be real")
        rows.append(np.asarray(br))
    return np.stack(rows, axis=1)


def multitaper_banks(freqs, n: int, sfreq: float, b: float = 17.5,
                     r: float = 3.0, n_tapers: int = 3,
                     interpolate: bool = False,
                     real_wave_length: float = 1.0) -> jnp.ndarray:
    """(F, K, n) stacked real Morse-taper banks (taper k = order k).

    F-major so a flatten to (F·K, n) keeps each frequency's tapers
    contiguous (one shard when rows shard over ``freq``).  Cached per
    (freqs, geometry) — synthesis is expensive eager work.
    """
    key = tuple(np.asarray(freqs, np.float32).tolist())
    return jnp.asarray(_banks_np(key, int(n), float(sfreq), float(b),
                                 float(r), int(n_tapers),
                                 bool(interpolate),
                                 float(real_wave_length)))


@lru_cache(maxsize=64)
def _flat_banks_dev(freqs_key: tuple, n: int, sfreq: float, b: float,
                    r: float, n_tapers: int, interpolate: bool,
                    real_wave_length: float, backend: str) -> jnp.ndarray:
    """DEVICE-resident (F·K, n) flat bank cache.  `_banks_np` already
    caches the synthesis, but a fresh ``jnp.asarray`` per call would
    re-upload the bank (~2.4 MB at the bench config) every call.  Created
    EAGERLY (outside any trace), so caching the device array is safe (an
    array made inside a jit trace would leak a tracer); keyed on the
    backend so runs on two backends in one process never share an
    entry."""
    arr = _banks_np(freqs_key, n, sfreq, b, r, n_tapers, interpolate,
                    real_wave_length)
    f, k, nn = arr.shape
    return jnp.asarray(arr.reshape(f * k, nn))


def multitaper_power_from_banks(signal: jnp.ndarray, banks: jnp.ndarray,
                                interpolate: bool = False,
                                weights=None) -> jnp.ndarray:
    """(..., F, N) multitaper power: the (weighted) mean over taper
    scalograms.  ``banks`` is the (F, K, n) stack; uniform 1/K weights by
    default (the eigenvalue spectrum of the Morse localization operator
    is nearly flat over the first few orders for b=17.5, r=3)."""
    f, k, n = banks.shape
    flat = banks.reshape(f * k, n)
    p = power_from_bank(signal, flat, interpolate)
    p = p.reshape(*p.shape[:-2], f, k, p.shape[-1])
    if weights is None:
        return jnp.mean(p, axis=-2)
    w = jnp.asarray(weights, p.dtype)
    return jnp.tensordot(p, w / jnp.sum(w), axes=[[-2], [0]])


@partial(jax.jit, static_argnames=("n_tapers", "interpolate"))
def _mt_power_jit(signal_r, flat, *, n_tapers, interpolate):
    f = flat.shape[0] // n_tapers
    return multitaper_power_from_banks(
        signal_r, flat.reshape(f, n_tapers, flat.shape[-1]), interpolate)


def multitaper_power(signal_r, freqs, sfreq: float, b: float = 17.5,
                     r: float = 3.0, n_tapers: int = 3,
                     interpolate: bool = False) -> jnp.ndarray:
    """(..., F, N) multitaper Morse power of real ``signal_r`` (float
    boundary; banks built host-side per geometry, cached on device)."""
    signal_r = jnp.asarray(signal_r, jnp.float32)
    key = tuple(np.asarray(freqs, np.float32).tolist())
    flat = _flat_banks_dev(key, int(signal_r.shape[-1]), float(sfreq),
                           float(b), float(r), int(n_tapers),
                           bool(interpolate), 1.0,
                           jax.default_backend())
    return _mt_power_jit(signal_r, flat, n_tapers=int(n_tapers),
                         interpolate=interpolate)


def multitaper_mean_power(signals_r, freqs, sfreq: float, b: float = 17.5,
                          r: float = 3.0, n_tapers: int = 3,
                          interpolate: bool = False) -> jnp.ndarray:
    """(..., F, N) epoch-mean multitaper power of (E, ..., N) signals.

    The epoch mean and the taper mean commute, so the whole estimate is
    ONE (F·K, N)-bank epoch-mean power followed by a K-group
    reshape-mean, all inside one jitted program (no eager dispatches
    between the stages; the bank stays on device, ``_flat_banks_dev``).
    """
    signals_r = jnp.asarray(signals_r, jnp.float32)
    key = tuple(np.asarray(freqs, np.float32).tolist())
    flat = _flat_banks_dev(key, int(signals_r.shape[-1]), float(sfreq),
                           float(b), float(r), int(n_tapers),
                           bool(interpolate), 1.0,
                           jax.default_backend())
    return _mt_mean_jit(signals_r, flat, n_tapers=int(n_tapers),
                        interpolate=bool(interpolate))


@partial(jax.jit, static_argnames=("n_tapers", "interpolate"))
def _mt_mean_jit(signals_r, flat, *, n_tapers, interpolate):
    p = mean_power_from_bank(signals_r, flat, interpolate)
    f = flat.shape[0] // n_tapers
    p = p.reshape(*p.shape[:-2], f, n_tapers, p.shape[-1])
    return jnp.mean(p, axis=-2)


# ---------------------------------------------------------------------------
# Multitaper cross-spectral connectivity
# ---------------------------------------------------------------------------

def _mt_pair_scan(sigs, banks, per_row, interpolate, time_range=None,
                  precision=None):
    """Stream an all-pairs statistic over the (F, K, n) taper banks:
    per frequency, the K taper scalograms FOLD INTO THE EPOCH AXIS of
    the pairwise cross-products (tapers are orthogonal estimates of the
    same local spectrum — exactly extra degrees of freedom), so each
    row hands ``per_row`` the same (sr, si) planes the single-taper
    ``connectivity.pair_matrix_scan`` epilogues consume, built from
    E * K effective samples."""
    from .cwt import analytic_spectrum
    from .connectivity import _pair_sums

    spec = analytic_spectrum(sigs, interpolate)       # (E, C, N)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])

    def row(_, bank_f):                               # (K, n)
        w = jnp.fft.ifft(spec[None] * bank_f[:, None, None, :])
        wf = w.reshape((-1,) + w.shape[2:])           # (K*E, C, N)
        return None, per_row(*_pair_sums(wf[..., n0:n1], precision))

    return lax.scan(row, None, banks)[1]


def multitaper_coherence_matrix(sigs_r, freqs, sfreq: float,
                                b: float = 17.5, r: float = 3.0,
                                n_tapers: int = 3,
                                interpolate: bool = False,
                                eps: float = 1e-12,
                                time_range=None) -> jnp.ndarray:
    """(F, C, C) all-pairs multitaper coherence of (E, C, N) epochs:
    ``|S_ab|^2 / (S_aa S_bb)`` with the cross-spectra averaged over
    epochs, TIME, and the K orthogonal Morse tapers — the
    variance-reduced estimator for low trial counts (K tapers behave
    as K extra trials; a single-epoch recording still yields a usable
    matrix, which the epoch-wise ``coherence_matrix`` cannot)."""
    sigs = jnp.asarray(sigs_r, jnp.float32)
    key = tuple(np.asarray(freqs, np.float32).tolist())
    flat = _flat_banks_dev(key, int(sigs.shape[-1]), float(sfreq),
                           float(b), float(r), int(n_tapers),
                           bool(interpolate), 1.0, jax.default_backend())
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _mt_coh_jit(sigs, flat, n_tapers=int(n_tapers),
                       interpolate=bool(interpolate), eps=float(eps),
                       time_range=tr)


@partial(jax.jit, static_argnames=("n_tapers", "interpolate", "eps",
                                   "time_range"))
def _mt_coh_jit(sigs, flat, *, n_tapers, interpolate, eps, time_range):
    f = flat.shape[0] // n_tapers
    banks = flat.reshape(f, n_tapers, flat.shape[-1])

    def per_row(sr, si):
        s_r = jnp.sum(sr, axis=-1)                    # (C, C) time sum
        s_i = jnp.sum(si, axis=-1)
        num = s_r * s_r + s_i * s_i
        p = jnp.diagonal(s_r)
        den = p[:, None] * p[None, :]
        den = jnp.maximum(den, eps * jnp.max(den))
        return num / den

    return _mt_pair_scan(sigs, banks, per_row, interpolate, time_range)


def multitaper_partial_coherence(sigs_r, freqs, sfreq: float,
                                 b: float = 17.5, r: float = 3.0,
                                 n_tapers: int = 3,
                                 interpolate: bool = False,
                                 lam: float = 1e-5,
                                 time_range=None) -> jnp.ndarray:
    """(F, C, C) multitaper PARTIAL coherence: the precision-matrix
    conditioning of ``connectivity.partial_coherence`` on the
    taper-augmented cross-spectra — K tapers multiply the effective
    sample count, so the (C, C) inverse stays well-conditioned at trial
    counts where the single-taper estimate is rank-starved (E * K *
    n_time >= C is the requirement)."""
    sigs = jnp.asarray(sigs_r, jnp.float32)
    key = tuple(np.asarray(freqs, np.float32).tolist())
    flat = _flat_banks_dev(key, int(sigs.shape[-1]), float(sfreq),
                           float(b), float(r), int(n_tapers),
                           bool(interpolate), 1.0, jax.default_backend())
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _mt_pcoh_jit(sigs, flat, n_tapers=int(n_tapers),
                        interpolate=bool(interpolate), lam=float(lam),
                        time_range=tr)


@partial(jax.jit, static_argnames=("n_tapers", "interpolate", "lam",
                                   "time_range"))
def _mt_pcoh_jit(sigs, flat, *, n_tapers, interpolate, lam, time_range):
    from .connectivity import partial_coherence_per_row
    f = flat.shape[0] // n_tapers
    banks = flat.reshape(f, n_tapers, flat.shape[-1])
    e_eff = sigs.shape[0] * n_tapers

    def per_row(sr, si):
        return partial_coherence_per_row(sr, si, e_eff, lam)

    return _mt_pair_scan(sigs, banks, per_row, interpolate, time_range,
                         precision=jax.lax.Precision.HIGHEST)
