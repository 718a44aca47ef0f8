"""Superlets: superresolution spectral estimation by geometric bank fusion.

No reference counterpart — the fractional adaptive superlet transform
(Moca, Barzan, Nagy & Muresan, Nat. Commun. 2021) is the modern answer to
the wavelet time-frequency tradeoff: a "superlet" of order ``o`` at
frequency ``f`` is the GEOMETRIC mean of the responses of ``o`` Morlets
whose cycle counts grow ``k = 1..o``.  Short wavelets keep the time
localization, long wavelets the frequency localization, and the product
keeps the sharpest of both (a multiplicative AND across bandwidths),
beating any single fixed-cycle wavelet.

Layout: the member wavelets are just more rows of the same
frequency-domain machinery — ``O`` stacked real Morlet banks ride one
``lax.scan`` over the shared signal spectrum (one rFFT total), each order
adding a weighted log-power plane; memory stays O(F*N) regardless of
order.  The fractional/adaptive order schedule is a host-computed (O, F)
weight matrix, so the compiled program is identical for every schedule.

In this engine's Morlet convention ``sigma`` plays the cycle-count role
(relative bandwidth is ``1/sigma``), so order ``k`` uses
``sigma = k * base_sigma``.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .bank import WaveletDef, WaveletMode, make_fft_bank_ri
from .cwt import power_from_bank
from .spectra import morlet_peak_freq, morlet_spectrum, morlet_time

__all__ = ["superlet_banks", "superlet_weights",
           "superlet_power_from_banks", "superlet_power",
           "superlet_mean_power"]


@lru_cache(maxsize=None)
def _morlet_def(sigma: float) -> WaveletDef:
    """Morlet WaveletDef with ``sigma`` baked in, cached so repeated calls
    reuse one object (WaveletDef is a static jit key — fresh closures per
    call would defeat the compile cache)."""
    def tf(grid, freq=1.0):
        return morlet_spectrum(grid, freq, sigma)

    def tmf(timeline, freq=1.0):
        return morlet_time(timeline, sigma)

    def pf(freq):
        return morlet_peak_freq(freq, sigma)

    return WaveletDef(mode=WaveletMode.Both, trans_formula=tf,
                      time_formula=tmf, peak_freq=pf,
                      params=("superlet-morlet", float(sigma)))


def superlet_banks(freqs, n: int, sfreq: float, base_sigma: float = 3.0,
                   order_max: int = 8,
                   interpolate: bool = False) -> jnp.ndarray:
    """(O, F, n) stacked real Morlet banks, order k -> sigma = k*base_sigma.

    Each order's bank comes from the same jitted synthesis as every other
    family (``make_fft_bank_ri``), so geometry-identical calls hit the
    compile cache per order.
    """
    freqs = jnp.asarray(freqs, jnp.float32)
    rows = []
    for k in range(1, int(order_max) + 1):
        br, bi = make_fft_bank_ri(_morlet_def(k * float(base_sigma)),
                                  freqs, int(n), float(sfreq),
                                  bool(interpolate))
        if bi is not None:  # pragma: no cover - Morlet Both banks are real
            raise ValueError("superlet member banks must be real")
        rows.append(br)
    return jnp.stack(rows)


def superlet_weights(freqs, order_min: int = 1, order_max: int = 8,
                     adaptive: bool = True) -> np.ndarray:
    """(O, F) FASLT weight matrix (host numpy).

    The fractional order at frequency f interpolates linearly across the
    analysis range: ``a(f) = order_min + (order_max - order_min) *
    (f - f_lo) / (f_hi - f_lo)`` (Moca 2021's adaptive schedule); member k
    gets weight ``clip(a - (k - 1), 0, 1)`` — ones up to ``floor(a)``, the
    fractional remainder on the next order, zeros above — so the weighted
    geometric mean uses exactly ``a(f)`` wavelets.  ``adaptive=False``
    uses the full ``order_max`` everywhere.
    """
    f = np.asarray(freqs, np.float64)
    order_min, order_max = int(order_min), int(order_max)
    if not 1 <= order_min <= order_max:
        raise ValueError("need 1 <= order_min <= order_max")
    if adaptive and f.size > 1 and f.max() > f.min():
        a = order_min + (order_max - order_min) * (f - f.min()) \
            / (f.max() - f.min())
    else:
        a = np.full(f.shape, float(order_max))
    ks = np.arange(1, order_max + 1, dtype=np.float64)[:, None]
    return np.clip(a[None, :] - (ks - 1.0), 0.0, 1.0).astype(np.float32)


def superlet_power_from_banks(signal: jnp.ndarray, banks: jnp.ndarray,
                              weights: jnp.ndarray,
                              interpolate: bool = False,
                              eps: float = 1e-30,
                              vma_axes=()) -> jnp.ndarray:
    """Weighted geometric mean of the member powers:

        ``SLT = exp( sum_k w_k log P_k / sum_k w_k )``

    Args:
      signal: (..., N) real.
      banks: (O, F, N) stacked real banks (``superlet_banks``).
      weights: (O, F) member weights (``superlet_weights``).
      eps: power floor inside the log (a zero-response member zeroes the
        product; the floor keeps it finite).

    Returns:
      (..., F, N) float32 superlet power.
    """
    wsum = jnp.sum(weights, axis=0)                           # (F,)
    zero = jnp.zeros(signal.shape[:-1] + (banks.shape[1],
                                          signal.shape[-1]), jnp.float32)
    if vma_axes:
        # shard_map scan carries must match the body's varying-axes type.
        zero = lax.pcast(zero, tuple(vma_axes), to="varying")

    def step(acc, xs):
        bank_k, w_k = xs
        p = power_from_bank(signal, bank_k, interpolate)
        return acc + w_k[:, None] * jnp.log(jnp.maximum(p, eps)), None

    tot = lax.scan(step, zero, (banks, weights))[0]
    return jnp.exp(tot / wsum[:, None])


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _slt_jit(signal_r, banks, weights, *, interpolate, eps):
    return superlet_power_from_banks(signal_r, banks, weights, interpolate,
                                     eps)


def superlet_power(signal_r, freqs, sfreq: float, base_sigma: float = 3.0,
                   order_min: int = 1, order_max: int = 8,
                   adaptive: bool = True, interpolate: bool = False,
                   eps: float = 1e-30):
    """(..., F, N) fractional adaptive superlet power — banks and the
    FASLT weight schedule built here, fusion jitted."""
    n = signal_r.shape[-1]
    banks = superlet_banks(freqs, n, sfreq, base_sigma, order_max,
                           interpolate)
    w = jnp.asarray(superlet_weights(freqs, order_min, order_max, adaptive))
    return _slt_jit(signal_r, banks, w, interpolate=bool(interpolate),
                    eps=float(eps))


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _slt_mean_jit(signals_r, banks, weights, *, interpolate, eps):
    e = signals_r.shape[0]
    zero = jnp.zeros(signals_r.shape[1:-1] + (banks.shape[1],
                                              signals_r.shape[-1]),
                     jnp.float32)

    def step(acc, sig):
        return acc + superlet_power_from_banks(sig, banks, weights,
                                               interpolate, eps), None

    return lax.scan(step, zero, signals_r)[0] / e


def superlet_mean_power(signals_r, freqs, sfreq: float,
                        base_sigma: float = 3.0, order_min: int = 1,
                        order_max: int = 8, adaptive: bool = True,
                        interpolate: bool = False, eps: float = 1e-30):
    """(..., F, N) epoch-mean superlet power: (E, ..., N) epochs stream
    through a scan (O(F*N) accumulator), each epoch's SLT plane averaged
    — the epochs convention of ``ops.cwt.mean_power`` applied to the
    superresolution estimator."""
    n = signals_r.shape[-1]
    banks = superlet_banks(freqs, n, sfreq, base_sigma, order_max,
                           interpolate)
    w = jnp.asarray(superlet_weights(freqs, order_min, order_max, adaptive))
    return _slt_mean_jit(signals_r, banks, w,
                         interpolate=bool(interpolate), eps=float(eps))
