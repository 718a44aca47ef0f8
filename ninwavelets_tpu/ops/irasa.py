"""IRASA: irregular-resampling separation of fractal and oscillatory
spectral components.

No reference counterpart — IRASA (Wen & Liu 2016) splits a power
spectrum into its 1/f^chi aperiodic ("fractal") part and the residual
oscillatory peaks: for each resampling factor ``h`` the geometric mean
``sqrt(PSD(h f) * PSD(f / h))`` leaves any power law untouched
(``h^{-chi/2} h^{chi/2} = 1``) while an oscillation's peak lands at two
mismatched frequencies and is suppressed; the median across an ``h``
set is the fractal estimate and ``PSD - fractal`` the oscillatory
residual.  Complements :mod:`.specparam` (which FITS a parametric
aperiodic model; IRASA is model-free).

Notes: literal fractional resampling changes array lengths per
``h`` (dynamic shapes), so the resampled spectra are evaluated by the
time-scaling theorem instead — ``PSD_{up h}(f) = PSD(h f)`` — as
linear interpolation on the UNIFORM Welch grid with computed gather
indices (a uniform grid needs no search, so ``jnp.interp``'s
searchsorted is avoided).  The Welch PSD itself is strided-gather frames
x Hamming x rFFT, all shape-static.

Boundaries are float-only as everywhere in this package.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["IrasaResult", "irasa", "welch_psd", "aperiodic_fit"]


class IrasaResult(NamedTuple):
    """``psd = fractal + oscillatory`` exactly, on ``freqs`` (Hz)."""
    freqs: jnp.ndarray         # (Fb,)
    psd: jnp.ndarray           # (..., Fb)
    fractal: jnp.ndarray       # (..., Fb)
    oscillatory: jnp.ndarray   # (..., Fb)


@partial(jax.jit, static_argnames=("sfreq", "nperseg"))
def welch_psd(signals, *, sfreq: float, nperseg: int = 1024):
    """(..., F) one-sided Welch PSD on the uniform grid
    ``arange(nperseg//2 + 1) * sfreq/nperseg`` — Hamming window, 50%
    overlap, density scaling (matches ``scipy.signal.welch``)."""
    x = jnp.asarray(signals, jnp.float32)
    n = x.shape[-1]
    hop = nperseg // 2
    n_seg = max((n - nperseg) // hop + 1, 1)
    idx = jnp.arange(n_seg)[:, None] * hop + jnp.arange(nperseg)[None, :]
    frames = x[..., idx]                              # (..., S, nperseg)
    frames = frames - jnp.mean(frames, -1, keepdims=True)
    win = jnp.asarray(np.hamming(nperseg), jnp.float32)
    spec = jnp.fft.rfft(frames * win)
    p = spec.real ** 2 + spec.imag ** 2
    scale = 1.0 / (sfreq * float((np.hamming(nperseg) ** 2).sum()))
    p = p * scale
    # one-sided: double everything but DC (and Nyquist for even nperseg)
    sl = [slice(None)] * (p.ndim - 1)
    p = p.at[tuple(sl) + (slice(1, -1 if nperseg % 2 == 0 else None),)] \
        .multiply(2.0)
    return jnp.mean(p, axis=-2)


def _eval_scaled(psd, scale: jnp.ndarray):
    """PSD evaluated at ``f * scale`` by linear interpolation on the
    uniform bin grid (index = bin * scale; clipped at the edges)."""
    nf = psd.shape[-1]
    pos = jnp.arange(nf, dtype=jnp.float32) * scale
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, nf - 1)
    hi = jnp.clip(lo + 1, 0, nf - 1)
    w = jnp.clip(pos - lo, 0.0, 1.0)
    return psd[..., lo] * (1.0 - w) + psd[..., hi] * w


def irasa(signals, sfreq: float, band=(1.0, 40.0),
          hset: Optional[Sequence[float]] = None,
          nperseg: int = 1024) -> IrasaResult:
    """Fractal/oscillatory split of ``(..., N)`` signals over ``band``.

    ``hset`` defaults to Wen & Liu's 1.1..1.9 (step 0.05).  The
    resampled-pair spectra come from frequency-axis scaling of ONE
    Welch PSD (see module docstring) rather than literal resampling —
    identical in the continuous limit, interpolation-error-only apart,
    and shape-static for the compiler.
    """
    if hset is None:
        hset = np.arange(1.1, 1.95, 0.05)
    hset = np.asarray(hset, np.float64)
    if np.any(hset <= 1.0):
        raise ValueError("resampling factors must be > 1")
    psd = welch_psd(signals, sfreq=float(sfreq), nperseg=int(nperseg))
    geo = []
    for h in hset:
        up = _eval_scaled(psd, jnp.float32(h))
        dn = _eval_scaled(psd, jnp.float32(1.0 / h))
        geo.append(jnp.sqrt(jnp.maximum(up * dn, 0.0)))
    fractal = jnp.median(jnp.stack(geo, 0), axis=0)
    freqs = np.arange(nperseg // 2 + 1) * (sfreq / nperseg)
    keep = (freqs >= band[0]) & (freqs <= band[1])
    if not keep.any():
        raise ValueError(f"band {band} outside the Welch grid "
                         f"(df={sfreq / nperseg:.3f}, "
                         f"fmax={freqs[-1]:.1f})")
    kidx = np.where(keep)[0]
    psd_b = psd[..., kidx]
    frac_b = fractal[..., kidx]
    return IrasaResult(jnp.asarray(freqs[kidx], jnp.float32), psd_b,
                       frac_b, psd_b - frac_b)


def aperiodic_fit(freqs, fractal):
    """(offset, exponent) of the log-log line ``log10 P = offset -
    exponent * log10 f`` OLS-fitted to the fractal component — the
    model-free counterpart of ``specparam``'s aperiodic parameters.
    Batched over leading dims of ``fractal``."""
    lf = jnp.log10(jnp.asarray(freqs, jnp.float32))
    lp = jnp.log10(jnp.maximum(jnp.asarray(fractal, jnp.float32), 1e-30))
    lfc = lf - jnp.mean(lf)
    slope = jnp.sum(lfc * (lp - jnp.mean(lp, -1, keepdims=True)), -1) \
        / jnp.sum(lfc * lfc)
    offset = jnp.mean(lp, -1) - slope * jnp.mean(lf)
    return offset, -slope
