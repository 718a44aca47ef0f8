"""Zero-phase spectral filtering and resampling.  No reference
counterpart — the reference leaves preprocessing to mne; these are the
device-side basics (bandpass/low/high/notch, FFT resampling) so a
recording never has to leave the device between cleaning and analysis.

Design notes:
* all filters are zero-phase multiplications on the rfft grid with
  raised-cosine transitions (no FIR delay bookkeeping, no filtfilt
  double pass); inputs are reflect-padded to a power of two — the FFT's
  fastest length — and cropped back;
* ``resample`` keeps EVERY FFT length a power of two: when the target
  grid is a pow2 fraction/multiple of the padded grid (the common EEG
  decimations — 1000->250, 512->128) it is one exact spectrum
  truncation + irfft; any other ratio goes through a pow2 grid
  oversampled >= 8x the target rate followed by Catmull-Rom cubic
  interpolation at the exact output times (interpolation error is far
  below the f32 noise floor at that oversampling);
* everything is batched over leading axes and jit-cached per
  (shape, knob) key at module level.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .dwt import pow2_pad

__all__ = ["bandpass", "lowpass", "highpass", "notch", "resample"]


def _edge(d, w):
    """0 below the transition, 1 above, raised-cosine ramp inside.
    ``d`` is the (signed) distance past the cut, ``w`` the full
    transition width.  The clip must come BEFORE the sin or the "flat"
    regions ripple (hard-won: ops/cycles.py review)."""
    return 0.5 * (1.0 + jnp.sin(jnp.pi * jnp.clip(d / w, -0.5, 0.5)))


@partial(jax.jit, static_argnames=("sfreq", "f_lo", "f_hi", "trans_frac",
                                   "stop", "trans_hz"))
def _band_jit(x, *, sfreq, f_lo, f_hi, trans_frac, stop, trans_hz=None):
    n = x.shape[-1]
    xp, _ = pow2_pad(x)
    n2 = xp.shape[-1]
    f = jnp.arange(n2 // 2 + 1, dtype=jnp.float32) * (sfreq / n2)
    gain = jnp.ones_like(f)
    # transition width: proportional to the edge frequency for pass
    # filters, ABSOLUTE for the notch (a width-proportional ramp at the
    # notch's center frequency would dwarf the stop band itself)
    if f_lo is not None:
        w = trans_hz if trans_hz is not None else 2.0 * trans_frac * f_lo
        gain = gain * _edge(f - f_lo, w)
    if f_hi is not None:
        w = trans_hz if trans_hz is not None else 2.0 * trans_frac * f_hi
        gain = gain * _edge(f_hi - f, w)
    if stop:
        gain = 1.0 - gain
    y = jnp.fft.irfft(jnp.fft.rfft(xp) * gain, n=n2, axis=-1)
    return y[..., :n]


def _as32(x):
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-1] < 4:
        raise ValueError("signal too short")
    return x


def bandpass(x, sfreq: float, f_lo: float, f_hi: float,
             trans_frac: float = 0.25):
    """Zero-phase raised-cosine bandpass of (..., N) signals: unity in
    [f_lo, f_hi], cosine transitions of width ``trans_frac * edge``
    centered on each edge."""
    if not (0.0 < f_lo < f_hi):
        raise ValueError("need 0 < f_lo < f_hi")
    if f_hi >= sfreq / 2.0:
        raise ValueError("f_hi must be below Nyquist")
    return _band_jit(_as32(x), sfreq=float(sfreq), f_lo=float(f_lo),
                     f_hi=float(f_hi), trans_frac=float(trans_frac),
                     stop=False)


def lowpass(x, sfreq: float, f_hi: float, trans_frac: float = 0.25):
    """Zero-phase lowpass (see ``bandpass``)."""
    if not (0.0 < f_hi < sfreq / 2.0):
        raise ValueError("need 0 < f_hi < Nyquist")
    return _band_jit(_as32(x), sfreq=float(sfreq), f_lo=None,
                     f_hi=float(f_hi), trans_frac=float(trans_frac),
                     stop=False)


def highpass(x, sfreq: float, f_lo: float, trans_frac: float = 0.25):
    """Zero-phase highpass (see ``bandpass``)."""
    if not (0.0 < f_lo < sfreq / 2.0):
        raise ValueError("need 0 < f_lo < Nyquist")
    return _band_jit(_as32(x), sfreq=float(sfreq), f_lo=float(f_lo),
                     f_hi=None, trans_frac=float(trans_frac), stop=False)


def notch(x, sfreq: float, f0: float, width: float = 2.0,
          trans_frac: float = 0.25):
    """Zero-phase band-stop around ``f0`` (line-noise removal):
    complement of a ``width``-Hz-wide bandpass centered on ``f0``."""
    f_lo, f_hi = f0 - width / 2.0, f0 + width / 2.0
    if not (0.0 < f_lo < f_hi < sfreq / 2.0):
        raise ValueError("notch band must sit inside (0, Nyquist)")
    return _band_jit(_as32(x), sfreq=float(sfreq), f_lo=float(f_lo),
                     f_hi=float(f_hi), trans_frac=float(trans_frac),
                     stop=True, trans_hz=float(width))


@partial(jax.jit, static_argnames=("n2", "m2"))
def _fft_resample_pow2(xp, *, n2, m2):
    """Exact FFT resampling n2 -> m2 samples, both powers of two."""
    spec = jnp.fft.rfft(xp)
    k_in, k_out = n2 // 2 + 1, m2 // 2 + 1
    if m2 < n2:                                     # decimate: truncate
        spec = spec[..., :k_out]
        # halve the (new) Nyquist bin: it aliases its conjugate
        spec = spec.at[..., -1].set(spec[..., -1].real)
    else:                                           # interpolate: pad
        pad = [(0, 0)] * (spec.ndim - 1) + [(0, k_out - k_in)]
        spec = jnp.pad(spec, pad)
    return jnp.fft.irfft(spec, n=m2, axis=-1) * (m2 / n2)


@partial(jax.jit, static_argnames=("n2", "l2", "m", "ratio", "k_cut"))
def _fft_resample_any(xp, *, n2, l2, m, ratio, k_cut):
    """Arbitrary-ratio resampling: anti-alias spectrum truncation at
    the NEW Nyquist (bin ``k_cut``), pow2 oversample to l2, then
    Catmull-Rom cubic interpolation at the m exact output times.
    Without the truncation, the >new-Nyquist content survives the
    oversample and ALIASES when the interpolant is point-sampled."""
    spec = jnp.fft.rfft(xp)                         # (., n2//2+1)
    k_in = n2 // 2 + 1
    if k_cut < k_in:
        keep = (jnp.arange(k_in) < k_cut)
        spec = spec * keep
    pad = [(0, 0)] * (spec.ndim - 1) + [(0, l2 // 2 + 1 - k_in)]
    spec = jnp.pad(spec, pad)
    up = jnp.fft.irfft(spec, n=l2, axis=-1) * (l2 / n2)
    # output sample j sits at padded-grid time j/ratio, i.e. oversampled
    # index j * l2 / (n2 * ratio)
    pos = jnp.arange(m, dtype=jnp.float32) * (l2 / (n2 * ratio))
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, l2 - 1)
    t = pos - i0
    # periodic wrap, not clip: the Fourier model is circular, and a
    # clipped edge stencil diverges from it by O(1) at sample 0
    g = lambda k: jnp.take(up, jnp.mod(i0 + k, l2), axis=-1)
    pm1, p0, p1, p2 = g(-1), g(0), g(1), g(2)
    # Catmull-Rom basis
    return 0.5 * ((2.0 * p0) + (-pm1 + p1) * t
                  + (2.0 * pm1 - 5.0 * p0 + 4.0 * p1 - p2) * t * t
                  + (-pm1 + 3.0 * p0 - 3.0 * p1 + p2) * t * t * t)


def resample(x, sfreq: float, new_sfreq: float):
    """``(y, new_sfreq)`` — (..., M) resampled copy of (..., N) signals
    with ``M = round(N * new_sfreq / sfreq)``.

    Pow2 rate ratios (1000->250, 512->128, ...) are one exact spectrum
    truncation/padding; any other ratio runs through an >=8x pow2
    oversample + cubic interpolation (error well under f32 noise for
    band-limited content).  Downsampling applies the implied brick-wall
    anti-alias (spectrum truncation) — lowpass first if you want a
    softer transition.
    """
    if new_sfreq <= 0:
        raise ValueError("new_sfreq must be positive")
    x = _as32(x)
    n = x.shape[-1]
    ratio = float(new_sfreq) / float(sfreq)
    m = max(1, int(round(n * ratio)))
    xp, _ = pow2_pad(x)
    n2 = xp.shape[-1]
    m2f = n2 * ratio
    m2 = int(round(m2f))
    if abs(m2f - m2) < 1e-9 and m2 >= 2 and (m2 & (m2 - 1)) == 0:
        y = _fft_resample_pow2(xp, n2=n2, m2=m2)[..., :m]
    else:
        l2 = 1 << int(np.ceil(np.log2(max(8.0 * m2f, 16.0))))
        l2 = max(l2, n2)          # never throw away input bandwidth
        k_cut = max(1, int(np.floor(m2f / 2.0)))    # new Nyquist bin
        y = _fft_resample_any(xp, n2=n2, l2=l2, m=m, ratio=ratio,
                              k_cut=k_cut)
    return y, float(new_sfreq)
