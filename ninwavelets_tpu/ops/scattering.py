"""Time-scattering transform (Mallat): translation-invariant spectral
features from cascaded CWT + modulus + lowpass averaging.

No reference counterpart — scattering is the standard modern feature
front-end built on exactly the machinery this engine has (two wavelet
banks and an FFT-domain lowpass), and every stage is a batched bank
multiply, an elementwise modulus or one matmul.

    U1[f1]      = |CWT(x,  bank1)[f1]|
    S1[f1]      = (phi * U1[f1]) downsampled            (order 1)
    U2[f2, f1]  = |CWT(U1[f1], bank2)[f2]|
    S2[f2, f1]  = (phi * U2[f2, f1]) downsampled        (order 2)

with ``phi`` a Gaussian lowpass at ~sfreq/(2*stride).  S1 is a blurred
scalogram (stable to time shifts up to ~stride samples); S2 recovers the
amplitude-modulation structure S1's averaging discards — the classic
discriminator between, e.g., a pure tone and the same tone tremolo'd at
8 Hz.  Second-order paths only carry energy where the modulation band of
U1[f1] reaches f2, so the meaningful paths have f2 below ~f1 (returned
mask; the full rectangle is computed — it is one batched CWT).
"""
from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .cwt import abs_from_bank

__all__ = ["scattering", "scattering_from_banks", "lowpass_spectrum"]


def lowpass_spectrum(n: int, sfreq: float, cutoff: float,
                     dtype=jnp.float32) -> jnp.ndarray:
    """(N,) Gaussian lowpass transfer function with the given -3dB-ish
    cutoff (Hz), symmetric over positive/negative FFT bins."""
    k = jnp.arange(n)
    nu = jnp.where(k < (n + 1) // 2, k, k - n) * (sfreq / n)
    # exp(-nu^2 / (2 c^2)) with c chosen so |H(cutoff)| = 1/2.
    c = cutoff / jnp.sqrt(2.0 * jnp.log(2.0))
    return jnp.exp(-0.5 * jnp.square(nu / c)).astype(dtype)


def _smooth_decimate(u: jnp.ndarray, phi: jnp.ndarray,
                     stride: int) -> jnp.ndarray:
    """Lowpass (FFT-domain multiply by ``phi``) then stride-decimate the
    trailing axis.  ``u`` is real nonnegative (a modulus plane)."""
    spec = jnp.fft.rfft(u)
    smoothed = jnp.fft.irfft(spec * phi[: spec.shape[-1]], n=u.shape[-1])
    return smoothed[..., ::stride]


@functools.lru_cache(maxsize=8)
def _smooth_decimate_operator(n: int, stride: int, sfreq: float,
                              cutoff: float):
    """(N, N//stride) matrix G of the ENTIRE smooth+decimate stage:
    lowpass-then-decimate is an LTI projection, so ``s = u @ G`` with
    ``G[j, m] = g[(m*stride - j) mod N]`` and ``g = ifft(phi)`` (real,
    symmetric).  One matmul and ONE pass over the modulus planes
    replaces rfft -> multiply -> irfft -> slice (~5 passes over device
    memory) — exactly the same circular-convolution math, built on host
    in float64.  Cached as numpy (lru_cache must never
    hold device arrays from inside a trace)."""
    k = np.arange(n)
    nu = np.where(k < (n + 1) // 2, k, k - n) * (sfreq / n)
    c = cutoff / np.sqrt(2.0 * np.log(2.0))
    phi = np.exp(-0.5 * np.square(nu / c))
    g = np.fft.ifft(phi).real
    idx = (np.arange(n // stride)[None, :] * stride
           - np.arange(n)[:, None]) % n
    return np.ascontiguousarray(g[idx], np.float32)


def scattering_from_banks(signal: jnp.ndarray, bank1: jnp.ndarray,
                          bank2: jnp.ndarray, sfreq: float,
                          stride: int = 32,
                          interpolate: bool = True,
                          lowpass: str = "auto"):
    """Order-2 time scattering: (..., N) -> (S1, S2).

    Args:
      signal: (..., N) real.
      bank1: (F1, N) first-layer bank (log-spaced frequencies recommended,
        ``ops.grids.log_freqs``).
      bank2: (F2, N) second-layer bank — its frequencies are MODULATION
        rates (typically lower, e.g. 1-64 Hz).
      stride: output downsampling; the lowpass cutoff is sfreq/(2*stride),
        so features are stable to translations up to ~stride samples.

    Returns:
      S1: (..., F1, N//stride) float32
      S2: (..., F2, F1, N//stride) float32
    """
    n = signal.shape[-1]
    cutoff = sfreq / (2.0 * stride)
    if lowpass == "auto":
        # The matmul operator needs an exact decimation grid; the FFT path
        # handles ragged strides.
        lowpass = "matmul" if n % stride == 0 else "fft"
    if lowpass == "matmul":
        if n % stride:
            raise ValueError(
                f"lowpass='matmul' needs stride | N (got N={n}, "
                f"stride={stride}) — use lowpass='fft' or 'auto'")
        # Same circular-convolution math as the FFT path, as ONE matmul
        # and one pass over the modulus planes (the second-layer
        # rfft/irfft would run over an (..., F2, F1, N) tensor).  HIGHEST
        # keeps true-f32 products; the operator is tiny (N x N/stride).
        gmat = jnp.asarray(_smooth_decimate_operator(n, int(stride),
                                                     float(sfreq),
                                                     float(cutoff)))
        smooth = lambda u: jnp.dot(u, gmat,
                                   precision=jax.lax.Precision.HIGHEST)
    else:
        phi = lowpass_spectrum(n, sfreq, cutoff)
        smooth = lambda u: _smooth_decimate(u, phi, stride)
    u1 = abs_from_bank(signal, bank1, interpolate)        # (..., F1, N)
    s1 = smooth(u1)
    # Second layer: U1 rows are real nonnegative signals; batch them all
    # through bank2 in one program.  No analytic trick here — U1 is not
    # zero-mean, and its spectrum is genuinely two-sided.
    u2 = abs_from_bank(u1, bank2, False)                  # (..., F1, F2, N)
    u2 = jnp.moveaxis(u2, -2, -3)                         # (..., F2, F1, N)
    s2 = smooth(u2)
    return s1, s2


@partial(jax.jit, static_argnames=("sfreq", "stride", "interpolate",
                                   "lowpass"))
def _scattering_jit(signal_r, bank1_r, bank2_r, *, sfreq, stride,
                    interpolate, lowpass):
    return scattering_from_banks(signal_r, bank1_r, bank2_r, sfreq, stride,
                                 interpolate, lowpass)


def scattering(signal_r, bank1_r, bank2_r, sfreq: float, stride: int = 32,
               interpolate: bool = True, lowpass: str = "auto"):
    """Jitted float-boundary wrapper for ``scattering_from_banks``
    (real banks; Normal/Twice complex banks are not meaningful here)."""
    return _scattering_jit(signal_r, bank1_r, bank2_r, sfreq=float(sfreq),
                           stride=int(stride), interpolate=interpolate,
                           lowpass=str(lowpass))
