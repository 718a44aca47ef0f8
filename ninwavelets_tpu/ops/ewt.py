"""Empirical Wavelet Transform (Gilles, IEEE TSP 2013): a data-adaptive
tight-frame filterbank — detect the signal's own spectral supports, build
Meyer-style wavelets on those boundaries, and extract one mode per band.

No reference counterpart.  The EWT is the principled alternative to
empirical mode decomposition: same goal (separate a multicomponent signal
into oscillatory modes) but with an explicit filterbank, a tight-frame
guarantee (exact reconstruction by summation) and none of EMD's sifting
heuristics.

Design notes:
* boundary detection is tiny, data-dependent host work (numpy peak
  picking on the magnitude spectrum) — exactly the kind of control flow
  that should NOT be traced;
* the filterbank and the transform are one compiled program: (M, K)
  filters built from closed-form Meyer transitions on the rfft grid,
  applied as ``irfft(filters**2 * rfft(x))`` (analysis + synthesis per
  band) — M modes from ONE forward FFT.  The frame is tight (sin^2 +
  cos^2 transitions), so ``modes.sum(0) == x`` to float precision,
  which the tests gate.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ewt", "ewt_boundaries", "ewt_filterbank",
           "ewt_reconstruct"]


def ewt_boundaries(signal: np.ndarray, sfreq: float, n_modes: int,
                   smooth: int = 0) -> np.ndarray:
    """(n_modes - 1,) spectral boundaries (Hz) by Gilles' "localmax"
    rule: the ``n_modes`` largest local maxima of the (optionally
    boxcar-smoothed) one-sided magnitude spectrum define the bands; the
    boundaries sit at the midpoints between consecutive peaks, so every
    band holds exactly one dominant component.
    """
    x = np.asarray(signal, np.float64).ravel()
    mag = np.abs(np.fft.rfft(x))
    if smooth > 1:
        kern = np.ones(smooth) / smooth
        mag = np.convolve(mag, kern, mode="same")
    n_modes = int(n_modes)
    if n_modes < 2:
        raise ValueError("need at least 2 modes")
    interior = mag[1:-1]
    is_max = (interior > mag[:-2]) & (interior >= mag[2:])
    idx = np.nonzero(is_max)[0] + 1
    if idx.size < n_modes:
        raise ValueError(
            f"spectrum has only {idx.size} local maxima; "
            f"cannot split into {n_modes} modes")
    top = np.sort(idx[np.argsort(mag[idx])[::-1][: n_modes]])
    bounds = 0.5 * (top[:-1] + top[1:])
    freqs = bounds * sfreq / x.size
    return np.asarray(freqs, np.float64)


def ewt_filterbank(boundaries_hz, n: int, sfreq: float,
                   gamma: float | None = None) -> jnp.ndarray:
    """(M, n//2 + 1) Meyer-style tight-frame filters on the rfft grid for
    ``M = len(boundaries) + 1`` bands: one scaling (lowpass) filter up to
    the first boundary, bandpass wavelets between consecutive boundaries,
    and a final highpass up to Nyquist.

    ``gamma`` is the relative transition half-width; it must satisfy
    ``gamma < min (w2 - w1) / (w2 + w1)`` over adjacent boundaries for
    the frame to be tight (default: half that bound).  The transition
    uses Meyer's beta polynomial, so squared filters sum to exactly 1
    everywhere — summation reconstructs the signal.
    """
    b = np.sort(np.asarray(boundaries_hz, np.float64))
    if b.size == 0 or b[0] <= 0 or b[-1] >= sfreq / 2:
        raise ValueError("boundaries must lie strictly inside "
                         "(0, sfreq/2)")
    w = np.pi * b / (sfreq / 2.0)             # normalized to (0, pi)
    edges = np.concatenate([w, [np.pi]])
    ratios = (edges[1:] - edges[:-1]) / (edges[1:] + edges[:-1])
    gmax = float(min(ratios.min(), w[0] / np.pi))
    if gamma is None:
        gamma = 0.5 * gmax
    if not 0 < gamma < gmax:
        raise ValueError(f"gamma must be in (0, {gmax:.4f}) for a tight "
                         f"frame, got {gamma}")
    k = n // 2 + 1
    omega = np.pi * np.arange(k) / (n / 2.0)  # rfft bins on [0, pi]

    def beta(x):
        x = np.clip(x, 0.0, 1.0)
        return x ** 4 * (35 - 84 * x + 70 * x ** 2 - 20 * x ** 3)

    def lo_edge(wm):                          # rising sin transition
        return np.sin(0.5 * np.pi * beta(
            (omega - (1 - gamma) * wm) / (2 * gamma * wm)))

    def hi_edge(wm):                          # falling cos transition
        return np.cos(0.5 * np.pi * beta(
            (omega - (1 - gamma) * wm) / (2 * gamma * wm)))

    filters = []
    # scaling function: flat to (1-g)w1, cos roll-off
    phi = np.where(omega <= (1 - gamma) * w[0], 1.0, hi_edge(w[0]))
    phi = np.where(omega >= (1 + gamma) * w[0], 0.0, phi)
    filters.append(phi)
    for m in range(len(w)):
        lo = w[m]
        hi = edges[m + 1]
        f = np.ones(k)
        f = np.where(omega < (1 - gamma) * lo, 0.0,
                     np.where(omega <= (1 + gamma) * lo, lo_edge(lo), f))
        if hi < np.pi:                        # last band keeps Nyquist
            f = np.where(omega > (1 + gamma) * hi, 0.0,
                         np.where(omega >= (1 - gamma) * hi, hi_edge(hi),
                                  f))
        filters.append(f)
    return jnp.asarray(np.stack(filters), jnp.float32)


@partial(jax.jit, static_argnames=())
def _ewt_apply(signal, filters):
    # modes through the SQUARED filters = one analysis+synthesis round
    # trip per band: sum_m f_m^2 = 1 (tight frame), so the modes sum to
    # the input exactly while each stays band-limited.
    n = signal.shape[-1]
    spec = jnp.fft.rfft(signal)
    return jnp.fft.irfft(spec[..., None, :] * jnp.square(filters), n=n,
                         axis=-1)


def ewt(signal_r, sfreq: float, n_modes: int = 3, boundaries=None,
        gamma: float | None = None, smooth: int = 0):
    """Empirical wavelet decomposition of a real (..., N) signal into
    ``(modes, boundaries_hz)`` with modes (..., M, N).

    Boundaries are detected from the FIRST signal in the batch unless
    given explicitly (data-adaptive bands should usually come from one
    reference recording).  Each mode is the band's analysis+synthesis
    round trip ``irfft(psi_hat^2 rfft(x))`` — the squared Meyer filters
    sum to 1 (tight frame), so ``modes.sum(axis=-2)`` reconstructs the
    input exactly.
    """
    host = np.asarray(signal_r, np.float32)
    signal_r = jnp.asarray(host)
    if boundaries is None:
        # detect from the first signal in the batch (host copy kept from
        # BEFORE the device upload — no D2H round trip)
        boundaries = ewt_boundaries(host.reshape(-1, host.shape[-1])[0],
                                    sfreq, n_modes, smooth)
    filters = ewt_filterbank(boundaries, signal_r.shape[-1], sfreq, gamma)
    return _ewt_apply(signal_r, filters), np.asarray(boundaries)


def ewt_reconstruct(modes: jnp.ndarray) -> jnp.ndarray:
    """Inverse EWT: the tight frame makes synthesis a plain sum over the
    mode axis."""
    return jnp.sum(jnp.asarray(modes), axis=-2)
