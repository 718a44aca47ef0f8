"""Variational Mode Decomposition (Dragomiretskiy & Zosso, IEEE TSP
2014): decompose a signal into K band-limited intrinsic modes by solving

    min sum_k || d/dt [ analytic(u_k) e^{-j w_k t} ] ||^2
    s.t. sum_k u_k = x

with ADMM.  No reference counterpart — VMD is the other standard
adaptive decomposition next to the EWT (``ops/ewt.py``): instead of
cutting the spectrum at detected boundaries it lets K Wiener-filter
modes and their center frequencies converge jointly, which handles
overlapping or drifting components the hard segmentation cannot.

Design notes:
* every ADMM update is closed-form ON THE rfft GRID — the mode update is
  a Wiener filter ``(x - sum_others + lam/2) / (1 + alpha (w-w_k)^2)``,
  the center-frequency update a power-weighted mean — so one iteration
  is pure elementwise work plus tiny reductions, and the whole solver is
  a fixed-length ``lax.scan`` (static for jit, batched over leading
  axes);
* complex spectra live only inside the program: the public entry point
  takes float signals and returns float modes;
* K is static; modes update Gauss-Seidel style via a small unrolled
  Python loop over k (K is single digits), keeping the exact update
  order of the reference algorithm.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["vmd", "mvmd", "instantaneous", "hilbert_spectrum"]


@partial(jax.jit, static_argnames=("n_modes", "alpha", "tau", "n_iter",
                                   "sfreq"))
def _vmd_jit(signal, *, n_modes, alpha, tau, n_iter, sfreq):
    n = signal.shape[-1]
    k_bins = n // 2 + 1
    freqs = jnp.arange(k_bins, dtype=jnp.float32) * (sfreq / n)  # Hz
    xhat = jnp.fft.rfft(signal)                  # (..., K_bins)
    batch = signal.shape[:-1]

    # init: center frequencies spread uniformly over (0, Nyquist)
    w0 = (jnp.arange(1, n_modes + 1, dtype=jnp.float32)
          / (n_modes + 1.0)) * (sfreq / 2.0)
    w0 = jnp.broadcast_to(w0, batch + (n_modes,))
    u0 = jnp.zeros(batch + (n_modes, k_bins), jnp.complex64)
    lam0 = jnp.zeros_like(xhat)

    def step(carry, _):
        u, w, lam = carry
        for k in range(n_modes):
            others = jnp.sum(u, axis=-2) - u[..., k, :]
            num = xhat - others + 0.5 * lam
            den = 1.0 + alpha * jnp.square(freqs - w[..., k:k + 1])
            uk = num / den
            u = u.at[..., k, :].set(uk)
            p = jnp.square(jnp.abs(uk))
            wk = jnp.sum(freqs * p, -1) / jnp.maximum(
                jnp.sum(p, -1), 1e-20)
            w = w.at[..., k].set(wk)
        # dual ascent on the reconstruction constraint (paper sign
        # convention, matching the +lam/2 in the mode numerator)
        lam = lam + tau * (xhat - jnp.sum(u, axis=-2))
        return (u, w, lam), None

    (u, w, _), _ = lax.scan(step, (u0, w0, lam0), None, length=n_iter)
    modes = jnp.fft.irfft(u, n=n, axis=-1)
    order = jnp.argsort(w, axis=-1)
    modes = jnp.take_along_axis(modes, order[..., None], axis=-2)
    w = jnp.take_along_axis(w, order, axis=-1)
    return modes, w


def vmd(signal_r, sfreq: float, n_modes: int = 3, alpha: float = 2000.0,
        tau: float = 0.0, n_iter: int = 200):
    """``(modes, center_freqs)`` of a real (..., N) signal: modes
    (..., K, N) sorted by ascending center frequency (Hz, (..., K)).

    ``alpha`` is the bandwidth penalty (larger -> narrower modes);
    ``tau`` the dual ascent rate (0 disables the exact-reconstruction
    constraint — the standard choice for noisy data, where the residual
    absorbs the noise); ``n_iter`` fixed ADMM iterations (static).
    ``alpha`` follows the vmdpy/MATLAB code convention (the paper's
    factor 2 folded in): the penalty enters as
    ``alpha ((f - f_k)/sfreq)^2`` — pass the same values you would give
    vmdpy (e.g. 2000).
    """
    signal_r = jnp.asarray(signal_r, jnp.float32)
    # the classic implementation works on unit-normalized frequency;
    # fold the sfreq scaling into alpha so user-facing alpha matches.
    alpha_eff = float(alpha) / float(sfreq) ** 2
    return _vmd_jit(signal_r, n_modes=int(n_modes), alpha=alpha_eff,
                    tau=float(tau), n_iter=int(n_iter),
                    sfreq=float(sfreq))


@partial(jax.jit, static_argnames=("n_modes", "alpha", "tau", "n_iter",
                                   "sfreq"))
def _mvmd_jit(signals, *, n_modes, alpha, tau, n_iter, sfreq):
    n = signals.shape[-1]
    c = signals.shape[-2]
    k_bins = n // 2 + 1
    freqs = jnp.arange(k_bins, dtype=jnp.float32) * (sfreq / n)
    xhat = jnp.fft.rfft(signals)                 # (..., C, K_bins)
    batch = signals.shape[:-2]

    w0 = (jnp.arange(1, n_modes + 1, dtype=jnp.float32)
          / (n_modes + 1.0)) * (sfreq / 2.0)
    w0 = jnp.broadcast_to(w0, batch + (n_modes,))
    u0 = jnp.zeros(batch + (n_modes, c, k_bins), jnp.complex64)
    lam0 = jnp.zeros_like(xhat)

    def step(carry, _):
        u, w, lam = carry
        for k in range(n_modes):
            others = jnp.sum(u, axis=-3) - u[..., k, :, :]
            num = xhat - others + 0.5 * lam          # (..., C, K_bins)
            den = 1.0 + alpha * jnp.square(
                freqs - w[..., k:k + 1, None])       # (..., 1, K_bins)
            uk = num / den
            u = u.at[..., k, :, :].set(uk)
            # SHARED center frequency: power-weighted over all channels
            p = jnp.square(jnp.abs(uk))
            wk = jnp.sum(freqs * p, (-2, -1)) / jnp.maximum(
                jnp.sum(p, (-2, -1)), 1e-20)
            w = w.at[..., k].set(wk)
        lam = lam + tau * (xhat - jnp.sum(u, axis=-3))
        return (u, w, lam), None

    (u, w, _), _ = lax.scan(step, (u0, w0, lam0), None, length=n_iter)
    modes = jnp.fft.irfft(u, n=n, axis=-1)
    order = jnp.argsort(w, axis=-1)
    modes = jnp.take_along_axis(modes, order[..., None, None], axis=-3)
    w = jnp.take_along_axis(w, order, axis=-1)
    return modes, w


def mvmd(signals_r, sfreq: float, n_modes: int = 3,
         alpha: float = 2000.0, tau: float = 0.0, n_iter: int = 200):
    """Multivariate VMD (Rehman & Aftab, IEEE TSP 2019) of a real
    (..., C, N) multi-channel block: ``(modes, center_freqs)`` with
    modes (..., K, C, N) and ONE shared center frequency per mode —
    the joint-oscillation decomposition (a common rhythm lands in the
    same mode index on every channel, with per-channel amplitude and
    phase preserved).  Same knobs as ``vmd``."""
    signals_r = jnp.asarray(signals_r, jnp.float32)
    if signals_r.ndim < 2:
        raise ValueError("expected (..., channels, N), got %s"
                         % (signals_r.shape,))
    alpha_eff = float(alpha) / float(sfreq) ** 2
    return _mvmd_jit(signals_r, n_modes=int(n_modes), alpha=alpha_eff,
                     tau=float(tau), n_iter=int(n_iter),
                     sfreq=float(sfreq))


@partial(jax.jit, static_argnames=("sfreq", "smooth"))
def _instantaneous_jit(modes, *, sfreq, smooth):
    n = modes.shape[-1]
    spec = jnp.fft.fft(modes)
    # analytic signal: zero the negative frequencies, double positives
    gain = jnp.zeros(n).at[0].set(1.0)
    gain = gain.at[1:(n + 1) // 2].set(2.0)
    if n % 2 == 0:
        gain = gain.at[n // 2].set(1.0)
    z = jnp.fft.ifft(spec * gain)
    amp = jnp.abs(z)
    phase = jnp.angle(z)
    dphi = jnp.diff(phase, axis=-1)
    dphi = jnp.mod(dphi + jnp.pi, 2.0 * jnp.pi) - jnp.pi   # unwrap step
    inst = dphi * (sfreq / (2.0 * jnp.pi))
    inst = jnp.concatenate([inst[..., :1], inst], axis=-1)
    if smooth > 1:
        kern = jnp.ones((smooth,), jnp.float32) / smooth
        pad = smooth // 2
        padded = jnp.pad(inst, [(0, 0)] * (inst.ndim - 1)
                         + [(pad, smooth - 1 - pad)], mode="edge")
        inst = jax.vmap(lambda row: jnp.convolve(row, kern, mode="valid"),
                        in_axes=0, out_axes=0)(
            padded.reshape(-1, padded.shape[-1])).reshape(inst.shape)
    return inst, amp


def instantaneous(modes, sfreq: float, smooth: int = 0):
    """``(if_hz, amplitude)`` of (..., M, N) band-limited modes (EWT/VMD
    outputs): analytic signal per mode, instantaneous frequency from the
    wrapped phase difference (optionally boxcar-smoothed over ``smooth``
    samples), amplitude as the analytic envelope.  Together with ``vmd``
    / ``ewt`` this is the Hilbert–Huang pipeline (adaptive modes +
    instantaneous attributes) without EMD's sifting."""
    modes = jnp.asarray(modes, jnp.float32)
    return _instantaneous_jit(modes, sfreq=float(sfreq),
                              smooth=int(smooth))


@partial(jax.jit, static_argnames=("sfreq", "n_bins", "fmax"))
def _hilbert_spectrum_jit(if_hz, amp, *, sfreq, n_bins, fmax):
    n = if_hz.shape[-1]
    step = fmax / n_bins
    rows = jnp.clip((if_hz / step).astype(jnp.int32), 0, n_bins - 1)
    flat_r = rows.reshape(-1, n)
    flat_a = amp.reshape(-1, n)
    cols = jnp.broadcast_to(jnp.arange(n), flat_r.shape)
    out = jnp.zeros((flat_r.shape[0], n_bins, n), jnp.float32)
    out = out.at[jnp.arange(flat_r.shape[0])[:, None], flat_r,
                 cols].add(flat_a * flat_a)
    out = out.reshape(*if_hz.shape[:-1], n_bins, n)
    # sum the mode axis: one TF energy plane per signal
    return jnp.sum(out, axis=-3)


def hilbert_spectrum(modes, sfreq: float, n_bins: int = 64,
                     fmax: float | None = None, smooth: int = 5):
    """(..., n_bins, N) Hilbert spectrum of (..., M, N) adaptive modes:
    each mode's instantaneous energy ``a(t)^2`` scattered into the
    frequency bin of its instantaneous frequency — the sharp,
    mode-adaptive counterpart of the scalogram.  ``fmax`` defaults to
    Nyquist; returns the energy plane plus nothing else (bin k spans
    ``[k, k+1) * fmax / n_bins`` Hz)."""
    if_hz, amp = instantaneous(modes, sfreq, smooth)
    return _hilbert_spectrum_jit(
        if_hz, amp, sfreq=float(sfreq), n_bins=int(n_bins),
        fmax=float(sfreq / 2.0 if fmax is None else fmax))
