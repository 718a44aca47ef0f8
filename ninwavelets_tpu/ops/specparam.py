"""Spectral parametrization ("FOOOF" / specparam; Donoghue et al., Nat.
Neurosci. 2020): separate a power spectrum into an aperiodic 1/f
component and a small set of oscillatory Gaussian peaks,

    log10 P(f) = offset - log10(knee + f^exponent)
                 + sum_k a_k exp(-(f - c_k)^2 / (2 w_k^2)).

No reference counterpart — this is the standard modern answer to "is
this a real oscillation or just the 1/f slope", applied to any power
spectrum this engine produces (``tc_stats.global_spectrum``, multitaper
rows, Welch-style means).

Design notes:
* peak SEEDING is data-dependent host work (argmax of the residual, one
  peak at a time, numpy); the REFINEMENT is a fixed-count Adam loop over
  all parameters jointly — one compiled ``lax.scan`` whose gradients
  come from jax itself, batched over any number of spectra;
* the fixed peak count keeps shapes static: unused slots converge to
  near-zero amplitude and are pruned on host at report time;
* parameters are fit in transformed space (log-knee, log-widths,
  softplus amplitudes >= 0) so the optimizer cannot leave the valid
  region.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["specparam", "SpectralFit", "aperiodic_model", "peaks_model"]


def aperiodic_model(freqs, offset, knee, exponent):
    """``offset - log10(knee + f^exponent)`` (knee=0 gives the fixed
    1/f^exponent line in log-log)."""
    return offset - jnp.log10(knee + freqs ** exponent)


def peaks_model(freqs, amps, centers, widths):
    """Sum of Gaussians in log-power space: (..., K) params ->
    (..., F)."""
    z = (freqs[..., None, :] - centers[..., :, None]) \
        / widths[..., :, None]
    return jnp.sum(amps[..., :, None] * jnp.exp(-0.5 * z * z), axis=-2)


def _model(freqs, params):
    off, log_knee, expo, raw_a, c, log_w = params
    amps = jax.nn.softplus(raw_a)
    widths = jnp.exp(log_w)
    knee = jnp.exp(log_knee)
    return (aperiodic_model(freqs, off[..., None], knee[..., None],
                            expo[..., None])
            + peaks_model(freqs, amps, c, widths))


@partial(jax.jit, static_argnames=("n_steps", "lr", "fit_knee"))
def _refine(log_p, freqs, params0, *, n_steps, lr, fit_knee):
    def loss(params):
        if not fit_knee:
            params = (params[0], jnp.full_like(params[1], -20.0),
                      *params[2:])
        resid = _model(freqs, params) - log_p
        return jnp.mean(resid * resid)

    grad = jax.grad(loss)

    def step(carry, _):
        params, m, v, t = carry
        g = grad(params)
        t = t + 1.0
        m = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
        mh = jax.tree.map(lambda a: a / (1 - 0.9 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - 0.999 ** t), v)
        params = jax.tree.map(
            lambda p, a, b: p - lr * a / (jnp.sqrt(b) + 1e-8),
            params, mh, vh)
        return (params, m, v, t), None

    zeros = jax.tree.map(jnp.zeros_like, params0)
    (params, _, _, _), _ = lax.scan(
        step, (params0, zeros, zeros, jnp.float32(0.0)), None,
        length=n_steps)
    if not fit_knee:
        params = (params[0], jnp.full_like(params[1], -20.0), *params[2:])
    final = _model(freqs, params)
    ss_res = jnp.sum((final - log_p) ** 2, -1)
    ss_tot = jnp.sum((log_p - jnp.mean(log_p, -1, keepdims=True)) ** 2,
                     -1)
    r2 = 1.0 - ss_res / jnp.maximum(ss_tot, 1e-20)
    return params, final, r2


class SpectralFit(NamedTuple):
    """specparam result: aperiodic ``offset``/``knee``/``exponent``
    (each (...,)), peak ``centers``/``amplitudes``/``widths`` (each
    (..., K), amplitude ~0 for unused slots), the fitted ``model`` in
    log10 power, and ``r_squared``."""
    offset: np.ndarray
    knee: np.ndarray
    exponent: np.ndarray
    centers: np.ndarray
    amplitudes: np.ndarray
    widths: np.ndarray
    model: np.ndarray
    r_squared: np.ndarray

    def peaks(self, min_amplitude: float = 0.05) -> list:
        """Host-side pruned peak list (dicts sorted by amplitude) for a
        single-spectrum fit."""
        out = [{"center": float(c), "amplitude": float(a),
                "width": float(w)}
               for c, a, w in zip(np.atleast_1d(self.centers),
                                  np.atleast_1d(self.amplitudes),
                                  np.atleast_1d(self.widths))
               if a >= min_amplitude]
        return sorted(out, key=lambda d: -d["amplitude"])


def specparam(power, freqs, max_peaks: int = 4, fit_knee: bool = False,
              n_steps: int = 2000, lr: float = 0.02,
              peak_width: float = 2.0) -> SpectralFit:
    """Fit the specparam model to (..., F) power spectra at (F,)
    frequencies (Hz, > 0).

    Seeding is the FOOOF recipe on host: robust aperiodic line through
    the low-percentile envelope, then iteratively take the largest
    residual as a peak seed (``max_peaks`` slots; surplus slots start at
    zero amplitude and stay there); a fixed-count Adam loop then refines
    everything jointly on device.  ``fit_knee`` enables the knee
    parameter (broadband spectra spanning the bend).
    """
    power = np.asarray(power, np.float64)
    freqs_h = np.asarray(freqs, np.float64).ravel()
    if np.any(freqs_h <= 0):
        raise ValueError("frequencies must be positive")
    if power.shape[-1] != freqs_h.size:
        raise ValueError("power.shape[-1] must match len(freqs)")
    log_p = np.log10(np.maximum(power, 1e-30))
    batch = log_p.shape[:-1]
    flat = log_p.reshape(-1, freqs_h.size)

    # --- host seeding -----------------------------------------------------
    lf = np.log10(freqs_h)
    offs, expos = [], []
    seeds = np.zeros((flat.shape[0], max_peaks, 3))
    for i, row in enumerate(flat):
        # robust line: least squares, then refit on the points at or
        # below the first fit (peaks only push the spectrum UP)
        a = np.stack([np.ones_like(lf), -lf], -1)
        coef, *_ = np.linalg.lstsq(a, row, rcond=None)
        resid = row - (coef[0] - coef[1] * lf)
        keep = resid <= np.percentile(resid, 40)
        coef, *_ = np.linalg.lstsq(a[keep], row[keep], rcond=None)
        offs.append(coef[0])
        expos.append(max(coef[1], 0.0))
        resid = row - (coef[0] - coef[1] * lf)
        for k in range(max_peaks):
            j = int(np.argmax(resid))
            amp = float(resid[j])
            if amp < 0.05:
                seeds[i, k] = (freqs_h[j], 0.0, peak_width)
                continue
            seeds[i, k] = (freqs_h[j], amp, peak_width)
            resid = resid - amp * np.exp(
                -0.5 * ((freqs_h - freqs_h[j]) / peak_width) ** 2)

    off0 = jnp.asarray(np.reshape(offs, batch or ()), jnp.float32)
    exp0 = jnp.asarray(np.reshape(expos, batch or ()), jnp.float32)
    c0 = jnp.asarray(seeds[:, :, 0].reshape(batch + (max_peaks,)),
                     jnp.float32)
    a0 = seeds[:, :, 1]
    # softplus inverse for the amplitude seeds (0 -> large negative)
    raw_a0 = jnp.asarray(
        np.where(a0 > 1e-3, np.log(np.expm1(np.maximum(a0, 1e-3))),
                 -6.0).reshape(batch + (max_peaks,)), jnp.float32)
    w0 = jnp.asarray(np.log(seeds[:, :, 2]).reshape(
        batch + (max_peaks,)), jnp.float32)
    params0 = (off0, jnp.full_like(off0, -20.0 if not fit_knee else 0.0),
               exp0, raw_a0, c0, w0)

    params, model, r2 = _refine(
        jnp.asarray(log_p, jnp.float32), jnp.asarray(freqs_h, jnp.float32),
        params0, n_steps=int(n_steps), lr=float(lr),
        fit_knee=bool(fit_knee))
    off, log_knee, expo, raw_a, c, log_w = params
    return SpectralFit(
        np.asarray(off), np.asarray(jnp.exp(log_knee)), np.asarray(expo),
        np.asarray(c), np.asarray(jax.nn.softplus(raw_a)),
        np.asarray(jnp.exp(log_w)), np.asarray(model), np.asarray(r2))
