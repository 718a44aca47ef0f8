"""Reassigned scalogram: 2-D time-frequency reassignment of the CWT.

No reference counterpart — reassignment (Kodera 1976; Auger & Flandrin
1995) sharpens BOTH axes of the scalogram: each (f, t) cell's energy
moves to the local energy centroid

    omega(f, t) = Im[ dW * conj(W) ] / (2 pi |W|^2)        (Hz)
    t_hat(f, t) = t + Re[ Wt * conj(W) ] / |W|^2           (s)

where ``dW`` is the CWT against the time-DERIVATIVE wavelet
(spectrum x ``i 2 pi nu``) and ``Wt`` the CWT against the
time-WEIGHTED wavelet ``tau psi(tau)`` (spectrum ``(i/2pi) d psi_hat /
d nu``, central differences on the FFT grid).  Synchrosqueezing
(:mod:`.sst`) is the frequency-only special case that stays invertible;
full reassignment gives the sharpest ridges for display/ridge analysis
at the cost of invertibility — both belong in a complete TFR toolbox.

Mapping: the 2-D scatter-add (see ``sst.py``) is recast as one
(F_out, N) @ (N, T') MATMUL per source
row under a ``lax.scan`` — the frequency-interval mask times power as
the left operand, the time-bin one-hot as the right — so the hot loop
is matmul work with O(F_out x N) live memory.  Output time is decimated
by ``t_decim`` (reassigned planes are display/statistics surfaces; the
bins are where the energy centroids land).

Boundaries are float-only as everywhere in this package.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jax import lax

from .cwt import analytic_spectrum
from .sst import _bin_nu

__all__ = ["reassigned_power", "reassigned_mean_power"]


def _edges(f_grid: jnp.ndarray) -> jnp.ndarray:
    """(F+1,) interval edges around the monotone analysis grid, open at
    both ends (out-of-range centroids clip into the edge rows, the
    Torrence-Compo convention ``sst`` also uses)."""
    mid = 0.5 * (f_grid[1:] + f_grid[:-1])
    big = jnp.asarray([3.4e38], jnp.float32)
    return jnp.concatenate([-big, mid, big])


def _reassign_one(signal, bank, f_grid, *, sfreq: float,
                  interpolate: bool, rel_threshold: float,
                  t_decim: int, f_own=None, pmax_axes=(),
                  vma_axes=()) -> jnp.ndarray:
    """(N,) x (F_local, N) -> (F_out, T') reassigned power of ONE signal.

    ``bank`` may be a SLICE of the full bank (frequency-sharded
    variant): targeting is by VALUE against the full ``f_grid`` edges,
    so a shard's source rows scatter into the full-height plane and a
    ``psum`` over the freq axis completes it.  ``f_own`` gives the
    slice's own analysis frequencies (gated cells keep their own row);
    ``pmax_axes`` reduces the noise-gate floor across mesh axes so
    every shard gates against the signal's GLOBAL power peak;
    ``vma_axes`` marks the scan carry varying under ``shard_map``.
    """
    n = signal.shape[-1]
    n_f = bank.shape[0]
    n_out = f_grid.shape[0]
    n_t = -(-n // t_decim)
    if f_own is None:
        f_own = f_grid

    spec = analytic_spectrum(signal, interpolate)
    nu = _bin_nu(n, sfreq)
    w = jnp.fft.ifft(spec[None, :] * bank)
    dw = jnp.fft.ifft(spec[None, :] * (bank * (1j * 2.0 * jnp.pi * nu)))
    # FT[tau psi](nu) = (i / 2pi) d psi_hat / d nu; central differences
    # over the FFT bin grid (d nu = sfreq / n per bin).  Analytic banks
    # are ~0 at the wrap seam, so the wrapped difference there is noise
    # on zeros.
    dbank = jnp.gradient(bank, axis=-1) * (n / sfreq)
    wt = jnp.fft.ifft(spec[None, :] * (dbank * (1j / (2.0 * jnp.pi))))

    power = jnp.square(w.real) + jnp.square(w.imag)
    guard = jnp.maximum(power, 1e-30)
    omega = (dw.imag * w.real - dw.real * w.imag) \
        / (2.0 * jnp.pi * guard)                       # Hz
    t_off = (wt.real * w.real + wt.imag * w.imag) / guard   # seconds

    t_idx = jnp.arange(n, dtype=jnp.float32)
    t_hat = t_idx[None, :] + t_off * sfreq             # samples

    # Noise gate: cells below rel_threshold x peak keep their own bin
    # (reassigning noise smears it coherently; same convention as sst).
    peak = jnp.max(power)
    for ax in pmax_axes:
        peak = lax.pmax(peak, ax)
    gate = power < rel_threshold * peak
    omega = jnp.where(gate, f_own[:, None], omega)
    t_hat = jnp.where(gate, t_idx[None, :], t_hat)

    col = jnp.clip(jnp.floor(t_hat / t_decim), 0, n_t - 1).astype(jnp.int32)
    edges = _edges(f_grid)
    cols = jnp.arange(n_t, dtype=jnp.int32)

    # K source rows per scan step: the (K, F_out, N) interval masks and
    # (K, N, T') one-hots are built as one fused elementwise pass each
    # (bandwidth-bound) and contracted as one BATCHED matmul — 100 tiny
    # dispatches collapse to ceil(F/K) matmul-shaped ones.
    K = 16
    pad = (-n_f) % K
    if pad:
        # zero-power pad rows contribute nothing wherever they land
        power = jnp.concatenate(
            [power, jnp.zeros((pad, n))], axis=0)
        omega = jnp.concatenate([omega, jnp.zeros((pad, n))], axis=0)
        col = jnp.concatenate(
            [col, jnp.zeros((pad, n), jnp.int32)], axis=0)

    def step(acc, inputs):
        p_k, om_k, col_k = inputs          # (K, N)
        lhs = ((om_k[:, None, :] > edges[None, :-1, None])
               & (om_k[:, None, :] <= edges[None, 1:, None])) \
            .astype(jnp.float32) * p_k[:, None, :]      # (K, F_out, N)
        rhs = (col_k[:, :, None] == cols[None, None, :]) \
            .astype(jnp.float32)                        # (K, N, T')
        blk = lax.dot_general(lhs, rhs, (((2,), (1,)), ((0,), (0,))),
                              precision=lax.Precision.HIGHEST)
        return acc + jnp.sum(blk, axis=0), None

    acc0 = jnp.zeros((n_out, n_t), jnp.float32)
    if vma_axes:
        acc0 = lax.pcast(acc0, vma_axes, to="varying")
    steps = (n_f + pad) // K
    out, _ = lax.scan(step, acc0,
                      (power.reshape(steps, K, n),
                       omega.reshape(steps, K, n),
                       col.reshape(steps, K, n)))
    return out


def reassigned_power(signals_r, bank_r, f_grid, sfreq: float,
                     interpolate: bool = False,
                     rel_threshold: float = 1e-6,
                     t_decim: int = 16) -> jnp.ndarray:
    """(..., F, ceil(N / t_decim)) reassigned scalogram power.

    ``signals_r``: (..., N) float32; ``bank_r``: (F, N) REAL analytic
    bank (phase information is required, so Normal/Twice-mode complex
    banks are rejected); ``f_grid``: the (monotone ascending) analysis
    frequencies in Hz.  Energy is conserved: every cell lands in
    exactly one output bin (out-of-range centroids clip to the edge
    rows / first-last time bins).
    """
    signals = jnp.asarray(signals_r, jnp.float32)
    bank = jnp.asarray(bank_r, jnp.float32)
    if bank.ndim != 2:
        raise ValueError("bank must be (F, N) real — reassignment needs "
                         "an analytic (real-spectrum) family")
    f_grid = jnp.asarray(f_grid, jnp.float32)
    lead = signals.shape[:-1]
    n = signals.shape[-1]
    flat = signals.reshape((-1, n))
    out = _reassign_flat(flat, bank, f_grid, float(sfreq),
                         bool(interpolate), float(rel_threshold),
                         int(t_decim))
    return out.reshape(lead + out.shape[1:])


@partial(jax.jit, static_argnames=("sfreq", "interpolate", "rel_threshold",
                                   "t_decim"))
def _reassign_flat(flat, bank, f_grid, sfreq, interpolate, rel_threshold,
                   t_decim):
    # The lax.map must live INSIDE a jit: outside one, every call
    # re-traces and re-compiles the scan program.  Module-level jit keys
    # on this function's identity, so the compile is paid once per
    # geometry.
    fn = partial(_reassign_one, bank=bank, f_grid=f_grid, sfreq=sfreq,
                 interpolate=interpolate, rel_threshold=rel_threshold,
                 t_decim=t_decim)
    return lax.map(fn, flat)


def reassigned_mean_power(signals_r, bank_r, f_grid, sfreq: float,
                          interpolate: bool = False,
                          rel_threshold: float = 1e-6,
                          t_decim: int = 16) -> jnp.ndarray:
    """Epoch-mean reassigned power: mean over axis 0 of
    :func:`reassigned_power` (per-trial reassignment, then average —
    averaging first would blur the very ridges reassignment sharpens)."""
    out = reassigned_power(signals_r, bank_r, f_grid, sfreq,
                           interpolate=interpolate,
                           rel_threshold=rel_threshold, t_decim=t_decim)
    return jnp.mean(out, axis=0)
