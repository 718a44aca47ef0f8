"""Power-envelope correlations, plain and pairwise-orthogonalized
(Hipp, Hawellek, Corbetta, Siegel & Engel, Nat. Neurosci. 2012).

No reference counterpart — amplitude-envelope correlation (AEC) is the
standard resting-state MEG/EEG coupling measure, and the orthogonalized
variant removes the zero-lag source-leakage component: before
correlating, channel b's coefficients are projected off channel a's
instantaneous phase, ``Y_{b|a}(f, t) = imag(W_b conj(W_a) / |W_a|)``, so
any signal component shared instantaneously (volume conduction) cancels
exactly while genuinely coupled but lagged envelopes survive.

Layout: one signal rFFT; bank rows stream through a ``lax.scan`` (the
(E, C, F, N) coefficient tensor never exists), and within a row a second
scan walks the orthogonalization seed channel — per step the projection,
log envelopes, and per-epoch Pearson correlations are elementwise /
reduction work on an (E, C, N) slab.  Correlations are computed per
epoch over time and averaged over epochs (linear in epochs, so the
sharded variant completes with one ``pmean``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .cwt import analytic_spectrum

__all__ = ["env_corr_matrix", "env_corr_matrix_from_bank"]


def _log_env(power: jnp.ndarray, log: bool, eps: float) -> jnp.ndarray:
    return jnp.log(power + eps) if log else power


def _epoch_mean_corr(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Mean over epochs of the per-epoch Pearson correlation over time:
    x (E, N), y (E, ..., N) -> (...,).  Zero-variance rows give 0."""
    xc = x - jnp.mean(x, -1, keepdims=True)
    yc = y - jnp.mean(y, -1, keepdims=True)
    num = jnp.einsum("...n,...n->...", jnp.broadcast_to(
        xc.reshape(xc.shape[0], *([1] * (y.ndim - 2)), xc.shape[-1]),
        yc.shape), yc)
    den = jnp.sqrt(jnp.sum(xc * xc, -1).reshape(
        xc.shape[0], *([1] * (y.ndim - 2)))
        * jnp.sum(yc * yc, -1))
    r = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
    return jnp.mean(r, axis=0)


def env_corr_matrix_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                              orthogonalize: bool = True,
                              interpolate: bool = False,
                              log: bool = True, eps: float = 1e-12,
                              time_range=None) -> jnp.ndarray:
    """(F, C, C) power-envelope correlation matrix of an (E, C, N) epoch
    batch against an (F, N) bank.

    ``out[f, a, b]`` correlates channel a's (log) power envelope with
    channel b's — orthogonalized with respect to a first when
    ``orthogonalize`` (then symmetrized, ``(R + R^T)/2``, diagonal 0;
    the plain AEC keeps its diagonal of 1).  Correlation runs over time
    within each epoch, then averages over epochs.
    """
    spec = analytic_spectrum(sigs, interpolate)               # (E, C, N)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    c = sigs.shape[-2]

    def row(_, bank_row):
        w = jnp.fft.ifft(spec * bank_row)[..., n0:n1]         # (E, C, N)
        env = _log_env(jnp.square(jnp.abs(w)), log, eps)      # (E, C, N)
        if not orthogonalize:
            return None, _sym_full(env)
        mag = jnp.maximum(jnp.abs(w), 1e-20)

        def seed(_, a):
            wa = w[:, a]                                       # (E, N)
            proj = jnp.imag(w * jnp.conj(wa)[:, None, :]) \
                / mag[:, a][:, None, :]                        # (E, C, N)
            envp = _log_env(jnp.square(proj), log, eps)
            return None, _epoch_mean_corr(env[:, a], envp)     # (C,)

        r = lax.scan(seed, None, jnp.arange(c))[1]             # (C, C)
        r = 0.5 * (r + r.T)
        return None, r * (1.0 - jnp.eye(c, dtype=r.dtype))

    return lax.scan(row, None, bank)[1]


def _sym_full(env: jnp.ndarray) -> jnp.ndarray:
    """All-pairs plain envelope correlation of one (E, C, N) slab."""
    xc = env - jnp.mean(env, -1, keepdims=True)
    cov = jnp.einsum("ean,ebn->eab", xc, xc)
    sd = jnp.sqrt(jnp.einsum("ean,ean->ea", xc, xc))
    den = sd[:, :, None] * sd[:, None, :]
    r = jnp.where(den > 0, cov / jnp.where(den > 0, den, 1.0), 0.0)
    return jnp.mean(r, axis=0)


@partial(jax.jit, static_argnames=("orthogonalize", "interpolate", "log",
                                   "eps", "time_range"))
def _env_corr_jit(sigs, bank_r, *, orthogonalize, interpolate, log, eps,
                  time_range):
    return env_corr_matrix_from_bank(sigs, bank_r, orthogonalize,
                                     interpolate, log, eps, time_range)


def env_corr_matrix(sigs_r, bank_r, orthogonalize: bool = True,
                    interpolate: bool = False, log: bool = True,
                    eps: float = 1e-12, time_range=None) -> jnp.ndarray:
    """Float-boundary jitted ``env_corr_matrix_from_bank`` (real banks —
    envelope coupling needs an analytic family)."""
    sigs_r = jnp.asarray(sigs_r, jnp.float32)
    return _env_corr_jit(sigs_r, jnp.asarray(bank_r),
                         orthogonalize=bool(orthogonalize),
                         interpolate=bool(interpolate), log=bool(log),
                         eps=float(eps), time_range=time_range)
