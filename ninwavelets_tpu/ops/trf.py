"""Temporal response functions (mTRF): ridge-regression encoding
models from continuous stimuli to continuous neural responses
(Crosse et al. 2016, Front Hum Neurosci 10:604 — the mTRF-Toolbox
workflow; speech-envelope tracking, attention decoding).

No reference counterpart — the TRF is the standard analysis for
continuous-stimulus paradigms: ``r(t) = sum_k sum_l w[k, l]
s_k(t - lag_l) + noise``, fitted by ridge regression over a lag window.

Design: the lagged design matrix never materializes — its Gram
matrix is assembled from STIMULUS CROSS-CORRELATIONS:
``XtX[(k,i),(j,l)] = sum_t s_k(t - lag_i) s_j(t - lag_l)`` depends only
on the lag DIFFERENCE up to edge terms, but we compute it exactly as
one (K*L, N) @ (N, K*L) HIGHEST-precision matmul over the stacked
shifted copies (K*L is tens — the stack is cheap, and exactness beats
the Toeplitz shortcut's edge bias); the solve is one (K*L, K*L) system
for ALL response channels at once.  Cross-validation folds are
CONTIGUOUS time blocks (shuffled folds leak autocorrelated neighbors
and wildly inflate r).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["TRFResult", "lagged_design", "trf_fit", "trf_predict",
           "trf_cv"]

_HP = jax.lax.Precision.HIGHEST


class TRFResult(NamedTuple):
    """Fitted encoding model: ``weights`` (C, K, L) response-channel x
    stimulus-feature x lag kernel, ``lags`` (L,) sample offsets (a
    positive lag means the response FOLLOWS the stimulus), ``lam`` the
    ridge used."""
    weights: jnp.ndarray
    lags: np.ndarray
    lam: float


def lagged_design(stim, lags) -> jnp.ndarray:
    """(K, N) stimulus -> (K, L, N) stack of lagged copies:
    ``out[k, l, t] = s_k(t - lags[l])`` (zero-padded edges)."""
    stim = jnp.atleast_2d(jnp.asarray(stim, jnp.float32))
    cols = []
    for lag in lags:
        lag = int(lag)
        if lag >= 0:
            v = jnp.pad(stim, ((0, 0), (lag, 0)))[:, :stim.shape[-1]]
        else:
            v = jnp.pad(stim, ((0, 0), (0, -lag)))[:, -lag:]
        cols.append(v)
    return jnp.stack(cols, axis=1)                    # (K, L, N)


@partial(jax.jit, static_argnames=("lags",))
def _gram_jit(stim, resp, *, lags):
    x = lagged_design(stim, lags)                     # (K, L, N)
    k, l, n = x.shape
    xf = x.reshape(k * l, n)
    xtx = jnp.matmul(xf, xf.T, precision=_HP)         # (KL, KL)
    xty = jnp.matmul(xf, resp.T, precision=_HP)       # (KL, C)
    return xtx, xty


@partial(jax.jit, static_argnames=())
def _solve_jit(xtx, xty, lam):
    kl = xtx.shape[0]
    a = xtx + lam * jnp.trace(xtx) / kl * jnp.eye(kl, dtype=xtx.dtype)
    return jnp.linalg.solve(a, xty)                   # (KL, C)


def trf_fit(stim, resp, lags, lam: float = 1e-2) -> TRFResult:
    """Fit a multivariate TRF: stimulus (K, N) (or (N,)) -> response
    (C, N), ridge ``lam`` (relative to the mean design variance).
    ``lags`` is an iterable of SAMPLE offsets (e.g. ``range(0, 64)``
    for a 0-250 ms window at 256 Hz; negative lags model acausal /
    decoding directions)."""
    stim = jnp.atleast_2d(jnp.asarray(stim, jnp.float32))
    resp = jnp.atleast_2d(jnp.asarray(resp, jnp.float32))
    if stim.shape[-1] != resp.shape[-1]:
        raise ValueError("stimulus and response must share the time axis")
    lags_t = tuple(int(v) for v in lags)
    if not lags_t:
        raise ValueError("need at least one lag")
    xtx, xty = _gram_jit(stim, resp, lags=lags_t)
    w = _solve_jit(xtx, xty, jnp.float32(lam))
    k = stim.shape[0]
    weights = w.T.reshape(resp.shape[0], k, len(lags_t))
    return TRFResult(weights=weights, lags=np.asarray(lags_t),
                     lam=float(lam))


@partial(jax.jit, static_argnames=("lags",))
def _predict_jit(weights, stim, *, lags):
    x = lagged_design(stim, lags)
    return jnp.einsum("ckl,kln->cn", weights, x, precision=_HP)


def trf_predict(result: TRFResult, stim) -> jnp.ndarray:
    """Predicted response (C, N) from a fitted TRF and a (K, N)
    stimulus.  Jitted — the lagged design is dozens of pad/stack ops
    that would otherwise dispatch eagerly one by one over the device
    link."""
    stim = jnp.atleast_2d(jnp.asarray(stim, jnp.float32))
    return _predict_jit(result.weights, stim,
                        lags=tuple(int(v) for v in result.lags))


def trf_cv(stim, resp, lags, lams=(1e-4, 1e-3, 1e-2, 1e-1, 1.0),
           n_folds: int = 5):
    """Cross-validated TRF: CONTIGUOUS-block folds (shuffled folds
    would leak autocorrelated neighbors into the test set and inflate
    r), the ridge grid evaluated per fold from ONE pair of Gram
    matrices per fold (fit is linear in lam only through the solve).

    Returns ``(result, r, best_lam)``: the model refitted on ALL data
    at the winning lam, the (C,) mean held-out Pearson r per response
    channel at that lam, and the lam itself."""
    stim = jnp.atleast_2d(jnp.asarray(stim, jnp.float32))
    resp = jnp.atleast_2d(jnp.asarray(resp, jnp.float32))
    if stim.shape[-1] != resp.shape[-1]:
        raise ValueError("stimulus and response must share the time axis")
    n = stim.shape[-1]
    nf = int(n_folds)
    if n < 4 * nf:
        raise ValueError("recording too short for the fold count")
    lags_t = tuple(int(v) for v in lags)
    edges = np.linspace(0, n, nf + 1).astype(int)
    lams = tuple(float(v) for v in lams)
    rs = np.zeros((len(lams), resp.shape[0], nf), np.float64)
    for f in range(nf):
        lo, hi = int(edges[f]), int(edges[f + 1])
        tr_stim = jnp.concatenate([stim[:, :lo], stim[:, hi:]], -1)
        tr_resp = jnp.concatenate([resp[:, :lo], resp[:, hi:]], -1)
        xtx, xty = _gram_jit(tr_stim, tr_resp, lags=lags_t)
        te_stim, te_resp = stim[:, lo:hi], np.asarray(resp[:, lo:hi])
        for j, lam in enumerate(lams):
            w = _solve_jit(xtx, xty, jnp.float32(lam))
            wres = TRFResult(
                weights=w.T.reshape(resp.shape[0], stim.shape[0],
                                    len(lags_t)),
                lags=np.asarray(lags_t), lam=lam)
            pred = np.asarray(trf_predict(wres, te_stim))
            pc = pred - pred.mean(-1, keepdims=True)
            rc = te_resp - te_resp.mean(-1, keepdims=True)
            denom = np.sqrt((pc * pc).sum(-1) * (rc * rc).sum(-1))
            rs[j, :, f] = (pc * rc).sum(-1) / np.maximum(denom, 1e-30)
    mean_r = rs.mean(-1)                              # (lams, C)
    best = int(np.argmax(mean_r.mean(-1)))
    final = trf_fit(stim, resp, lags_t, lam=lams[best])
    return final, mean_r[best], lams[best]
