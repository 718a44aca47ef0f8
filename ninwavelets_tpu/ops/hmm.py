"""Hidden-Markov-model spectral state detection (Baum-Welch EM +
Viterbi; the osl-dynamics / Vidaurre et al., NeuroImage 2016 workflow).
No reference counterpart — given band-power (or any) feature tracks,
segment the recording into K recurring "brain states", each a Gaussian
spectral profile with Markov dwell-time structure.  The complement of
the static decompositions: CP/PARAFAC finds *which* patterns exist,
the HMM finds *when* each one rules.

Design notes:
* the forward-backward recursions are two ``lax.scan``s in log space
  (per-step ``logsumexp`` over the K x K transition — K is single or
  double digits, so each step is one tiny matmul-shaped reduction);
* the transition-count statistics accumulate INSIDE the backward scan
  (never materializing the (T, K, K) xi tensor), so memory is O(T K);
* EM runs a fixed, static number of iterations; multiple sequences
  (epochs) share parameters — the E-step is ``vmap``ed over the batch
  and the M-step sums sufficient statistics across it;
* observation model: diagonal Gaussian with a variance floor; k-means-
  style seeding from evenly spaced data frames keeps init deterministic
  (PRNG only shuffles which frames);
* Viterbi is a max-product scan storing (T, K) argmax pointers and a
  reverse backtracking scan — all static shapes.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["hmm_fit", "viterbi", "HMMResult"]

_VAR_FLOOR = 1e-5


class HMMResult(NamedTuple):
    """Fitted HMM.  ``gamma`` are posterior state probabilities per
    frame, ``states`` the Viterbi path; loglik is the per-EM-iteration
    total log-likelihood trace (should be non-decreasing)."""
    pi: jnp.ndarray          # (K,) initial distribution
    transition: jnp.ndarray  # (K, K) row-stochastic
    means: jnp.ndarray       # (K, D)
    variances: jnp.ndarray   # (K, D) diagonal
    gamma: jnp.ndarray       # (..., T, K)
    states: jnp.ndarray      # (..., T) int32 Viterbi path
    loglik: jnp.ndarray      # (n_iter,)


def _log_obs(x, means, variances):
    """(T, K) log N(x_t | mu_k, diag var_k)."""
    v = jnp.maximum(variances, _VAR_FLOOR)
    d2 = (x[:, None, :] - means[None]) ** 2 / v[None]
    return -0.5 * (jnp.sum(d2, -1)
                   + jnp.sum(jnp.log(2.0 * jnp.pi * v), -1))


def _forward(log_b, log_pi, log_a):
    """Scaled forward pass: returns (log_alpha (T, K), loglik)."""
    def step(carry, lb):
        la_prev, total = carry
        la = lb + jax.scipy.special.logsumexp(
            la_prev[:, None] + log_a, axis=0)
        z = jax.scipy.special.logsumexp(la)
        return (la - z, total + z), la - z

    la0 = log_pi + log_b[0]
    z0 = jax.scipy.special.logsumexp(la0)
    (_, loglik), rest = lax.scan(step, (la0 - z0, z0), log_b[1:])
    return jnp.concatenate([(la0 - z0)[None], rest]), loglik


def _backward_stats(log_b, log_a, log_alpha):
    """One reverse scan: returns (gamma (T, K), xi_sum (K, K)) with the
    transition counts accumulated in the carry."""
    k = log_a.shape[0]

    def step(carry, inp):
        lbeta_next, xi_acc = carry
        lb_next, la_t = inp
        m = log_a + (lb_next + lbeta_next)[None, :]     # (K, K)
        lbeta = jax.scipy.special.logsumexp(m, axis=1)
        # xi(t) propto alpha_t(i) A_ij b_{t+1}(j) beta_{t+1}(j)
        lxi = la_t[:, None] + m
        lxi = lxi - jax.scipy.special.logsumexp(lxi)
        xi_acc = xi_acc + jnp.exp(lxi)
        # normalize beta for stability (constants cancel in gamma/xi)
        lbeta = lbeta - jnp.max(lbeta)
        return (lbeta, xi_acc), lbeta

    # derive the zero inits from the data so their varying-axes type
    # matches the scanned operands under shard_map (scan zero-inits
    # inside shard_map need data-derived carries)
    zero = 0.0 * log_b[0, 0]
    init = (jnp.zeros(k) + zero, jnp.zeros((k, k)) + zero)
    (_, xi_sum), lbetas = lax.scan(
        step, init, (log_b[1:], log_alpha[:-1]), reverse=True)
    lbeta_full = jnp.concatenate([lbetas, jnp.zeros((1, k))])
    lg = log_alpha + lbeta_full
    gamma = jnp.exp(lg - jax.scipy.special.logsumexp(
        lg, axis=1, keepdims=True))
    return gamma, xi_sum


def _e_step(x, pi, a, means, variances):
    log_b = _log_obs(x, means, variances)
    log_alpha, loglik = _forward(log_b, jnp.log(pi), jnp.log(a))
    gamma, xi_sum = _backward_stats(log_b, jnp.log(a), log_alpha)
    return gamma, xi_sum, loglik


def _init_params(x, key, k, stickiness):
    """Deterministic EM seeding from a (B, T, D) block: k-means-like
    means from shuffled frame chunks, global variance, sticky uniform
    transitions.  Shared by the single-device and sharded fits."""
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    chunk = max(1, min(16, flat.shape[0] // k))
    idx = jax.random.permutation(key, flat.shape[0])[:k * chunk]
    seeds = flat[idx].reshape(k, chunk, d).mean(1)           # (K, D)
    gvar = jnp.var(flat, axis=0) + _VAR_FLOOR
    pi0 = jnp.full((k,), 1.0 / k)
    a0 = (1.0 - stickiness) / (k - 1.0) * (1.0 - jnp.eye(k)) \
        + stickiness * jnp.eye(k)
    return pi0, a0, seeds, jnp.broadcast_to(gvar, (k, d))


def _hmm_body(x, key, *, n_states, n_iter, stickiness):
    b, t, d = x.shape
    k = n_states
    flat = x.reshape(-1, d)
    pi0, a0, means0, var0 = _init_params(x, key, k, stickiness)

    def em(carry, _):
        pi, a, means, variances = carry
        gamma, xi, ll = jax.vmap(
            lambda seq: _e_step(seq, pi, a, means, variances))(x)
        # M-step over all sequences.  Precision.HIGHEST: a DEFAULT
        # matmul may run in TF32 on a GPU (~1e-3 rel err) and
        # E[x^2] - mu^2 cancels catastrophically for non-centered
        # features; true-f32 accumulation keeps the cancellation at
        # f32 eps, which the z-scored-feature convention then absorbs.
        g = gamma.reshape(-1, k)                             # (B*T, K)
        nk = jnp.sum(g, 0) + 1e-8
        hi = lax.Precision.HIGHEST
        means = jnp.matmul(g.T, flat, precision=hi) / nk[:, None]
        ex2 = jnp.matmul(g.T, flat * flat, precision=hi) / nk[:, None]
        variances = jnp.maximum(ex2 - means * means, _VAR_FLOOR)
        xi_tot = jnp.sum(xi, 0) + 1e-8
        a = xi_tot / jnp.sum(xi_tot, 1, keepdims=True)
        pi = jnp.mean(gamma[:, 0, :], 0) + 1e-8
        pi = pi / jnp.sum(pi)
        return (pi, a, means, variances), jnp.sum(ll)

    (pi, a, means, variances), ll_trace = lax.scan(
        em, (pi0, a0, means0, var0), None, length=n_iter)
    gamma, _, _ = jax.vmap(
        lambda seq: _e_step(seq, pi, a, means, variances))(x)
    states = jax.vmap(
        lambda seq: _viterbi_jit_body(seq, pi, a, means, variances))(x)
    return pi, a, means, variances, gamma, states, ll_trace


@partial(jax.jit, static_argnames=("n_states", "n_iter", "stickiness",
                                   "n_restarts"))
def _hmm_jit(x, key, *, n_states, n_iter, stickiness, n_restarts):
    if n_restarts == 1:
        return _hmm_body(x, key, n_states=n_states, n_iter=n_iter,
                         stickiness=stickiness)
    keys = jax.random.split(key, n_restarts)
    outs = jax.vmap(lambda kk: _hmm_body(
        x, kk, n_states=n_states, n_iter=n_iter,
        stickiness=stickiness))(keys)
    best = jnp.argmax(outs[-1][:, -1])   # final loglik decides
    return jax.tree.map(lambda a: a[best], outs)


def _viterbi_jit_body(x, pi, a, means, variances):
    log_b = _log_obs(x, means, variances)
    log_a = jnp.log(a)

    def fwd(delta, lb):
        cand = delta[:, None] + log_a                       # (K, K)
        best = jnp.max(cand, axis=0)
        arg = jnp.argmax(cand, axis=0)
        return best + lb, arg

    delta0 = jnp.log(pi) + log_b[0]
    delta, ptrs = lax.scan(fwd, delta0, log_b[1:])

    def back(s_next, ptr):
        s = ptr[s_next]
        return s, s

    s_last = jnp.argmax(delta)
    _, path = lax.scan(back, s_last, ptrs, reverse=True)
    return jnp.concatenate([path, s_last[None]]).astype(jnp.int32)


def hmm_fit(features, n_states: int, n_iter: int = 50,
            stickiness: float = 0.9, seed: int = 0,
            n_restarts: int = 1) -> HMMResult:
    """Fit a K-state diagonal-Gaussian HMM to (T, D) or (B, T, D)
    feature tracks (multiple sequences share one parameter set) and
    decode them: returns an ``HMMResult`` with posteriors, the Viterbi
    path, and the EM log-likelihood trace.

    For spectral states, features are typically log band-power
    envelopes (z-scored per dimension); ``stickiness`` sets the initial
    self-transition mass (dwell-time prior of the init only — EM is
    free to move it).  ``n_restarts`` runs that many independently
    seeded EMs IN PARALLEL (one vmapped program) and keeps the best
    final log-likelihood — the standard guard against EM local optima
    (state merging); 4-8 is plenty.
    """
    x = jnp.asarray(features, jnp.float32)
    if x.ndim == 2:
        x, squeeze = x[None], True
    elif x.ndim == 3:
        squeeze = False
    else:
        raise ValueError("features must be (T, D) or (B, T, D)")
    if not (2 <= n_states <= x.shape[1] // 4):
        raise ValueError("need 2 <= n_states <= T/4")
    if n_iter < 1:
        raise ValueError("n_iter >= 1")
    if n_restarts < 1:
        raise ValueError("n_restarts >= 1")
    pi, a, means, variances, gamma, states, ll = _hmm_jit(
        x, jax.random.PRNGKey(seed), n_states=int(n_states),
        n_iter=int(n_iter), stickiness=float(stickiness),
        n_restarts=int(n_restarts))
    if squeeze:
        gamma, states = gamma[0], states[0]
    return HMMResult(pi, a, means, variances, gamma, states, ll)


_viterbi_batched = jax.jit(jax.vmap(_viterbi_jit_body,
                                    in_axes=(0, None, None, None, None)))


def viterbi(features, result: HMMResult) -> jnp.ndarray:
    """(…, T) most-likely state path of new (T, D) / (B, T, D) features
    under a fitted model."""
    x = jnp.asarray(features, jnp.float32)
    one = x.ndim == 2
    if one:
        x = x[None]
    out = _viterbi_batched(x, result.pi, result.transition,
                           result.means, result.variances)
    return out[0] if one else out
