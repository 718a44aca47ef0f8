"""EEG microstate analysis: polarity-invariant topographic clustering.

No reference counterpart — this completes the states family next to the
spectral HMM (``ops/hmm.py``): microstates are the classical broadband
view (Lehmann; Pascual-Marqui, Michel & Lehmann 1995, IEEE TBME 42:658),
where the multichannel topography is quantized into a handful of
quasi-stable maps (the canonical A/B/C/D) and the recording becomes a
symbol sequence with coverage / duration / occurrence / transition
statistics.

Design — everything is static-shape matmul work:

* the modified (polarity-invariant) k-means never materializes per-state
  sample subsets: the E-step is one (K, C) @ (C, T) activation matmul
  and an argmax of the squared, GFP-normalized activations; the M-step
  builds the K per-state scatter matrices as ONE weighted
  (K, C, T') x (T', C) batched matmul (one-hot weights x samples) and
  takes their dominant eigenvectors with a batched ``eigh`` on the tiny
  (K, C, C) stack — the standard "first principal component of the
  assigned samples" update, exactly;
* GFP-peak restriction is a 0/1 WEIGHT in those sums, not a dynamic
  gather (static shapes; excluded samples simply contribute zero);
* restarts ride ``vmap`` (the HMM module's pattern), best
  global-explained-variance wins;
* average-reference projection is applied internally (microstate maps
  live in the average-reference subspace by construction).

Backfitting labels every sample by best |spatial correlation| and the
statistics are one-hot matmul reductions (no host loops).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["MicrostateResult", "gfp", "microstate_fit",
           "microstate_backfit", "microstate_stats",
           "microstate_syntax_test"]


class MicrostateResult(NamedTuple):
    """Fitted microstate decomposition of a (C, T) recording.

    ``maps`` (K, C): unit-norm, average-referenced topographies (sign is
    arbitrary — microstates are polarity-invariant; rows are ordered by
    descending coverage).  ``labels`` (T,) int32 backfitted state per
    sample.  ``gev`` float: global explained variance in [0, 1].
    ``gev_per_state`` (K,).
    """
    maps: jnp.ndarray
    labels: jnp.ndarray
    gev: jnp.ndarray
    gev_per_state: jnp.ndarray


def gfp(x) -> jnp.ndarray:
    """Global field power of (..., C, T): the spatial standard deviation
    per sample (Lehmann & Skrandies 1980)."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.std(x, axis=-2)


def _avg_ref(x):
    return x - jnp.mean(x, axis=-2, keepdims=True)


def _peak_mask(g):
    """(T,) 0/1 mask of strict local GFP maxima (endpoints excluded)."""
    left = g[1:-1] > g[:-2]
    right = g[1:-1] > g[2:]
    return jnp.pad(left & right, (1, 1)).astype(jnp.float32)


@partial(jax.jit, static_argnames=("n_states", "n_iter"))
def _fit_one(x, g2, w, key, *, n_states, n_iter):
    """One restart of the modified k-means on average-referenced (C, T)
    data; ``w`` is the (T,) sample weight (GFP-peak mask or ones),
    ``g2`` the per-sample squared GFP norm ``sum_c x_c^2``."""
    c, t = x.shape
    # init: K random (weighted) samples as prototypes
    idx = jax.random.choice(key, t, (n_states,), replace=False,
                            p=w / jnp.sum(w))
    maps = x[:, idx].T                                 # (K, C)
    maps = maps / jnp.maximum(
        jnp.linalg.norm(maps, axis=1, keepdims=True), 1e-12)

    def step(maps, _):
        a = maps @ x                                   # (K, T)
        lab = jnp.argmax(a * a, axis=0)                # polarity-invariant
        onehot = (lab[None, :] == jnp.arange(n_states)[:, None])
        wk = onehot.astype(jnp.float32) * w[None, :]   # (K, T)
        # per-state scatter S_k = sum_t wk x x^T as one batched matmul
        xw = x[None, :, :] * wk[:, None, :]            # (K, C, T)
        s = jnp.einsum("kct,dt->kcd", xw, x,
                       precision=lax.Precision.HIGHEST)
        # dominant eigenvector of each tiny (C, C) scatter
        _, evecs = jnp.linalg.eigh(s)                  # ascending
        new = evecs[..., -1]                           # (K, C)
        # empty states keep their old prototype
        empty = jnp.sum(wk, axis=1) < 0.5
        new = jnp.where(empty[:, None], maps, new)
        return new, None

    maps, _ = lax.scan(step, maps, None, length=n_iter)
    # GEV of this restart (on the weighted samples, the fit criterion)
    # GEV = sum_t w gfp^2 corr^2 / sum_t w gfp^2; with unit-norm maps on
    # average-referenced data, gfp^2 corr^2 = (map . x)^2 / C and the C
    # cancels: GEV = sum(w best^2) / sum(w ||x||^2).
    a = maps @ x
    lab = jnp.argmax(a * a, axis=0)
    best = jnp.take_along_axis(a, lab[None, :], axis=0)[0]
    gev = jnp.sum(w * best * best) / jnp.maximum(jnp.sum(w * g2), 1e-20)
    return maps, gev


def microstate_fit(x, n_states: int = 4, *, peaks_only: bool = True,
                   n_init: int = 8, n_iter: int = 40,
                   seed: int = 0) -> MicrostateResult:
    """Fit ``n_states`` microstate maps to a (C, T) recording.

    ``peaks_only`` fits on GFP local maxima (the standard protocol —
    topographies are most stable at field-power peaks); backfitting
    always labels EVERY sample.  ``n_init`` random restarts run
    vmapped; the best global-explained-variance fit wins.  Maps are
    returned ordered by descending coverage.
    """
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("x must be (C, T)")
    c, t = x.shape
    if not 1 < n_states < min(c, t):
        raise ValueError("need 1 < n_states < min(C, T)")
    x = _avg_ref(x)
    g = gfp(x)
    g2 = jnp.sum(x * x, axis=0)
    w = _peak_mask(g) if peaks_only else jnp.ones_like(g)
    if peaks_only:
        # A recording with fewer strict GFP maxima than states cannot
        # seed the prototypes (zero/NaN sampling probabilities would
        # silently produce NaN maps) — fail loudly with the fix.
        n_peaks = int(jnp.sum(w))
        if n_peaks < n_states:
            raise ValueError(
                f"only {n_peaks} GFP peaks for {n_states} states — "
                "constant-GFP data has none; pass peaks_only=False")
    keys = jax.random.split(jax.random.PRNGKey(seed), int(n_init))
    maps_all, gev_all = jax.vmap(
        lambda k: _fit_one(x, g2, w, k, n_states=int(n_states),
                           n_iter=int(n_iter)))(keys)
    best = int(jnp.argmax(gev_all))
    maps = maps_all[best]
    labels = microstate_backfit(x, maps)
    # order by coverage, recompute per-state GEV on ALL samples
    onehot = (labels[None, :] == jnp.arange(int(n_states))[:, None])
    cov = jnp.mean(onehot, axis=1)
    order = jnp.argsort(-cov)
    maps = maps[order]
    labels = microstate_backfit(x, maps)
    a = maps @ x
    bestact = jnp.take_along_axis(a, labels[None, :], axis=0)[0]
    denom = jnp.maximum(jnp.sum(g2), 1e-20)
    gev_total = jnp.sum(bestact * bestact) / denom
    onehot = (labels[None, :] == jnp.arange(int(n_states))[:, None])
    gev_k = jnp.sum(onehot * (bestact * bestact)[None, :],
                    axis=1) / denom
    return MicrostateResult(maps=maps, labels=labels, gev=gev_total,
                            gev_per_state=gev_k)


@jax.jit
def microstate_backfit(x, maps) -> jnp.ndarray:
    """(T,) int32 label per sample: argmax of the squared spatial
    correlation with each unit-norm map (polarity-invariant).  ``x`` is
    (C, T); average reference is applied to match the fit space."""
    x = _avg_ref(jnp.asarray(x, jnp.float32))
    a = jnp.asarray(maps, jnp.float32) @ x
    return jnp.argmax(a * a, axis=0).astype(jnp.int32)


def microstate_stats(labels, n_states: int, sfreq: float) -> dict:
    """Sequence statistics of a backfitted label series.

    Returns ``coverage`` (K,) fraction of samples, ``occurrence`` (K,)
    segments per second, ``duration`` (K,) mean segment length in
    seconds (coverage / occurrence), and ``transitions`` (K, K) —
    row-normalized probabilities between DISTINCT consecutive states.
    All one-hot matmul reductions inside one jit.
    """
    labels = jnp.asarray(labels, jnp.int32)
    return {k: np.asarray(v) for k, v in
            _stats_jit(labels, n_states=int(n_states),
                       sfreq=float(sfreq)).items()}


@partial(jax.jit, static_argnames=("n_states", "sfreq"))
def _stats_jit(labels, *, n_states, sfreq):
    t = labels.shape[0]
    k = jnp.arange(n_states)
    onehot = (labels[None, :] == k[:, None]).astype(jnp.float32)
    coverage = jnp.mean(onehot, axis=1)
    # segment starts: change points (sample 0 always starts a segment)
    change = jnp.concatenate(
        [jnp.ones((1,), jnp.float32),
         (labels[1:] != labels[:-1]).astype(jnp.float32)])
    starts = onehot * change[None, :]
    occurrence = jnp.sum(starts, axis=1) / (t / sfreq)
    duration = jnp.where(occurrence > 0,
                         coverage / jnp.maximum(occurrence, 1e-20), 0.0)
    # transition counts between distinct consecutive states
    prev, nxt = labels[:-1], labels[1:]
    move = (nxt != prev).astype(jnp.float32)
    ph = (prev[None, :] == k[:, None]).astype(jnp.float32) * move[None, :]
    nh = (nxt[None, :] == k[:, None]).astype(jnp.float32)
    counts = ph @ nh.T                                  # (K, K)
    row = jnp.sum(counts, axis=1, keepdims=True)
    transitions = counts / jnp.maximum(row, 1e-20)
    return {"coverage": coverage, "occurrence": occurrence,
            "duration": duration, "transitions": transitions}


def microstate_syntax_test(labels, n_states: int, n_shuffles: int = 500,
                           seed: int = 0):
    """Directional-syntax test: is the microstate TRANSITION structure
    asymmetric (A->B more likely than B->A) beyond what the coverage
    alone predicts?

    Statistic: ``sum_{i<j} |T_ij - T_ji| / sum_{i!=j} T_ij`` over the
    distinct-transition count matrix.  Null: the transition SEQUENCE
    with the same segment counts but shuffled order (segment-level
    permutation — sample-level shuffles would destroy duration
    structure and inflate the statistic).  A shuffled segment sequence
    can place equal labels adjacently; the statistic CHANGE-COMPRESSES
    its input and normalizes by the off-diagonal transition mass, so
    observed and null draws live on the same scale (an uncompressed,
    unnormalized null loses diagonal mass that the observed — repeat-
    free by construction — never had, and goes anticonservative).
    Returns ``(asym, p)``; small p = the syntax has a preferred
    direction (Lehmann's microstate-syntax hypothesis).

    Host-side: the segment sequence is tiny (hundreds of entries), and
    permutation of a variable-length symbol list is host work by
    nature."""
    labels = np.asarray(labels)
    seq = labels[np.concatenate([[True], labels[1:] != labels[:-1]])]
    if seq.size < 3:
        raise ValueError("need at least 3 segments")
    k = int(n_states)

    def asym_of(s):
        s = s[np.concatenate([[True], s[1:] != s[:-1]])]
        if s.size < 2:
            return 0.0
        t = np.zeros((k, k))
        np.add.at(t, (s[:-1], s[1:]), 1.0)
        return float(np.abs(t - t.T)[np.triu_indices(k, 1)].sum()
                     / max(t.sum(), 1.0))

    obs = asym_of(seq)
    rng = np.random.default_rng(int(seed))
    count = 1
    for _ in range(int(n_shuffles)):
        perm = rng.permutation(seq)
        count += asym_of(perm) >= obs
    return obs, count / (int(n_shuffles) + 1)
