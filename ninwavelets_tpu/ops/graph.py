"""Weighted graph metrics over connectivity matrices — the network-
neuroscience layer (Rubinov & Sporns, NeuroImage 2010) downstream of the
engine's (F, C, C) PLV / coherence / wPLI / envelope-correlation
matrices: per-node strength, Onnela weighted clustering, shortest-path
characteristic length and global efficiency, and a degree-preserving-
null small-world index.

No reference counterpart.  Design notes:
* everything batches over the leading (frequency) axes: clustering is
  two matmuls of the cube-rooted weights (``diag(W'^3)``), shortest
  paths are a fixed ``ceil(log2(C))``-step min-plus matrix squaring
  (each step an elementwise-min over a broadcast sum — O(C^3)
  elementwise work, no data-dependent loops);
* the small-world null preserves the weight DISTRIBUTION by shuffling
  the upper-triangle weights (degree-preserving rewiring of a complete
  weighted graph = weight permutation), generated on device.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["modularity_communities",
           "strength", "clustering_onnela", "shortest_paths",
           "global_efficiency", "char_path_length", "small_worldness"]


def _clean(w: jnp.ndarray) -> jnp.ndarray:
    """Symmetrize, zero the diagonal, clip to [0, 1]-ish nonnegative."""
    w = jnp.asarray(w, jnp.float32)
    w = 0.5 * (w + jnp.swapaxes(w, -1, -2))
    w = jnp.maximum(w, 0.0)
    c = w.shape[-1]
    return w * (1.0 - jnp.eye(c, dtype=w.dtype))


def strength(w: jnp.ndarray) -> jnp.ndarray:
    """(..., C) weighted node strength: row sums of the cleaned
    (..., C, C) matrix."""
    return jnp.sum(_clean(w), axis=-1)


def clustering_onnela(w: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """(..., C) Onnela weighted clustering coefficient: with weights
    normalized by the global max, ``C_i = (W'^3)_ii / (k_i (k_i - 1))``
    where ``W' = W^(1/3)`` and ``k_i`` the binary degree (here: count of
    nonzero neighbors).  1 on a fully-connected equal-weight graph."""
    w = _clean(w)
    wmax = jnp.max(w, axis=(-2, -1), keepdims=True)
    wn = w / jnp.maximum(wmax, eps)
    wp = jnp.cbrt(wn)
    tri = jnp.diagonal(wp @ wp @ wp, axis1=-2, axis2=-1)
    k = jnp.sum((w > 0).astype(jnp.float32), axis=-1)
    denom = jnp.maximum(k * (k - 1.0), 1.0)
    return jnp.where(k > 1, tri / denom, 0.0)


def shortest_paths(w: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """(..., C, C) weighted shortest-path lengths with the standard
    connectivity-to-length map ``len = 1 / weight`` (stronger coupling =
    shorter path); zero weights are unreachable (inf, barring relays).

    Min-plus matrix squaring: ``D <- min_k D_ik + D_kj`` repeated
    ``ceil(log2(C))`` times — fixed iteration count, batched."""
    w = _clean(w)
    c = w.shape[-1]
    big = jnp.float32(1e9)
    d = jnp.where(w > eps, 1.0 / jnp.maximum(w, eps), big)
    d = jnp.where(jnp.eye(c, dtype=bool), 0.0, d)
    n_steps = max(1, int(np.ceil(np.log2(max(c - 1, 1)))))

    def step(dd, _):
        # D_ij <- min(D_ij, min_k D_ik + D_kj): (i, k, 1) + (1, k, j)
        relax = jnp.min(dd[..., :, :, None] + dd[..., None, :, :],
                        axis=-2)
        return jnp.minimum(dd, relax), None

    d, _ = lax.scan(step, d, None, length=n_steps)
    return d


def global_efficiency(w: jnp.ndarray) -> jnp.ndarray:
    """(...,) global efficiency: mean over node pairs of 1 / shortest
    path length (0 for unreachable pairs)."""
    d = shortest_paths(w)
    c = d.shape[-1]
    inv = jnp.where(d < 1e8, 1.0 / jnp.maximum(d, 1e-12), 0.0)
    off = inv * (1.0 - jnp.eye(c, dtype=inv.dtype))
    return jnp.sum(off, axis=(-2, -1)) / (c * (c - 1.0))


def char_path_length(w: jnp.ndarray) -> jnp.ndarray:
    """(...,) characteristic path length: mean shortest path over
    REACHABLE node pairs."""
    d = shortest_paths(w)
    c = d.shape[-1]
    mask = (d < 1e8) & ~jnp.eye(c, dtype=bool)
    return jnp.sum(jnp.where(mask, d, 0.0), axis=(-2, -1)) \
        / jnp.maximum(jnp.sum(mask, axis=(-2, -1)), 1.0)


@partial(jax.jit, static_argnames=("n_nulls",))
def _null_stats(w, key, *, n_nulls):
    """Mean clustering and path length of weight-shuffled nulls."""
    w = _clean(w)
    c = w.shape[-1]
    iu = jnp.triu_indices(c, 1)
    vals = w[..., iu[0], iu[1]]                       # (..., P)

    def one(k):
        perm = jax.random.permutation(k, vals.shape[-1])
        shuffled = vals[..., perm]
        out = jnp.zeros_like(w)
        out = out.at[..., iu[0], iu[1]].set(shuffled)
        out = out + jnp.swapaxes(out, -1, -2)
        return (jnp.mean(clustering_onnela(out), -1),
                char_path_length(out))

    keys = jax.random.split(key, n_nulls)
    cs, ls = jax.vmap(one)(keys)
    return jnp.mean(cs, 0), jnp.mean(ls, 0)


def small_worldness(w: jnp.ndarray, n_nulls: int = 20,
                    seed: int = 0) -> jnp.ndarray:
    """(...,) small-world index ``sigma = (C/C_null) / (L/L_null)``
    against weight-shuffled nulls (the standard benchmark: sigma > 1
    means more clustered than random at comparable path length)."""
    w = jnp.asarray(w, jnp.float32)
    c_obs = jnp.mean(clustering_onnela(w), -1)
    l_obs = char_path_length(w)
    c_null, l_null = _null_stats(w, jax.random.PRNGKey(seed),
                                 n_nulls=int(n_nulls))
    return (c_obs / jnp.maximum(c_null, 1e-12)) \
        / jnp.maximum(l_obs / jnp.maximum(l_null, 1e-12), 1e-12)


def modularity_communities(w, n_iter: int = 50):
    """Two-community split by Newman's leading-eigenvector method
    (Newman 2006, PNAS 103:8577) on a weighted undirected matrix:
    the modularity matrix ``B = W - k k^T / 2m`` (k = strengths,
    2m = total weight), its dominant eigenvector's SIGNS are the
    community labels, and the returned ``q`` is the modularity of that
    split (0 when the leading eigenvalue is non-positive — no
    community structure).

    Returns ``(labels (C,) int32 in {0, 1}, q float)``.  One symmetric
    eigendecomposition — batched-eigh-friendly like the rest of the
    module; for finer partitions apply recursively to the subgraphs
    (host-side, data-dependent shapes)."""
    w = _clean(jnp.asarray(w, jnp.float32))
    # the wpli/ppc matrices carry a NaN diagonal by convention (eps=0):
    # NaN * 0 from _clean's eye mask survives and would poison k/B/eigh
    # into a silent all-zero "no structure" answer — sanitize first
    w = jnp.where(jnp.isfinite(w), w, 0.0)
    k = jnp.sum(w, axis=-1)                            # (..., C)
    two_m = jnp.maximum(jnp.sum(k, axis=-1), 1e-20)    # (...,)
    b = w - k[..., :, None] * k[..., None, :] \
        / two_m[..., None, None]
    bs = 0.5 * (b + jnp.swapaxes(b, -1, -2))
    vals, vecs = jnp.linalg.eigh(bs)                   # batched
    lead = vecs[..., :, -1]
    s = jnp.where(lead >= 0, 1.0, -1.0)
    q = jnp.einsum("...i,...ij,...j->...", s, b, s,
                   precision=jax.lax.Precision.HIGHEST) \
        / (2.0 * two_m)
    ok = vals[..., -1] > 0
    labels = jnp.where(ok[..., None], (s > 0), False).astype(jnp.int32)
    q = jnp.where(ok, q, 0.0)
    return labels, q
