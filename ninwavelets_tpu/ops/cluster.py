"""Cluster-based permutation inference on time-frequency planes
(Maris & Oostenveld 2007, J Neurosci Methods 164:177) plus the
max-statistic (Nichols & Holmes) correction.

No reference counterpart (the reference stops at descriptive TFRs); this
is the standard nonparametric family-wise-error control every EEG/MEG
power analysis applies before claiming a condition effect, built here for
the engine's (epoch, F, N) single-trial planes.

Design notes:
* the ENTIRE permutation bank of t-maps is matmul work: a
  sign-flip (one-sample / paired) null needs only ``sum_e s_pe * x_e`` —
  one (P, E) @ (E, F*N) contraction per chunk (the sum of squares is
  sign-invariant); an independent two-sample null contracts {0,1} group
  indicators against x and x**2 (two matmuls);
* permutations stream through ``lax.scan`` in fixed-size chunks so device
  memory holds only ``chunk`` t-maps at a time, while each chunk is still
  one matmul-sized contraction;
* connected components batch over the chunk as a fixed-point min-label
  relaxation: 4-neighbor minimum + pointer jumping (label <- label of
  label) inside ``lax.while_loop`` — the pointer jump compresses paths,
  so convergence is ~O(log diameter) sweeps of cheap elementwise shifts;
* cluster masses are one scatter-add per map into an (F*N + 1,) bin
  table (the sentinel bin collects sub-threshold pixels); only the
  per-permutation MAX mass survives, so the null leaves the device as a
  single (P,) vector.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "t_one_sample", "t_independent", "label_components", "cluster_mass",
    "cluster_test_one_sample", "cluster_test_paired",
    "cluster_test_independent", "cluster_test_f", "f_oneway",
    "f_threshold", "max_stat_test_one_sample",
    "max_stat_test_independent", "t_threshold", "ClusterResult",
    "TfceResult", "tfce_map", "tfce_test_one_sample",
    "tfce_test_independent", "fdr_correction",
]

_CHUNK = 64  # permutations per scan step: one matmul batch, bounded memory


def _dot(a, b):
    """Exact-f32 contraction: the null's t-maps must match the observed
    map's f32 sums — DEFAULT matmul precision may run in TF32 on a GPU
    (~1e-3 rel err), and the pooled-variance cancellation amplifies it
    (power planes have mean >> std), which would bias every null."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def t_threshold(alpha: float, dof: int) -> float:
    """Two-sided Student-t critical value ``t`` with ``P(|T| > t) = alpha``.

    Exact via scipy when available (scipy is a reference dependency,
    ``setup.py:6``); otherwise the Cornish-Fisher expansion of the normal
    quantile in 1/dof (relative error < 1e-3 for dof >= 8).
    """
    p = 1.0 - alpha / 2.0
    try:
        from scipy.stats import t as _t
        return float(_t.ppf(p, dof))
    except Exception:  # pragma: no cover - scipy is normally present
        from statistics import NormalDist
        z = NormalDist().inv_cdf(p)
        g1 = (z ** 3 + z) / 4.0
        g2 = (5 * z ** 5 + 16 * z ** 3 + 3 * z) / 96.0
        return z + g1 / dof + g2 / dof ** 2


def f_threshold(alpha: float, dfn: int, dfd: int) -> float:
    """Upper-tail F critical value with ``P(F > f) = alpha`` (the F test
    is one-sided by construction).

    Exact via scipy when available; otherwise the Paulson /
    Wilson-Hilferty cube-root-chi2 approximation (measured relative
    error < 5% over alpha in [0.001, 0.05], dfn in 1..10, dfd >= 10 —
    the same graceful degradation :func:`t_threshold` offers in a
    no-scipy environment).
    """
    try:
        from scipy.stats import f as _f
        return float(_f.ppf(1.0 - alpha, dfn, dfd))
    except Exception:  # pragma: no cover - scipy is normally present
        from statistics import NormalDist
        z = NormalDist().inv_cdf(1.0 - alpha)
        # Paulson 1942: (1-b) h - (1-a) ~ z sqrt(b h^2 + a) for
        # h = F^{1/3}, a = 2/9dfn, b = 2/9dfd; solve the quadratic and
        # take the larger root.
        a, b = 2.0 / (9.0 * dfn), 2.0 / (9.0 * dfd)
        qa = (1.0 - b) ** 2 - z * z * b
        qb = -2.0 * (1.0 - b) * (1.0 - a)
        qc = (1.0 - a) ** 2 - z * z * a
        if qa <= 0:  # extreme alpha/dfd where the normal tail crosses
            raise ValueError("f_threshold approximation needs scipy "
                             "for alpha=%g, dfd=%d" % (alpha, dfd))
        h = (-qb + (qb * qb - 4.0 * qa * qc) ** 0.5) / (2.0 * qa)
        return float(h ** 3)


# ---------------------------------------------------------------------------
# t statistics from matmul-friendly moments
# ---------------------------------------------------------------------------

def _t_from_sign_sums(s1: jnp.ndarray, s2: jnp.ndarray,
                      n: int) -> jnp.ndarray:
    """One-sample t from the signed sum ``s1`` and the (sign-invariant)
    sum of squares ``s2``: ``mean / sqrt(var / n)``.  Zero-variance pixels
    get t = 0 (no evidence, never +-inf)."""
    mean = s1 / n
    var = (s2 - n * mean * mean) / (n - 1)
    denom = jnp.sqrt(jnp.maximum(var, 0.0) / n)
    return jnp.where(denom > 0, mean / jnp.where(denom > 0, denom, 1.0), 0.0)


def t_one_sample(x: jnp.ndarray) -> jnp.ndarray:
    """Pixelwise one-sample t of ``x`` (E, ...) against mean zero —
    matches ``scipy.stats.ttest_1samp(x, 0)``."""
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    return _t_from_sign_sums(jnp.sum(x, 0), jnp.sum(x * x, 0), n)


def _t_pooled(s1a, s2a, s1_tot, s2_tot, na: int, nb: int) -> jnp.ndarray:
    """Pooled-variance independent-samples t from group-A sums and the
    (permutation-invariant) totals — matches ``scipy.stats.ttest_ind``
    with ``equal_var=True``."""
    ma = s1a / na
    mb = (s1_tot - s1a) / nb
    ssa = s2a - na * ma * ma
    ssb = (s2_tot - s2a) - nb * mb * mb
    sp2 = jnp.maximum(ssa + ssb, 0.0) / (na + nb - 2)
    denom = jnp.sqrt(sp2 * (1.0 / na + 1.0 / nb))
    return jnp.where(denom > 0, (ma - mb) / jnp.where(denom > 0, denom, 1.0),
                     0.0)


def t_independent(xa: jnp.ndarray, xb: jnp.ndarray) -> jnp.ndarray:
    """Pixelwise pooled-variance two-sample t of (Ea, ...) vs (Eb, ...)."""
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    na, nb = xa.shape[0], xb.shape[0]
    s1a, s2a = jnp.sum(xa, 0), jnp.sum(xa * xa, 0)
    s1t = s1a + jnp.sum(xb, 0)
    s2t = s2a + jnp.sum(xb * xb, 0)
    return _t_pooled(s1a, s2a, s1t, s2t, na, nb)


def _t_from_r(r: jnp.ndarray, dof: int) -> jnp.ndarray:
    """Regression/correlation t from Pearson r at ``dof = E - 2`` —
    matches ``scipy.stats.linregress`` / ``pearsonr``."""
    r = jnp.clip(r, -0.999999, 0.999999)
    return r * jnp.sqrt(dof / jnp.maximum(1.0 - r * r, 1e-12))


def t_regression(x: jnp.ndarray, z) -> jnp.ndarray:
    """Pixelwise regression t of trial planes (E, ...) against a
    continuous per-trial covariate ``z`` (E,) — the massive-univariate
    GLM slope statistic (identical t to the Pearson correlation)."""
    x = jnp.asarray(x, jnp.float32)
    z = jnp.asarray(z, jnp.float32)
    e = x.shape[0]
    zc = z - jnp.mean(z)
    xc = x - jnp.mean(x, 0)
    num = jnp.tensordot(zc, xc, axes=(0, 0))
    den = jnp.sqrt(jnp.maximum(jnp.sum(zc * zc)
                               * jnp.sum(xc * xc, 0), 1e-30))
    return _t_from_r(num / den, e - 2)


def _f_from_group_sums(sg: jnp.ndarray, sizes: tuple,
                       sst: jnp.ndarray) -> jnp.ndarray:
    """One-way F maps from per-group sums of GRAND-CENTERED data.

    ``sg`` is (..., G, M) (M = flattened plane) and ``sst`` (M,);
    centering makes the grand sum exactly zero (and permutation-
    invariant), so ``SS_between = sum_g S_g^2/n_g`` with no grand-term
    cancellation, and ``SS_total = sum x^2`` is permutation-invariant.
    ``F = (SSB/(G-1)) / ((SST-SSB)/(n-G))``.
    """
    g = len(sizes)
    n = sum(sizes)
    inv = jnp.asarray([1.0 / s for s in sizes], jnp.float32)
    ssb = jnp.sum(sg * sg * inv[:, None], axis=-2)
    ssw = jnp.maximum(sst - ssb, 1e-30)
    return (ssb / (g - 1)) / (ssw / (n - g))


def f_oneway(groups) -> jnp.ndarray:
    """Pixelwise one-way ANOVA F over a sequence of (E_g, ...) trial
    stacks (the multi-condition analogue of ``t_independent``)."""
    groups = [jnp.asarray(x, jnp.float32) for x in groups]
    sizes = tuple(int(x.shape[0]) for x in groups)
    x = jnp.concatenate(groups, 0)
    return _f_oneway_jit(x, sizes=sizes)


@partial(jax.jit, static_argnames=("sizes",))
def _f_oneway_jit(x, *, sizes: tuple):
    plane = x.shape[1:]
    xc = (x - jnp.mean(x, 0)).reshape(x.shape[0], -1)
    sst = jnp.sum(xc * xc, 0)
    starts = np.cumsum((0,) + sizes[:-1])
    sg = jnp.stack([jnp.sum(xc[int(s):int(s) + sz], 0)
                    for s, sz in zip(starts, sizes)], axis=0)  # (G, M)
    return _f_from_group_sums(sg, sizes, sst).reshape(plane)


# ---------------------------------------------------------------------------
# connected components + cluster mass (batched over leading axes)
# ---------------------------------------------------------------------------

def _plane_ndim(adjacency) -> int:
    """Cluster-plane rank: (F, N) alone, or (C, F, N) when a channel
    adjacency couples a leading sensor axis."""
    return 2 if adjacency is None else 3


def label_components(mask: jnp.ndarray, adjacency=None) -> jnp.ndarray:
    """Connected-component labels of a boolean mask: 4-connectivity over
    the trailing (F, N) plane, plus — when ``adjacency`` (an (M, 2) int
    array of undirected channel edges) is given — same-pixel links
    between adjacent channels of a (..., C, F, N) mask (the
    spatio-spectral clustering of MNE's spatio_temporal_cluster_test).

    Each True pixel gets the MINIMUM flat plane index of its component;
    False pixels get the sentinel (the plane size).  Batched over all
    leading axes.

    Fixed-point iteration: each sweep takes the minimum over the
    4-neighborhood (and the channel edges via two scatter-mins), then
    compresses paths by one pointer jump (label <- label[label]), so
    long snakes converge in ~log(diameter) sweeps instead of diameter.
    """
    mask = jnp.asarray(mask, bool)
    pnd = _plane_ndim(adjacency)
    fn = int(np.prod(mask.shape[-pnd:]))
    sentinel = jnp.int32(fn)
    idx = jnp.arange(fn, dtype=jnp.int32).reshape(mask.shape[-pnd:])
    lab0 = jnp.where(mask, idx, sentinel)

    big = sentinel  # > any real label, safe pad for the neighbor minimum
    if adjacency is not None:
        edges = jnp.asarray(adjacency, jnp.int32).reshape(-1, 2)
        e_u, e_v = edges[:, 0], edges[:, 1]

    def neighbor_min(lab):
        up = jnp.concatenate([lab[..., 1:, :],
                              jnp.full_like(lab[..., :1, :], big)], -2)
        dn = jnp.concatenate([jnp.full_like(lab[..., :1, :], big),
                              lab[..., :-1, :]], -2)
        lf = jnp.concatenate([lab[..., :, 1:],
                              jnp.full_like(lab[..., :, :1], big)], -1)
        rt = jnp.concatenate([jnp.full_like(lab[..., :, :1], big),
                              lab[..., :, :-1]], -1)
        nb = jnp.minimum(jnp.minimum(up, dn), jnp.minimum(lf, rt))
        if adjacency is not None:
            ch = jnp.full_like(lab, big)
            ch = ch.at[..., e_v, :, :].min(jnp.take(lab, e_u, axis=-3))
            ch = ch.at[..., e_u, :, :].min(jnp.take(lab, e_v, axis=-3))
            nb = jnp.minimum(nb, ch)
        return nb

    def jump(lab):
        flat = lab.reshape(*lab.shape[:-pnd], fn)
        padded = jnp.concatenate(
            [flat, jnp.full((*flat.shape[:-1], 1), sentinel, flat.dtype)],
            -1)
        jumped = jnp.take_along_axis(padded, flat, axis=-1)
        return jumped.reshape(lab.shape)

    def body(state):
        # 4 cheap shift+min sweeps, then ONE pointer jump only if the
        # sweeps still changed anything: the jump's take_along_axis
        # gather is far dearer than a plain sweep, and threshold masks
        # converge in ~10-15 plain sweeps — the jump exists for pathological long
        # components (it keeps worst-case depth logarithmic) and is the
        # identity at the fixed point, so gating it is exact.
        lab, _ = state
        new = lab
        for _ in range(4):
            new = jnp.where(mask, jnp.minimum(new, neighbor_min(new)),
                            sentinel)
        changed = jnp.any(new != lab)
        new = lax.cond(changed,
                       lambda l: jnp.where(mask, jump(l), sentinel),
                       lambda l: l, new)
        return new, changed

    def cond(state):
        return state[1]

    # A 12-sweep jump-free prologue BEFORE the while_loop: threshold
    # masks usually converge within it, so the expensive jump gather
    # never runs at all; it also derives the carried "changed" flag from
    # the data (under shard_map a literal True would be unvarying while
    # the body's output is varying, and the loop would reject the carry
    # — the lax.pcast gotcha).
    lab = lab0
    for _ in range(12):
        lab = jnp.where(mask, jnp.minimum(lab, neighbor_min(lab)),
                        sentinel)
    lab, _ = lax.while_loop(cond, body, (lab, jnp.any(lab != lab0)))
    return lab


def _mass_bins(vals: jnp.ndarray, labels: jnp.ndarray, fn: int,
               plane_ndim: int = 2):
    """Scatter-add ``vals`` by component label into (..., fn + 1) bins
    (sentinel pixels land in the trailing garbage bin)."""
    flat_v = vals.reshape(*vals.shape[:-plane_ndim], fn)
    flat_l = labels.reshape(*labels.shape[:-plane_ndim], fn)
    batch = flat_v.shape[:-1]
    bins = jnp.zeros((*batch, fn + 1), flat_v.dtype)
    if batch:
        b = int(np.prod(batch))
        bins = bins.reshape(b, fn + 1).at[
            jnp.arange(b)[:, None],
            flat_l.reshape(b, fn)].add(flat_v.reshape(b, fn))
        return bins.reshape(*batch, fn + 1)
    return bins.at[flat_l].add(flat_v)


def cluster_mass(tmap: jnp.ndarray, threshold: float, adjacency=None):
    """Two-sided cluster decomposition of a (..., F, N) t-map (or
    (..., C, F, N) with channel ``adjacency`` edges).

    Positive (t > thr) and negative (t < -thr) excursions are clustered
    SEPARATELY (same-sign pixels only, the Maris-Oostenveld convention);
    mass = sum of |t| over the component.  Returns
    ``(pos_labels, neg_labels, pos_bins, neg_bins, max_mass)`` where the
    bins are per-component masses indexed by root label and ``max_mass``
    is the per-map maximum over BOTH signs (the null statistic).
    """
    pnd = _plane_ndim(adjacency)
    fn = int(np.prod(tmap.shape[-pnd:]))
    pos_l = label_components(tmap > threshold, adjacency)
    neg_l = label_components(tmap < -threshold, adjacency)
    pos_b = _mass_bins(jnp.where(tmap > threshold, tmap, 0.0), pos_l, fn,
                       pnd)
    neg_b = _mass_bins(jnp.where(tmap < -threshold, -tmap, 0.0), neg_l, fn,
                       pnd)
    max_mass = jnp.maximum(jnp.max(pos_b[..., :fn], -1),
                           jnp.max(neg_b[..., :fn], -1))
    return pos_l, neg_l, pos_b, neg_b, max_mass


def tfce_map(tmap: jnp.ndarray, start: float = 0.2, step: float = 0.4,
             stop: float = 40.0, e: float = 0.5,
             h: float = 2.0, adjacency=None) -> jnp.ndarray:
    """Signed two-sided TFCE enhancement of a (..., F, N) t-map (Smith &
    Nichols 2009): at each ladder level ``l`` every suprathreshold pixel
    accrues ``extent(l)**e * l**h * step`` where ``extent`` is the size
    of its 4-connected component; negative excursions are enhanced on
    ``-t`` and subtracted.  Removes the arbitrary cluster-forming
    threshold of the mass statistic.

    The ladder is STATIC (host ``arange(start, stop, step)``) so the
    whole enhancement is one ``lax.scan`` of batched labelings; levels
    above the map's max contribute exactly 0 (empty masks), so a
    generous ``stop`` only costs compute, never correctness — but both
    the observed map and the null must use the SAME ladder.
    """
    tmap = jnp.asarray(tmap, jnp.float32)
    pnd = _plane_ndim(adjacency)
    fn = int(np.prod(tmap.shape[-pnd:]))
    levels = jnp.asarray(np.arange(start, stop, step), jnp.float32)

    def enhance(signed):
        def body(acc, lvl):
            mask = signed > lvl
            labels = label_components(mask, adjacency)
            counts = _mass_bins(mask.astype(jnp.float32), labels, fn, pnd)
            flat_l = labels.reshape(*labels.shape[:-pnd], fn)
            ext = jnp.take_along_axis(counts, flat_l, -1) \
                .reshape(labels.shape)
            gain = jnp.where(mask, ext ** e * lvl ** h * step, 0.0)
            return acc + gain, None

        out, _ = lax.scan(body, jnp.zeros_like(signed), levels)
        return out

    return enhance(tmap) - enhance(-tmap)


# ---------------------------------------------------------------------------
# permutation nulls (scan over fixed-size chunks of the matmul contraction)
# ---------------------------------------------------------------------------

def _pad_perms(n_perm: int, chunk: int) -> int:
    return -(-n_perm // chunk)


def _null_scan(per_chunk, n_chunks: int, n_perm: int):
    """Run ``per_chunk(chunk_index) -> (chunk,) max masses`` over all
    chunks with ``lax.scan`` and trim the padding tail."""
    def step(_, k):
        return 0, per_chunk(k)

    _, out = lax.scan(step, 0, jnp.arange(n_chunks))
    return out.reshape(-1)[:n_perm]


def sign_chunk_max_mass(signs: jnp.ndarray, xf: jnp.ndarray,
                        s2: jnp.ndarray, n_obs: int, threshold: float,
                        plane: tuple, adjacency=None) -> jnp.ndarray:
    """Max cluster mass of every sign-flip t-map in one chunk: the
    (chunk, E) @ (E, prod(plane)) matmul contraction + clustering (``plane``
    is (F, N), or (C, F, N) with channel ``adjacency``).  Shared by the
    single-device scan and the mesh-sharded null."""
    t = _t_from_sign_sums(_dot(signs, xf), s2, n_obs).reshape(-1, *plane)
    return cluster_mass(t, threshold, adjacency)[4]


def relabel_chunk_max_mass(ind: jnp.ndarray, xf: jnp.ndarray,
                           x2f: jnp.ndarray, s1t: jnp.ndarray,
                           s2t: jnp.ndarray, na: int, nb: int,
                           threshold: float, plane: tuple,
                           adjacency=None) -> jnp.ndarray:
    """Max cluster mass of every relabeling t-map in one chunk (two
    indicator matmuls).  Shared with the mesh-sharded null."""
    t = _t_pooled(_dot(ind, xf), _dot(ind, x2f), s1t, s2t, na,
                  nb).reshape(-1, *plane)
    return cluster_mass(t, threshold, adjacency)[4]


def sign_draws(key, n_perm: int, n_obs: int,
               chunk: int = _CHUNK) -> jnp.ndarray:
    """(n_chunks, chunk, E) rademacher sign draws — the canonical draw
    both the single-device and the sharded null consume, so the two
    paths produce IDENTICAL permutation sets for a given key."""
    n_chunks = _pad_perms(n_perm, chunk)
    return jax.random.rademacher(
        key, (n_chunks * chunk, n_obs), jnp.float32
    ).reshape(n_chunks, chunk, n_obs)


def relabel_draws(key, n_perm: int, n_obs: int, na: int,
                  chunk: int = _CHUNK) -> jnp.ndarray:
    """(n_chunks, chunk, E) {0,1} group-A indicator draws (canonical for
    both the single-device and the sharded null)."""
    n_chunks = _pad_perms(n_perm, chunk)
    total = n_chunks * chunk
    keys = jax.random.split(key, total)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n_obs))(keys)
    ind = jnp.zeros((total, n_obs), jnp.float32).at[
        jnp.arange(total)[:, None], perms[:, :na]].set(1.0)
    return ind.reshape(n_chunks, chunk, n_obs)


def anova_draws(key, n_perm: int, sizes: tuple,
                chunk: int = _CHUNK) -> jnp.ndarray:
    """(n_chunks, chunk, G, E) one-hot group indicators under label
    permutations of the concatenated stack (canonical draws shared by
    the single-device and sharded F nulls)."""
    n_chunks = _pad_perms(n_perm, chunk)
    total = n_chunks * chunk
    n = sum(sizes)
    base = np.repeat(np.arange(len(sizes)), sizes)
    keys = jax.random.split(key, total)
    labs = jax.vmap(lambda k: jax.random.permutation(
        k, jnp.asarray(base)))(keys)
    ind = jax.nn.one_hot(labs, len(sizes), axis=1, dtype=jnp.float32)
    return ind.reshape(n_chunks, chunk, len(sizes), n)


def anova_chunk_max_mass(ind: jnp.ndarray, xf: jnp.ndarray,
                         sst: jnp.ndarray, sizes: tuple,
                         threshold: float, plane: tuple,
                         adjacency=None) -> jnp.ndarray:
    """Max cluster mass of every relabeled F-map in one chunk: group
    sums are ONE (chunk*G, E) @ (E, M) matmul over the grand-centered
    stack; SS_total is permutation-invariant."""
    ch, g, e = ind.shape
    sg = _dot(ind.reshape(ch * g, e), xf).reshape(ch, g, -1)
    f = _f_from_group_sums(sg, sizes, sst).reshape(-1, *plane)
    return cluster_mass(f, threshold, adjacency)[4]


@partial(jax.jit, static_argnames=("n_perm", "threshold", "sizes",
                                   "chunk"))
def _anova_null(x: jnp.ndarray, key, *, n_perm: int, threshold: float,
                sizes: tuple, chunk: int = _CHUNK,
                adjacency=None) -> jnp.ndarray:
    """(P,) null of max cluster masses under group relabelings of the
    concatenated (E, ...) stack (one-way F)."""
    e, plane = x.shape[0], x.shape[1:]
    xf = (x - jnp.mean(x, 0)).reshape(e, -1)
    sst = jnp.sum(xf * xf, 0)
    n_chunks = _pad_perms(n_perm, chunk)
    draws = anova_draws(key, n_perm, sizes, chunk)

    def per_chunk(k):
        return anova_chunk_max_mass(draws[k], xf, sst, sizes, threshold,
                                    plane, adjacency)

    return _null_scan(per_chunk, n_chunks, n_perm)


@partial(jax.jit, static_argnames=("n_perm", "threshold", "chunk"))
def _sign_flip_null(x: jnp.ndarray, key, *, n_perm: int, threshold: float,
                    chunk: int = _CHUNK, adjacency=None) -> jnp.ndarray:
    """(P,) null of max cluster masses under epoch sign flips.

    ``x`` is (E, F, N) — or (E, C, F, N) with channel ``adjacency``
    edges; each chunk's t-maps come from ONE (chunk, E) @ (E, plane)
    matmul — the sum of squares is shared.
    """
    e, plane = x.shape[0], x.shape[1:]
    xf = x.reshape(e, -1)
    s2 = jnp.sum(xf * xf, 0)  # sign-invariant
    n_chunks = _pad_perms(n_perm, chunk)
    signs = sign_draws(key, n_perm, e, chunk)

    def per_chunk(k):
        return sign_chunk_max_mass(signs[k], xf, s2, e, threshold, plane,
                                   adjacency)

    return _null_scan(per_chunk, n_chunks, n_perm)


def regression_draws(key, n_perm: int, zc: jnp.ndarray,
                     chunk: int) -> jnp.ndarray:
    """(chunks, chunk, E) rows of PERMUTED centered covariate values —
    the exchangeability scheme for a continuous regressor (Maris &
    Oostenveld: shuffle the covariate across trials)."""
    n_chunks = _pad_perms(n_perm, chunk)
    keys = jax.random.split(key, n_chunks * chunk)
    perms = jax.vmap(lambda k: jax.random.permutation(k, zc))(keys)
    return perms.reshape(n_chunks, chunk, zc.shape[0])


def regression_chunk_max_mass(zp: jnp.ndarray, xf: jnp.ndarray,
                              x2: jnp.ndarray, z2, dof: int,
                              threshold: float, plane: tuple,
                              adjacency=None) -> jnp.ndarray:
    """Max cluster mass of every permuted-covariate t-map in one chunk:
    the numerators are ONE (chunk, E) @ (E, plane) matmul; the variance
    terms are permutation-invariant."""
    num = _dot(zp, xf)
    r = num / jnp.sqrt(jnp.maximum(z2 * x2, 1e-30))
    t = _t_from_r(r, dof).reshape(-1, *plane)
    return cluster_mass(t, threshold, adjacency)[4]


@partial(jax.jit, static_argnames=("n_perm", "threshold", "chunk"))
def _regression_null(x: jnp.ndarray, z: jnp.ndarray, key, *, n_perm: int,
                     threshold: float, chunk: int = _CHUNK,
                     adjacency=None) -> jnp.ndarray:
    """(P,) null of max cluster masses under covariate shuffles."""
    e, plane = x.shape[0], x.shape[1:]
    zc = z - jnp.mean(z)
    xc = (x - jnp.mean(x, 0)).reshape(e, -1)
    x2 = jnp.sum(xc * xc, 0)
    z2 = jnp.sum(zc * zc)
    n_chunks = _pad_perms(n_perm, chunk)
    draws = regression_draws(key, n_perm, zc, chunk)

    def per_chunk(k):
        return regression_chunk_max_mass(draws[k], xc, x2, z2, e - 2,
                                         threshold, plane, adjacency)

    return _null_scan(per_chunk, n_chunks, n_perm)


@partial(jax.jit, static_argnames=("n_perm", "threshold", "na", "chunk"))
def _relabel_null(x: jnp.ndarray, key, *, n_perm: int, threshold: float,
                  na: int, chunk: int = _CHUNK,
                  adjacency=None) -> jnp.ndarray:
    """(P,) null of max cluster masses under label permutations of the
    concatenated (E, F, N) stack (first ``na`` = group A).

    Group-A sums/squares under every relabeling are TWO indicator
    matmuls per chunk; the totals are permutation-invariant.
    """
    e, plane = x.shape[0], x.shape[1:]
    nb = e - na
    xf = x.reshape(e, -1)
    x2f = xf * xf
    s1t = jnp.sum(xf, 0)
    s2t = jnp.sum(x2f, 0)
    n_chunks = _pad_perms(n_perm, chunk)
    ind = relabel_draws(key, n_perm, e, na, chunk)

    def per_chunk(k):
        return relabel_chunk_max_mass(ind[k], xf, x2f, s1t, s2t, na, nb,
                                      threshold, plane, adjacency)

    return _null_scan(per_chunk, n_chunks, n_perm)


# ---------------------------------------------------------------------------
# observed decomposition + results
# ---------------------------------------------------------------------------

class ClusterResult(NamedTuple):
    """Outcome of a cluster permutation test on an (F, N) plane.

    ``p_map`` holds, at every suprathreshold pixel, the corrected p-value
    of the cluster containing it (1.0 elsewhere); ``mass_map`` the SIGNED
    mass of that cluster; ``clusters`` a host-side list of
    ``{"sign", "mass", "size", "p"}`` dicts sorted by p; ``null_max`` the
    (P,) permutation distribution of the max cluster mass.
    """
    t_obs: np.ndarray
    threshold: float
    p_map: np.ndarray
    mass_map: np.ndarray
    null_max: np.ndarray
    clusters: list


@partial(jax.jit, static_argnames=("threshold",))
def _observed_maps(t_obs: jnp.ndarray, null_max: jnp.ndarray,
                   *, threshold: float, adjacency=None):
    """Per-pixel corrected p and signed mass maps of the observed t-map
    against the permutation null (the +1/(P+1) convention counts the
    observed arrangement as one permutation)."""
    fn = t_obs.size
    pos_l, neg_l, pos_b, neg_b, _ = cluster_mass(t_obs, threshold,
                                                 adjacency)
    pos_mass = jnp.take(pos_b, pos_l.reshape(fn)).reshape(t_obs.shape)
    neg_mass = jnp.take(neg_b, neg_l.reshape(fn)).reshape(t_obs.shape)
    mass_map = jnp.where(pos_l < fn, pos_mass, 0.0) \
        - jnp.where(neg_l < fn, neg_mass, 0.0)
    abs_mass = jnp.abs(mass_map)
    p = jnp.float32(null_max.shape[0] + 1)
    counts = jnp.sum(null_max >= abs_mass[..., None], -1)
    p_map = jnp.where(abs_mass > 0, (counts + 1.0) / p, 1.0)
    return p_map, mass_map, pos_l, neg_l


def _finish(t_obs, null_max, threshold: float,
            adjacency=None) -> ClusterResult:
    p_map, mass_map, pos_l, neg_l = _observed_maps(
        t_obs, null_max, threshold=float(threshold), adjacency=adjacency)
    t_h = np.asarray(t_obs)
    p_h = np.asarray(p_map)
    m_h = np.asarray(mass_map)
    clusters = []
    fn = t_h.size
    for labels, sign in ((np.asarray(pos_l), 1), (np.asarray(neg_l), -1)):
        for root in np.unique(labels[labels < fn]):
            sel = labels == root
            clusters.append({
                "sign": sign,
                "mass": float(abs(m_h[sel].flat[0])),
                "size": int(sel.sum()),
                "p": float(p_h[sel].flat[0]),
            })
    clusters.sort(key=lambda c: (c["p"], -c["mass"]))
    return ClusterResult(t_h, float(threshold), p_h, m_h,
                         np.asarray(null_max), clusters)


def _resolve_threshold(threshold, alpha, dof) -> float:
    if threshold is not None:
        return float(threshold)
    return t_threshold(alpha, dof)


def _check_stack(x, adjacency, name="x"):
    want = 3 + (0 if adjacency is None else 1)
    if x.ndim != want:
        raise ValueError(
            "%s: expected %s, got shape %s" % (
                name,
                "(epochs, F, N)" if want == 3
                else "(epochs, C, F, N) with channel adjacency",
                (x.shape,)))


def cluster_test_one_sample(x, n_perm: int = 999,
                            threshold: Optional[float] = None,
                            alpha: float = 0.05,
                            seed: int = 0,
                            null_max: Optional[jnp.ndarray] = None,
                            adjacency=None) -> ClusterResult:
    """Cluster permutation test of ``mean(x) != 0`` over (E, F, N)
    single-trial planes, with epoch sign flips as the exchangeable null
    (valid when each trial's map is symmetric about 0 under H0 — e.g.
    baseline-corrected power or a paired difference).

    ``threshold`` defaults to the two-sided t critical value at ``alpha``
    with E-1 degrees of freedom.  ``null_max`` lets a precomputed
    (sharded) null be reused.  With ``adjacency`` — an (M, 2) array of
    undirected channel edges (an empty list keeps channels independent) —
    ``x`` is (E, C, F, N) and clusters extend across adjacent channels
    (spatio-spectral clustering).
    """
    x = jnp.asarray(x, jnp.float32)
    _check_stack(x, adjacency)
    if x.shape[0] < 2:
        raise ValueError("need at least 2 epochs")
    thr = _resolve_threshold(threshold, alpha, x.shape[0] - 1)
    if null_max is None:
        null_max = _sign_flip_null(x, jax.random.PRNGKey(seed),
                                   n_perm=n_perm, threshold=thr,
                                   adjacency=adjacency)
    return _finish(t_one_sample(x), null_max, thr, adjacency)


def cluster_test_paired(xa, xb, **kw) -> ClusterResult:
    """Paired-samples cluster test: the one-sample sign-flip test on the
    per-epoch difference ``xa - xb`` (epochs must correspond)."""
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.shape != xb.shape:
        raise ValueError("paired conditions must have equal shapes")
    return cluster_test_one_sample(xa - xb, **kw)


def cluster_test_regression(x, z, n_perm: int = 999,
                            threshold: Optional[float] = None,
                            alpha: float = 0.05, seed: int = 0,
                            null_max: Optional[jnp.ndarray] = None,
                            adjacency=None) -> ClusterResult:
    """Cluster permutation test of a CONTINUOUS per-trial covariate
    (reaction time, stimulus intensity, age...) against single-trial
    planes: pixelwise regression t (= Pearson-r t, dof E-2), covariate
    values shuffled across trials for the null (Maris & Oostenveld's
    exchangeability argument applies unchanged).  ``x`` is (E, F, N) —
    or (E, C, F, N) with channel ``adjacency``; ``z`` is (E,)."""
    x = jnp.asarray(x, jnp.float32)
    z = jnp.asarray(z, jnp.float32)
    _check_stack(x, adjacency, "x")
    e = x.shape[0]
    if z.shape != (e,):
        raise ValueError(f"covariate must be ({e},), got {z.shape}")
    if e < 4:
        raise ValueError("regression needs at least 4 trials")
    thr = _resolve_threshold(threshold, alpha, e - 2)
    if null_max is None:
        null_max = _regression_null(x, z, jax.random.PRNGKey(seed),
                                    n_perm=n_perm, threshold=thr,
                                    adjacency=adjacency)
    return _finish(t_regression(x, z), null_max, thr, adjacency)


def cluster_test_independent(xa, xb, n_perm: int = 999,
                             threshold: Optional[float] = None,
                             alpha: float = 0.05,
                             seed: int = 0,
                             null_max: Optional[jnp.ndarray] = None,
                             adjacency=None) -> ClusterResult:
    """Cluster permutation test of equal means between independent trial
    groups (Ea, F, N) vs (Eb, F, N): pooled-variance t, condition labels
    permuted across the concatenated stack.  With ``adjacency`` the
    groups are (E, C, F, N) and clusters extend across channel edges."""
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    _check_stack(xa, adjacency, "xa")
    _check_stack(xb, adjacency, "xb")
    if xa.shape[1:] != xb.shape[1:]:
        raise ValueError("group planes must match, got %s and %s"
                         % (xa.shape, xb.shape))
    na, nb = xa.shape[0], xb.shape[0]
    if na < 2 or nb < 2:
        raise ValueError("need at least 2 epochs per group")
    thr = _resolve_threshold(threshold, alpha, na + nb - 2)
    if null_max is None:
        null_max = _relabel_null(jnp.concatenate([xa, xb], 0),
                                 jax.random.PRNGKey(seed),
                                 n_perm=n_perm, threshold=thr, na=na,
                                 adjacency=adjacency)
    return _finish(t_independent(xa, xb), null_max, thr, adjacency)


def cluster_test_f(groups, n_perm: int = 999,
                   threshold: Optional[float] = None,
                   alpha: float = 0.05, seed: int = 0,
                   null_max: Optional[jnp.ndarray] = None,
                   adjacency=None) -> ClusterResult:
    """Cluster permutation test of equal means across G >= 2 independent
    trial groups (one-way ANOVA, the multi-condition generalization of
    ``cluster_test_independent``): pixelwise F maps, condition labels
    permuted across the concatenated stack (Maris & Oostenveld).  Each
    group is (E_g, F, N) — or (E_g, C, F, N) with channel ``adjacency``.

    ``threshold`` defaults to the F critical value at ``alpha`` with
    (G-1, n-G) degrees of freedom.  F is one-sided, so all clusters are
    positive; the returned ``ClusterResult.t_obs`` holds the F map.
    """
    groups = [jnp.asarray(x, jnp.float32) for x in groups]
    if len(groups) < 2:
        raise ValueError("need at least 2 groups")
    for x in groups:
        _check_stack(x, adjacency, "group")
        if x.shape[0] < 2:
            raise ValueError("need at least 2 epochs per group")
    plane = groups[0].shape[1:]
    if any(x.shape[1:] != plane for x in groups):
        raise ValueError("group planes must match")
    sizes = tuple(int(x.shape[0]) for x in groups)
    n = sum(sizes)
    g = len(sizes)
    if threshold is None:
        threshold = f_threshold(alpha, g - 1, n - g)
    thr = float(threshold)
    x = jnp.concatenate(groups, 0)
    if null_max is None:
        null_max = _anova_null(x, jax.random.PRNGKey(seed),
                               n_perm=n_perm, threshold=thr,
                               sizes=sizes, adjacency=adjacency)
    return _finish(_f_oneway_jit(x, sizes=sizes), null_max, thr,
                   adjacency)


# ---------------------------------------------------------------------------
# TFCE permutation tests (pixelwise corrected p, no threshold choice)
# ---------------------------------------------------------------------------

class TfceResult(NamedTuple):
    """Outcome of a TFCE permutation test: ``p_map`` is the pixelwise
    FWER-corrected p-value of the signed enhancement ``tfce_obs`` against
    the (P,) null of max-|TFCE| values."""
    t_obs: np.ndarray
    tfce_obs: np.ndarray
    p_map: np.ndarray
    null_max: np.ndarray


_TFCE_KEYS = ("start", "step", "stop", "e", "h")


@partial(jax.jit, static_argnames=("n_perm", "chunk") + _TFCE_KEYS)
def _sign_flip_tfce_null(x, key, *, n_perm: int, chunk: int = _CHUNK,
                         start: float = 0.2, step: float = 0.4,
                         stop: float = 40.0, e: float = 0.5,
                         h: float = 2.0, adjacency=None):
    ne, plane = x.shape[0], x.shape[1:]
    xf = x.reshape(ne, -1)
    s2 = jnp.sum(xf * xf, 0)
    n_chunks = _pad_perms(n_perm, chunk)
    signs = sign_draws(key, n_perm, ne, chunk)

    def per_chunk(k):
        t = _t_from_sign_sums(_dot(signs[k], xf), s2,
                              ne).reshape(chunk, *plane)
        enh = tfce_map(t, start, step, stop, e, h, adjacency)
        return jnp.max(jnp.abs(enh).reshape(chunk, -1), -1)

    return _null_scan(per_chunk, n_chunks, n_perm)


@partial(jax.jit, static_argnames=("n_perm", "na", "chunk") + _TFCE_KEYS)
def _relabel_tfce_null(x, key, *, n_perm: int, na: int,
                       chunk: int = _CHUNK, start: float = 0.2,
                       step: float = 0.4, stop: float = 40.0,
                       e: float = 0.5, h: float = 2.0, adjacency=None):
    ne, plane = x.shape[0], x.shape[1:]
    nb = ne - na
    xf = x.reshape(ne, -1)
    x2f = xf * xf
    s1t, s2t = jnp.sum(xf, 0), jnp.sum(x2f, 0)
    n_chunks = _pad_perms(n_perm, chunk)
    ind = relabel_draws(key, n_perm, ne, na, chunk)

    def per_chunk(k):
        t = _t_pooled(_dot(ind[k], xf), _dot(ind[k], x2f), s1t, s2t, na,
                      nb).reshape(chunk, *plane)
        enh = tfce_map(t, start, step, stop, e, h, adjacency)
        return jnp.max(jnp.abs(enh).reshape(chunk, -1), -1)

    return _null_scan(per_chunk, n_chunks, n_perm)


def _tfce_finish(t_obs, null_max, kw, adjacency=None) -> TfceResult:
    enh = tfce_map(t_obs, adjacency=adjacency, **kw)
    p = (jnp.sum(null_max[None, None, :] >= jnp.abs(enh)[..., None], -1)
         + 1.0) / (null_max.shape[0] + 1.0)
    return TfceResult(np.asarray(t_obs), np.asarray(enh), np.asarray(p),
                      np.asarray(null_max))


def tfce_test_one_sample(x, n_perm: int = 199, seed: int = 0,
                         start: float = 0.2, step: float = 0.4,
                         stop: float = 40.0, e: float = 0.5,
                         h: float = 2.0, adjacency=None) -> TfceResult:
    """TFCE permutation test of ``mean(x) != 0`` over (E, F, N) trial
    planes (sign-flip null) — threshold-free alternative to
    ``cluster_test_one_sample`` with pixelwise corrected p-values.
    Costs ~``(stop-start)/step`` labelings per permutation map; lower
    ``n_perm``/coarser ladders trade resolution for speed.
    """
    x = jnp.asarray(x, jnp.float32)
    _check_stack(x, adjacency)
    if x.shape[0] < 2:
        raise ValueError("need at least 2 epochs")
    kw = dict(start=start, step=step, stop=stop, e=e, h=h)
    null = _sign_flip_tfce_null(x, jax.random.PRNGKey(seed),
                                n_perm=n_perm, adjacency=adjacency, **kw)
    return _tfce_finish(t_one_sample(x), null, kw, adjacency)


def tfce_test_independent(xa, xb, n_perm: int = 199, seed: int = 0,
                          start: float = 0.2, step: float = 0.4,
                          stop: float = 40.0, e: float = 0.5,
                          h: float = 2.0, adjacency=None) -> TfceResult:
    """TFCE permutation test between independent trial groups
    (relabeling null, pooled-variance t).  With ``adjacency`` the groups
    are (E, C, F, N) and the enhancement extends across channel edges."""
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    _check_stack(xa, adjacency, "xa")
    _check_stack(xb, adjacency, "xb")
    if xa.shape[1:] != xb.shape[1:]:
        raise ValueError("group planes must match, got %s and %s"
                         % (xa.shape, xb.shape))
    kw = dict(start=start, step=step, stop=stop, e=e, h=h)
    null = _relabel_tfce_null(jnp.concatenate([xa, xb], 0),
                              jax.random.PRNGKey(seed), n_perm=n_perm,
                              na=xa.shape[0], adjacency=adjacency, **kw)
    return _tfce_finish(t_independent(xa, xb), null, kw, adjacency)


# ---------------------------------------------------------------------------
# max-statistic correction (no clustering — exact pixelwise FWER)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_perm", "chunk"))
def _sign_flip_maxt(x, key, *, n_perm: int, chunk: int = _CHUNK):
    e = x.shape[0]
    xf = x.reshape(e, -1)
    s2 = jnp.sum(xf * xf, 0)
    n_chunks = _pad_perms(n_perm, chunk)
    signs = sign_draws(key, n_perm, e, chunk)

    def per_chunk(k):
        t = _t_from_sign_sums(_dot(signs[k], xf), s2, e)
        return jnp.max(jnp.abs(t), -1)

    return _null_scan(per_chunk, n_chunks, n_perm)


@partial(jax.jit, static_argnames=("n_perm", "na", "chunk"))
def _relabel_maxt(x, key, *, n_perm: int, na: int, chunk: int = _CHUNK):
    e = x.shape[0]
    nb = e - na
    xf = x.reshape(e, -1)
    x2f = xf * xf
    s1t, s2t = jnp.sum(xf, 0), jnp.sum(x2f, 0)
    n_chunks = _pad_perms(n_perm, chunk)
    ind = relabel_draws(key, n_perm, e, na, chunk)

    def per_chunk(k):
        t = _t_pooled(_dot(ind[k], xf), _dot(ind[k], x2f), s1t, s2t, na,
                      nb)
        return jnp.max(jnp.abs(t), -1)

    return _null_scan(per_chunk, n_chunks, n_perm)


def _maxt_pmap(t_obs, null):
    p = (jnp.sum(null[None, None, :]
                 >= jnp.abs(t_obs)[..., None], -1) + 1.0) / (len(null) + 1.0)
    return np.asarray(t_obs), np.asarray(p)


def max_stat_test_one_sample(x, n_perm: int = 999, seed: int = 0):
    """(t_map, p_map) under the max-|t| sign-flip null — strong pixelwise
    FWER control with zero clustering (conservative for smooth effects,
    exact for focal ones)."""
    x = jnp.asarray(x, jnp.float32)
    null = _sign_flip_maxt(x, jax.random.PRNGKey(seed), n_perm=n_perm)
    return _maxt_pmap(t_one_sample(x), null)


def max_stat_test_independent(xa, xb, n_perm: int = 999, seed: int = 0):
    """(t_map, p_map) under the max-|t| relabeling null for independent
    groups."""
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    null = _relabel_maxt(jnp.concatenate([xa, xb], 0),
                         jax.random.PRNGKey(seed), n_perm=n_perm,
                         na=xa.shape[0])
    return _maxt_pmap(t_independent(xa, xb), null)


@partial(jax.jit, static_argnames=("n_perm", "chunk"))
def _regression_maxt(x, z, key, *, n_perm: int, chunk: int = _CHUNK):
    e = x.shape[0]
    zc = z - jnp.mean(z)
    xc = (x - jnp.mean(x, 0)).reshape(e, -1)
    x2 = jnp.sum(xc * xc, 0)
    z2 = jnp.sum(zc * zc)
    n_chunks = _pad_perms(n_perm, chunk)
    draws = regression_draws(key, n_perm, zc, chunk)

    def per_chunk(k):
        r = _dot(draws[k], xc) / jnp.sqrt(jnp.maximum(z2 * x2, 1e-30))
        return jnp.max(jnp.abs(_t_from_r(r, e - 2)), -1)

    return _null_scan(per_chunk, n_chunks, n_perm)


def max_stat_test_regression(x, z, n_perm: int = 999, seed: int = 0):
    """(t_map, p_map) of a continuous covariate under the max-|t|
    covariate-shuffle null (see ``cluster_test_regression``)."""
    x = jnp.asarray(x, jnp.float32)
    z = jnp.asarray(z, jnp.float32)
    if z.shape != (x.shape[0],):
        raise ValueError(f"covariate must be ({x.shape[0]},), got "
                         f"{z.shape}")
    null = _regression_maxt(x, z, jax.random.PRNGKey(seed), n_perm=n_perm)
    return _maxt_pmap(t_regression(x, z), null)


@partial(jax.jit, static_argnames=("method",))
def _fdr_jit(flat, *, method):
    m = flat.shape[0]
    order = jnp.argsort(flat)
    ranked = jnp.take(flat, order)
    denom = jnp.arange(1, m + 1, dtype=jnp.float32)
    factor = m / denom
    if method == "by":
        factor = factor * jnp.sum(1.0 / denom)
    adj = ranked * factor
    # step-up: adjusted p_(i) = min over j >= i of p_(j) * m/j
    adj = jnp.clip(lax.cummin(adj, reverse=True), 0.0, 1.0)
    return jnp.zeros_like(flat).at[order].set(adj)


def fdr_correction(p, alpha: float = 0.05, method: str = "bh"):
    """``(reject, p_adjusted)`` — step-up false-discovery-rate control
    over every element of a p-value map of any shape: Benjamini-
    Hochberg (``"bh"``, valid under independence or positive regression
    dependence — the usual choice for TF maps) or Benjamini-Yekutieli
    (``"by"``, valid under arbitrary dependence).  The lighter-handed
    alternative to the FWER family above (cluster mass, TFCE, max-|t|)
    when per-pixel discovery matters more than familywise control;
    ``reject = p_adjusted <= alpha``.
    """
    if method not in ("bh", "by"):
        raise ValueError("method must be 'bh' or 'by'")
    p = jnp.asarray(p, jnp.float32)
    p_adj = _fdr_jit(p.reshape(-1), method=method).reshape(p.shape)
    return p_adj <= alpha, p_adj
