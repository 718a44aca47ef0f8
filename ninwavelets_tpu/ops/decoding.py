"""Time-frequency decoding (MVPA): cross-validated two-class decoding
from the multichannel pattern at EVERY time-frequency pixel — the
wavelet-domain analog of MNE's SlidingEstimator / temporal decoding,
answering "WHEN and at WHICH frequency does the channel pattern carry
condition information".

No reference counterpart.  The per-pixel classifier is diagonal LDA
(shrinkage to the diagonal is the standard, and for C channels with few
trials the full covariance is unestimable anyway):

    w = (mu_1 - mu_0) / (pooled_var + lam),   score = w . x

evaluated with k-fold cross-validation and scored by ROC AUC on the
held-out trials.

Design notes:
* every pixel's classifier is fit and scored SIMULTANEOUSLY — the class
  means/variances are masked reductions over the trial axis and the AUC
  is a pairwise comparison matrix, so the whole CV loop is a fixed
  ``lax.scan`` over folds of elementwise work on (E, C, F, N) blocks;
* fold assignment is a static round-robin (deterministic, no RNG needed
  — trials are exchangeable under the null the caller tests against);
* only the (F, N) AUC map (and optional per-fold maps) leave the device.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["csp_decode", "tf_decode", "decode_auc",
           "temporal_generalization", "cca_reference", "ssvep_cca"]


def _masked_stats(x, keep):
    """Mean/variance over the trial axis using only ``keep`` trials:
    x (E, ...), keep (E,) -> ((...,), (...,), count)."""
    k = keep.reshape(keep.shape + (1,) * (x.ndim - 1))
    cnt = jnp.sum(keep)
    mean = jnp.sum(x * k, 0) / jnp.maximum(cnt, 1.0)
    var = jnp.sum(jnp.square(x - mean) * k, 0) / jnp.maximum(cnt - 1.0,
                                                             1.0)
    return mean, var, cnt


def decode_auc(scores_a, scores_b, valid_a, valid_b):
    """Held-out ROC AUC per pixel from decision scores: the fraction of
    (class-a, class-b) trial pairs ranked correctly (ties count half).
    scores_* (E, ...); valid_* (E,) mask the held-out trials.

    The pairwise comparison streams one class-a trial at a time through
    a ``lax.scan`` so memory stays O(Eb * plane) — a materialized
    (Ea, Eb, plane) tensor OOMs at ordinary trial counts."""
    ones = (1,) * (scores_b.ndim - 1)
    vb = valid_b.reshape(valid_b.shape + ones)

    def one_a(acc, ab):
        sa_i, va_i = ab
        diff = sa_i[None] - scores_b                    # (Eb, ...)
        wins = jnp.where(diff > 0, 1.0, jnp.where(diff == 0, 0.5, 0.0))
        return acc + va_i * jnp.sum(wins * vb, 0), None

    total, _ = lax.scan(one_a, jnp.zeros_like(scores_b[0]),
                        (scores_a, valid_a))
    n_pairs = jnp.maximum(jnp.sum(valid_a) * jnp.sum(valid_b), 1.0)
    return total / n_pairs


@partial(jax.jit, static_argnames=("n_folds", "lam", "vma_axes"))
def _tf_decode_jit(xa, xb, *, n_folds, lam, vma_axes=()):
    ea, eb = xa.shape[0], xb.shape[0]
    fold_a = jnp.arange(ea) % n_folds
    fold_b = jnp.arange(eb) % n_folds

    def fold(acc, f):
        tr_a = (fold_a != f).astype(jnp.float32)
        tr_b = (fold_b != f).astype(jnp.float32)
        te_a = 1.0 - tr_a
        te_b = 1.0 - tr_b
        m0, v0, n0 = _masked_stats(xa, tr_a)
        m1, v1, n1 = _masked_stats(xb, tr_b)
        pooled = ((n0 - 1.0) * v0 + (n1 - 1.0) * v1) \
            / jnp.maximum(n0 + n1 - 2.0, 1.0)
        w = (m0 - m1) / (pooled + lam)                  # (C, F, N)
        # no bias term: AUC depends only on score DIFFERENCES, so any
        # per-pixel threshold cancels in the pairwise comparison
        sa = jnp.einsum("ecfn,cfn->efn", xa, w)
        sb = jnp.einsum("ecfn,cfn->efn", xb, w)
        return acc + decode_auc(sa, sb, te_a, te_b), None

    init = jnp.zeros(xa.shape[2:], jnp.float32)
    if vma_axes:
        # shard_map scan carries must share the body's varying-axes type
        init = lax.pcast(init, tuple(vma_axes), to="varying")
    auc, _ = lax.scan(fold, init, jnp.arange(n_folds))
    return auc / n_folds


def tf_decode(xa, xb, n_folds: int = 5, lam: float = 1e-3) -> jnp.ndarray:
    """(F, N) cross-validated decoding AUC between two trial groups of
    single-trial feature planes (Ea, C, F, N) vs (Eb, C, F, N) —
    typically ``EpochsWavelet.single_trial_power_all`` outputs.

    Diagonal-LDA per pixel, ``n_folds``-fold round-robin CV, ROC AUC on
    held-out trials (0.5 = chance).  ``lam`` is the variance shrinkage
    floor (also guards zero-variance pixels).  Feature scale: AUC is
    invariant to monotone transforms of the score, but heavy-tailed
    power benefits from a log transform on the caller side.
    """
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.ndim != 4 or xb.ndim != 4 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, F, N) and (Eb, C, F, N) with "
                         "matching planes, got %s and %s"
                         % (xa.shape, xb.shape))
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    return _tf_decode_jit(xa, xb, n_folds=int(n_folds), lam=float(lam))


@partial(jax.jit, static_argnames=("n_folds", "lam"))
def _temporal_gen_jit(xa, xb, *, n_folds, lam):
    ea, eb = xa.shape[0], xb.shape[0]
    fold_a = jnp.arange(ea) % n_folds
    fold_b = jnp.arange(eb) % n_folds

    def fold(acc, f):
        tr_a = (fold_a != f).astype(jnp.float32)
        tr_b = (fold_b != f).astype(jnp.float32)
        te_a, te_b = 1.0 - tr_a, 1.0 - tr_b
        m0, v0, n0 = _masked_stats(xa, tr_a)
        m1, v1, n1 = _masked_stats(xb, tr_b)
        pooled = ((n0 - 1.0) * v0 + (n1 - 1.0) * v1) / jnp.maximum(
            n0 + n1 - 2.0, 1.0)
        w = (m0 - m1) / (pooled + lam)                 # (C, T) per train t
        # no bias: it cancels in decode_auc's pairwise differences
        sa = jnp.einsum("ecs,ct->ets", xa, w)
        sb = jnp.einsum("ecs,ct->ets", xb, w)
        return acc + decode_auc(sa, sb, te_a, te_b), None

    auc, _ = lax.scan(fold, jnp.zeros((xa.shape[-1], xa.shape[-1]),
                                      jnp.float32), jnp.arange(n_folds))
    return auc / n_folds


def temporal_generalization(xa, xb, n_folds: int = 5,
                            lam: float = 1e-3) -> jnp.ndarray:
    """(T, T) temporal generalization matrix (King & Dehaene 2014):
    ``out[t_train, t_test]`` is the cross-validated AUC of a diagonal-LDA
    decoder FIT on the channel pattern at ``t_train`` and TESTED at
    ``t_test``, from (Ea, C, T) vs (Eb, C, T) feature courses (e.g. a
    band's power per channel, decimated).  A diagonal-only matrix means
    a sequential code; a square block means a sustained, stable code.
    All T decoders fit simultaneously; every (train, test) pair scores
    in one einsum + pairwise-comparison tensor per fold.
    """
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, T) and (Eb, C, T) with "
                         "matching planes, got %s and %s"
                         % (xa.shape, xb.shape))
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    return _temporal_gen_jit(xa, xb, n_folds=int(n_folds),
                             lam=float(lam))


@partial(jax.jit, static_argnames=("n_folds",))
def _fold_covs_jit(x, *, n_folds):
    """(n_folds, C, C) train covariances: per-epoch covariance stack
    contracted against the round-robin train masks — one einsum, no
    linalg, so it compiles cleanly on every backend."""
    e = x.shape[0]
    xc = x - jnp.mean(x, axis=2, keepdims=True)
    cov = jnp.einsum("ecn,edn->ecd", xc, xc,
                     precision=lax.Precision.HIGHEST) \
        / jnp.float32(x.shape[-1] - 1)
    tr = (jnp.arange(e)[None, :] % n_folds
          != jnp.arange(n_folds)[:, None]).astype(jnp.float32)
    return jnp.einsum("fe,ecd->fcd", tr, cov) \
        / jnp.sum(tr, 1)[:, None, None]


@partial(jax.jit, static_argnames=("n_components", "shrink"))
def _fold_ged_jit(covs_a, covs_b, *, n_components, shrink):
    """(n_folds, C, K) per-fold CSP filters: ONE vmapped generalized
    eigensolve over the fold axis: a batched ``eigh`` OUTSIDE
    ``lax.scan`` compiles quickly, while the same solve inside a scan
    body can compile for minutes — so every fold's linalg runs here, and
    the fold scan downstream touches no linalg at all."""
    from .spatial import _csp_select, _ged_core
    c = covs_a.shape[-1]
    _, filt, _ = jax.vmap(lambda ca, cb: _ged_core(ca, ca + cb, shrink))(
        covs_a, covs_b)
    return filt[:, :, _csp_select(c, n_components)]


@partial(jax.jit, static_argnames=("n_folds", "lam"))
def _csp_fold_auc_jit(xa, xb, filters, *, n_folds, lam):
    """Mean held-out AUC given per-fold CSP filters (n_folds, C, K):
    log-relative-variance features for ALL folds in one einsum, full
    (K, K) LDA per fold (pooled feature covariance, ridge ``lam``, one
    batched solve), pairwise AUC per fold through a linalg-free scan."""
    hi = lax.Precision.HIGHEST
    ea, eb = xa.shape[0], xb.shape[0]
    fids = jnp.arange(n_folds)[:, None]
    tr_a = (jnp.arange(ea)[None, :] % n_folds
            != fids).astype(jnp.float32)            # (n_folds, Ea)
    tr_b = (jnp.arange(eb)[None, :] % n_folds
            != fids).astype(jnp.float32)

    def feats(x):
        # (n_folds, E, K) log relative variance of filtered epochs
        src = jnp.einsum("fck,ecn->fekn", filters, x, precision=hi)
        v = jnp.var(src, axis=3)
        return jnp.log(jnp.maximum(
            v / jnp.sum(v, axis=2, keepdims=True), 1e-30))

    fa, fb = feats(xa), feats(xb)

    def moments(feat, keep):
        cnt = jnp.sum(keep, 1)                       # (n_folds,)
        mean = jnp.sum(feat * keep[..., None], 1) \
            / jnp.maximum(cnt, 1.0)[:, None]
        d = (feat - mean[:, None]) * keep[..., None]
        cov = jnp.einsum("fek,fel->fkl", d, d, precision=hi)
        return mean, cov, cnt

    m0, s0, n0 = moments(fa, tr_a)
    m1, s1, n1 = moments(fb, tr_b)
    pooled = (s0 + s1) / jnp.maximum(n0 + n1 - 2.0, 1.0)[:, None, None]
    eye = jnp.eye(pooled.shape[-1], dtype=pooled.dtype)
    w = jnp.linalg.solve(pooled + lam * eye,
                         (m0 - m1)[..., None])[..., 0]  # (n_folds, K)
    sa = jnp.einsum("fek,fk->fe", fa, w)
    sb = jnp.einsum("fek,fk->fe", fb, w)

    def fold(acc, args):
        sa_f, sb_f, ta, tb = args
        return acc + decode_auc(sa_f, sb_f, 1.0 - ta, 1.0 - tb), None

    auc, _ = lax.scan(fold, jnp.float32(0.0), (sa, sb, tr_a, tr_b))
    return auc / n_folds


def csp_decode(xa, xb, n_folds: int = 5, n_components: int = 4,
               shrink: float = 0.01, lam: float = 1e-3,
               f_lo=None, f_hi=None, sfreq=None) -> jnp.ndarray:
    """Cross-validated CSP+LDA decoding AUC between two-class epochs
    (Ea, C, N) vs (Eb, C, N) — the standard BCI motor-imagery pipeline
    in three jitted programs: per-fold train covariances (mask-weighted
    per-epoch covariance stacks, no linalg), ONE batched generalized
    eigensolve for every fold's CSP filters (train trials only), then
    log-relative-variance features + full (K, K) LDA with ridge ``lam``
    + held-out ROC AUC.  Optional ``f_lo``/``f_hi``/``sfreq`` bandpass
    both classes first (see ``ops.spatial.csp``).  Returns a scalar
    AUC (0.5 = chance)."""
    from . import filtering as _filt
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, N) and (Eb, C, N) with "
                         "matching (C, N)")
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    if f_lo is not None or f_hi is not None:
        if sfreq is None or f_lo is None or f_hi is None:
            raise ValueError("bandpass needs f_lo, f_hi AND sfreq")
        xa = _filt.bandpass(xa, sfreq, f_lo, f_hi)
        xb = _filt.bandpass(xb, sfreq, f_lo, f_hi)
    k = int(n_components)
    if not (1 <= k <= xa.shape[1]):
        raise ValueError("n_components must be in [1, C]")
    nf = int(n_folds)
    covs_a = _fold_covs_jit(xa, n_folds=nf)
    covs_b = _fold_covs_jit(xb, n_folds=nf)
    filters = _fold_ged_jit(covs_a, covs_b, n_components=k,
                            shrink=float(shrink))
    return _csp_fold_auc_jit(xa, xb, filters, n_folds=nf,
                             lam=float(lam))


# ---------------------------------------------------------------------------
# SSVEP: canonical correlation against sinusoidal references
# ---------------------------------------------------------------------------

def cca_reference(freqs, n: int, sfreq: float,
                  n_harmonics: int = 3) -> jnp.ndarray:
    """(F, 2H, N) sinusoidal reference set per stimulus frequency:
    sin/cos pairs at the fundamental and ``n_harmonics - 1`` harmonics
    (Lin et al. 2006 — the standard CCA-SSVEP references)."""
    freqs = np.asarray(list(freqs), np.float64)
    t = np.arange(n) / float(sfreq)
    rows = []
    for f0 in freqs:
        comps = []
        for h in range(1, int(n_harmonics) + 1):
            comps.append(np.sin(2 * np.pi * h * f0 * t))
            comps.append(np.cos(2 * np.pi * h * f0 * t))
        rows.append(np.stack(comps))
    return jnp.asarray(np.stack(rows), jnp.float32)


@partial(jax.jit, static_argnames=("lam",))
def _cca_rho_jit(x, refs, *, lam):
    """Largest canonical correlation of every (trial, frequency) pair:
    x (E, C, N), refs (F, R, N) -> (E, F).

    Whitened cross-covariance: ``rho = sigma_max(Cxx^{-1/2} Cxy
    Cyy^{-1/2})`` — computed as the sqrt of the dominant eigenvalue of
    the SYMMETRIC M M^T (batched eigh; no SVD on device)."""
    hp = jax.lax.Precision.HIGHEST
    xm = x - jnp.mean(x, axis=-1, keepdims=True)
    rm = refs - jnp.mean(refs, axis=-1, keepdims=True)
    n = x.shape[-1]
    cxx = jnp.einsum("ecn,edn->ecd", xm, xm, precision=hp) / n
    cyy = jnp.einsum("frn,fsn->frs", rm, rm, precision=hp) / n
    cxy = jnp.einsum("ecn,frn->efcr", xm, rm, precision=hp) / n

    def isqrt(m):
        d, v = jnp.linalg.eigh(m)
        d = jnp.maximum(d, lam * d[..., -1:])
        return jnp.einsum("...ij,...j,...kj->...ik", v,
                          1.0 / jnp.sqrt(d), v, precision=hp)

    ix = isqrt(cxx)                                   # (E, C, C)
    iy = isqrt(cyy)                                   # (F, R, R)
    m = jnp.einsum("eci,efir,frs->efcs", ix, cxy, iy, precision=hp)
    mmt = jnp.einsum("efcs,efds->efcd", m, m, precision=hp)
    vals = jnp.linalg.eigvalsh(mmt)                   # ascending
    return jnp.sqrt(jnp.clip(vals[..., -1], 0.0, 1.0))


def ssvep_cca(x, freqs, sfreq: float, n_harmonics: int = 3,
              lam: float = 1e-6):
    """CCA-based SSVEP frequency recognition (Lin 2006, the standard
    BCI-speller decoder): per trial, the canonical correlation between
    the (C, N) EEG and each stimulus frequency's sin/cos reference set;
    the winning frequency is the argmax.

    Returns ``(labels (E,) int32 indices into freqs, rho (E, F))``.
    ``lam`` floors the whitened covariance eigenvalues (relative)."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    freqs = list(freqs)
    if not freqs:
        raise ValueError("need at least one stimulus frequency")
    refs = cca_reference(freqs, x.shape[-1], sfreq, n_harmonics)
    rho = _cca_rho_jit(x, refs, lam=float(lam))
    return jnp.argmax(rho, axis=-1).astype(jnp.int32), rho
