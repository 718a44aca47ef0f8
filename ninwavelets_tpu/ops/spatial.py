"""Spatial filtering by generalized eigendecomposition: GED, CSP, SSD.

No reference counterpart — the reference (``Hiroki-Maeda/ninwavelets``)
analyzes channels independently; these are the standard multichannel
component extractors (Cohen 2022 "A tutorial on generalized
eigendecomposition"; Blankertz 2008 CSP; Nikulin 2011 SSD) that turn a
(C, N) montage into a few high-SNR component time series which the rest
of this framework (CWT power, connectivity, decoding) then consumes.

All three are the same math: maximize ``w^T S w / w^T R w`` — solve the
generalized symmetric eigenproblem ``S w = lam R w``.

Design notes:
* covariances are (C, N) x (N, C) matmuls at ``Precision.HIGHEST``
  (statistic path — a DEFAULT-precision matmul, TF32 on a GPU, would
  bias them), with
  per-sequence mean removal fused in;
* there is no generalized-eigh primitive in XLA, so the solve whitens
  with the symmetric inverse square root of R (one C x C ``eigh``) and
  runs a second ``eigh`` on the whitened S — C is at most a few hundred,
  both are trivial next to the covariance matmuls;
* R is shrunk toward ``mean(diag) * I`` (Ledoit-Wolf-style ridge with a
  fixed ``shrink`` weight) so rank-deficient reference covariances never
  blow up the whitener;
* filters/patterns have deterministic sign (largest-|.| pattern
  coefficient positive) and descending-eigenvalue order, so component
  indices are stable run to run;
* patterns follow Haufe 2014: ``A = S W inv(W^T S W)`` — and because the
  GED filters diagonalize S exactly, the inverse is elementwise, so the
  pattern for component k is just ``(S @ w_k) / (w_k^T S w_k)``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import filtering as _filt

__all__ = [
    "SpatialResult", "covariance", "ledoit_wolf", "ged", "csp",
    "csp_features", "ssd", "spatial_apply", "corrca", "xdawn"]

_HI = lax.Precision.HIGHEST


class SpatialResult(NamedTuple):
    """Fitted spatial decomposition.  ``sources = filters.T @ x`` per
    epoch; ``patterns[:, k]`` is component k's forward topography."""
    filters: jnp.ndarray    # (C, K) columns w_k
    patterns: jnp.ndarray   # (C, K) Haufe forward models
    eigvals: jnp.ndarray    # (K,) generalized eigenvalues, descending


@jax.jit
def _cov_jit(x):
    e, c, n = x.shape
    xc = x - jnp.mean(x, axis=2, keepdims=True)
    # one (C, E*N) @ (E*N, C) matmul — per-epoch centering makes the
    # epoch concatenation exact, and one flat matmul replaces the
    # batched ecn,edn->cd einsum
    y = xc.transpose(1, 0, 2).reshape(c, e * n)
    cov = jnp.matmul(y, y.T, precision=_HI)
    return cov / jnp.float32(e * (n - 1))


def covariance(x) -> jnp.ndarray:
    """Mean-removed channel covariance of ``x`` — (C, N) or a stack of
    epochs (E, C, N) (per-epoch centering, epoch-summed, one normalizer:
    the standard pooled estimate).  One jitted program, no eager per-op
    dispatch."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3:
        raise ValueError(f"expected (C, N) or (E, C, N), got {x.shape}")
    return _cov_jit(x)


@jax.jit
def _lw_jit(x):
    c, n = x.shape
    xc = x - jnp.mean(x, axis=1, keepdims=True)
    s = jnp.matmul(xc, xc.T, precision=_HI) / n       # biased MLE cov
    mu = jnp.trace(s) / c
    # d^2 = ||S - mu I||_F^2 / C  (normalized Frobenius norm)
    d2 = (jnp.sum(s * s) - c * mu * mu) / c
    # b^2 = (1/N^2) sum_n ||x_n x_n^T - S||_F^2 / C; the cross term
    # collapses: sum_n x_n^T S x_n = tr(S sum x_n x_n^T) = N ||S||_F^2,
    # so the sum is sum_n ||x_n||^4 - N ||S||_F^2.
    norm4 = jnp.sum(jnp.sum(xc * xc, axis=0) ** 2)
    b2 = (norm4 / n - jnp.sum(s * s)) / (n * c)
    b2 = jnp.minimum(b2, d2)
    alpha = jnp.where(d2 > 0, b2 / jnp.maximum(d2, 1e-30), 0.0)
    eye = jnp.eye(c, dtype=s.dtype)
    return (1.0 - alpha) * s + alpha * mu * eye, alpha


def ledoit_wolf(x):
    """``(cov, shrinkage)`` — Ledoit–Wolf (2004) analytically-shrunk
    covariance of a (C, N) recording (or (E, C, N) epochs, pooled after
    per-epoch centering): the sample covariance blended toward the
    scaled identity ``mean(eig) * I`` with the closed-form optimal
    weight, no cross-validation.  Matches
    ``sklearn.covariance.ledoit_wolf``.  Use it where a fixed ``shrink``
    knob would need tuning — near-rank-deficient montages (average
    reference, interpolated channels, N ~ C) feeding beamformers or
    whitening."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim == 3:
        # pooled: per-epoch centering then one flat (C, E*N) sample set
        e, c, n = x.shape
        x = (x - jnp.mean(x, axis=-1, keepdims=True)) \
            .transpose(1, 0, 2).reshape(c, e * n)
    if x.ndim != 2:
        raise ValueError(f"expected (C, N) or (E, C, N), got {x.shape}")
    if x.shape[1] < 2:
        raise ValueError("need at least 2 samples")
    cov, alpha = _lw_jit(x)
    return cov, float(alpha)


def _shrunk(cov, shrink: float):
    c = cov.shape[0]
    tr = jnp.trace(cov) / c
    return (1.0 - shrink) * cov + shrink * tr * jnp.eye(c, dtype=cov.dtype)


def _ged_core(cov_s, cov_r, shrink: float):
    """Whiten-and-eigh generalized solve; returns (eigvals desc,
    filters (C, C) columns, patterns (C, C))."""
    cov_s = 0.5 * (cov_s + cov_s.T)
    cov_r = _shrunk(0.5 * (cov_r + cov_r.T), shrink)
    s_r, e_r = jnp.linalg.eigh(cov_r)
    inv_sqrt = jnp.matmul(
        e_r / jnp.sqrt(jnp.maximum(s_r, 1e-12)), e_r.T, precision=_HI)
    m = jnp.matmul(jnp.matmul(inv_sqrt, cov_s, precision=_HI), inv_sqrt,
                   precision=_HI)
    d, v = jnp.linalg.eigh(0.5 * (m + m.T))
    d = d[::-1]
    filters = jnp.matmul(inv_sqrt, v[:, ::-1], precision=_HI)
    # Haufe patterns: S W inv(W^T S W); W^T S W = diag(w^T S w) exactly
    # at the solution, so invert elementwise.
    sw = jnp.matmul(cov_s, filters, precision=_HI)
    denom = jnp.maximum(jnp.sum(filters * sw, axis=0), 1e-20)
    patterns = sw / denom[None, :]
    # deterministic sign: largest-|.| pattern coefficient positive
    flip = jnp.sign(jnp.take_along_axis(
        patterns, jnp.argmax(jnp.abs(patterns), axis=0)[None, :], axis=0))
    flip = jnp.where(flip == 0, 1.0, flip)
    return d, filters * flip, patterns * flip


@partial(jax.jit, static_argnames=("n_components", "shrink"))
def _ged_jit(cov_s, cov_r, *, n_components: int, shrink: float):
    d, f, p = _ged_core(cov_s, cov_r, shrink)
    k = n_components
    return d[:k], f[:, :k], p[:, :k]


def ged(cov_s, cov_r, n_components: Optional[int] = None,
        shrink: float = 0.01) -> SpatialResult:
    """Generalized eigendecomposition ``S w = lam R w`` of two channel
    covariances: components (descending ``lam``) maximize the
    signal-to-reference variance ratio.  Pass covariances from
    :func:`covariance`, or any symmetric PSD pair."""
    cov_s = jnp.asarray(cov_s, jnp.float32)
    cov_r = jnp.asarray(cov_r, jnp.float32)
    if cov_s.shape != cov_r.shape or cov_s.ndim != 2 \
            or cov_s.shape[0] != cov_s.shape[1]:
        raise ValueError("cov_s/cov_r must be matching square matrices")
    c = cov_s.shape[0]
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    d, f, p = _ged_jit(cov_s, cov_r, n_components=k, shrink=float(shrink))
    return SpatialResult(f, p, d)


def csp(xa, xb, n_components: int = 4, shrink: float = 0.01,
        f_lo: Optional[float] = None, f_hi: Optional[float] = None,
        sfreq: Optional[float] = None) -> SpatialResult:
    """Common spatial patterns for two-class epochs (E, C, N): GED of
    class-A covariance against the pooled covariance (Blankertz 2008),
    keeping the ``n_components`` most discriminative filters — the
    eigenvalue-spectrum EXTREMES, alternating top/bottom (top maximizes
    class-A variance, bottom class-B), which is the half-and-half
    selection every CSP pipeline uses.  Eigenvalues are the class-A
    variance fractions in (0, 1); 0.5 is non-discriminative.

    Optional ``f_lo``/``f_hi`` (with ``sfreq``) bandpass both classes
    first (CSP is a narrowband method; broadband covariances mostly
    measure 1/f noise).
    """
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("xa/xb must be (E, C, N) with matching (C, N)")
    if f_lo is not None or f_hi is not None:
        if sfreq is None or f_lo is None or f_hi is None:
            raise ValueError("bandpass needs f_lo, f_hi AND sfreq")
        xa = _filt.bandpass(xa, sfreq, f_lo, f_hi)
        xb = _filt.bandpass(xb, sfreq, f_lo, f_hi)
    c = xa.shape[1]
    k = int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    ca = covariance(xa)
    cb = covariance(xb)
    return _csp_from_covs(ca, cb, k, shrink)


def _csp_select(c: int, k: int) -> jnp.ndarray:
    """Alternate eigen-spectrum extremes: 0, C-1, 1, C-2, ... — the
    top/bottom half-and-half selection every CSP pipeline uses."""
    idx = np.empty(c, dtype=np.int64)
    idx[0::2] = np.arange((c + 1) // 2)
    idx[1::2] = c - 1 - np.arange(c // 2)
    return jnp.asarray(idx[:k])


def _csp_from_covs(ca, cb, k: int, shrink: float) -> SpatialResult:
    c = ca.shape[0]
    d, f, p = _ged_jit(ca, ca + cb, n_components=c, shrink=float(shrink))
    sel = _csp_select(c, k)
    return SpatialResult(f[:, sel], p[:, sel], d[sel])


@jax.jit
def _apply3_jit(x, filters):
    return jnp.einsum("ck,ecn->ekn", filters, x, precision=_HI)


def spatial_apply(x, filters) -> jnp.ndarray:
    """Project epochs (E, C, N) (or one (C, N) recording) onto component
    time series (E, K, N) / (K, N)."""
    x = jnp.asarray(x, jnp.float32)
    filters = jnp.asarray(filters, jnp.float32)
    if x.ndim == 2:
        return _apply3_jit(x[None], filters)[0]
    return _apply3_jit(x, filters)


@jax.jit
def csp_features(x, filters) -> jnp.ndarray:
    """Log-variance CSP features: (E, C, N) epochs -> (E, K) — the
    classic LDA-ready feature vector (log of per-component variance,
    normalized to the per-epoch total so gain fluctuations cancel)."""
    src = spatial_apply(x, filters)
    v = jnp.var(src, axis=2)
    return jnp.log(jnp.maximum(v / jnp.sum(v, axis=1, keepdims=True),
                               1e-30))


def ssd(x, sfreq: float, f_lo: float, f_hi: float,
        n_components: Optional[int] = None, flank: float = 2.0,
        gap: float = 1.0, shrink: float = 0.01) -> SpatialResult:
    """Spatio-spectral decomposition (Nikulin 2011): maximize power in
    the [f_lo, f_hi] band against its flanking noise bands.  ``x`` is
    (C, N) or (E, C, N).  The signal covariance comes from a
    [f_lo, f_hi] bandpass; the noise covariance from a
    [f_lo - flank, f_hi + flank] bandpass with the
    [f_lo - gap, f_hi + gap] band notched out (the Nikulin recipe:
    flanks only, no leakage from the signal band)."""
    x = jnp.asarray(x, jnp.float32)
    if f_lo - flank <= 0:
        raise ValueError("f_lo - flank must stay positive")
    if gap >= flank:
        raise ValueError("gap must be < flank (else the noise band is "
                         "empty)")
    xs = _filt.bandpass(x, sfreq, f_lo, f_hi)
    broad = _filt.bandpass(x, sfreq, f_lo - flank, f_hi + flank)
    center = 0.5 * (f_lo + f_hi)
    width = (f_hi - f_lo) + 2.0 * gap
    xn = _filt.notch(broad, sfreq, center, width)
    cov_s = covariance(xs)
    cov_n = covariance(xn)
    c = cov_s.shape[0]
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    d, f, p = _ged_jit(cov_s, cov_n, n_components=k, shrink=float(shrink))
    return SpatialResult(f, p, d)


def corrca(x, n_components: int = 3, shrink: float = 0.05):
    """Correlated components analysis / inter-subject correlation
    (Parra et al. 2019, Neuroimage 183:366 — the naturalistic-paradigm
    workhorse): spatial filters maximizing the correlation of the SAME
    stimulus-locked response ACROSS subjects (or repeated viewings).

    ``x`` is (S, C, N): S subjects watching one stimulus.  Solves the
    generalized eigenproblem ``R_between w = lambda R_within w`` with
    ``R_between = sum_{i != j} C_ij`` (cross-subject covariances) and
    ``R_within = sum_i C_ii`` — both built from ONE pooled-sum identity
    (``R_b = C_pooled - R_w`` with ``C_pooled`` the covariance of the
    summed subjects), so the cost is S + 1 covariances, not S^2.

    Returns ``(filters (K, C), isc (K,))`` — ISC_k is the
    component's across-subject correlation ``w^T R_b w / ((S-1)
    w^T R_w w)``, 1 when every subject's component time course is
    identical.  Filters apply per subject as ``w @ x_i``."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 3:
        raise ValueError("x must be (subjects, C, N)")
    s, c, n = x.shape
    if s < 2:
        raise ValueError("need at least 2 subjects/repeats")
    if not 1 <= int(n_components) <= c:
        raise ValueError("n_components must be in [1, C]")
    xm = x - jnp.mean(x, axis=-1, keepdims=True)
    hp = _HI
    # within: sum of per-subject covariances
    rw = jnp.einsum("scn,sdn->cd", xm, xm, precision=hp) / n
    # pooled: covariance of the across-subject SUM; between = pooled - within
    pooled = jnp.sum(xm, axis=0)
    cp = jnp.matmul(pooled, pooled.T, precision=hp) / n
    rb = cp - rw
    rw = rw + shrink * jnp.trace(rw) / c * jnp.eye(c, dtype=rw.dtype)
    # generalized symmetric eigenproblem via the within-whitening sandwich
    d, v = jnp.linalg.eigh(rw)
    d = jnp.maximum(d, 1e-12 * d[-1])
    isq = jnp.einsum("ij,j,kj->ik", v, 1.0 / jnp.sqrt(d), v, precision=hp)
    m = isq @ rb @ isq
    vals, vecs = jnp.linalg.eigh(0.5 * (m + m.T))     # ascending
    w = (isq @ vecs[:, ::-1][:, :int(n_components)]).T  # (K, C)
    # normalize filters; ISC from the Rayleigh quotients
    w = w / jnp.maximum(jnp.linalg.norm(w, axis=1, keepdims=True), 1e-30)
    num = jnp.einsum("kc,cd,kd->k", w, rb, w, precision=hp)
    den = jnp.einsum("kc,cd,kd->k", w, rw, w, precision=hp)
    isc = num / jnp.maximum((s - 1.0) * den, 1e-30)
    return w, isc


def xdawn(x, events, window: int, n_components: int = 4,
          shrink: float = 0.05):
    """xDAWN evoked-response enhancement (Rivet et al. 2009, IEEE TBME
    56:2035 — the P300-speller spatial filter): filters maximizing the
    evoked-to-noise power ratio for responses locked to ``events``.

    ``x`` (C, N) continuous recording, ``events`` (E,) sample indices,
    ``window`` the response length in samples.  The evoked waveform is
    the LEAST-SQUARES estimate on the Toeplitz event design (overlap-
    robust, unlike plain averaging): ``A = (D^T D)^{-1} D^T x^T``; the
    signal covariance of the reconstructed evoked stream and the raw
    covariance then feed a generalized eigenproblem (whitening-sandwich
    ``eigh``, the module's GED pattern).

    Returns ``(filters (K, C), evoked (K, window), ratios (K,))`` —
    ``filters @ x`` gives enhanced virtual channels, ``evoked`` their
    least-squares response estimates, ``ratios`` the per-component
    evoked/total power (descending)."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("x must be (C, N)")
    c, n = x.shape
    ev = np.asarray(events, np.int64).ravel()
    ev = ev[(ev >= 0) & (ev + int(window) <= n)]
    if ev.size < 2:
        raise ValueError("need at least 2 in-bounds events")
    if not 1 <= int(n_components) <= c:
        raise ValueError("n_components must be in [1, C]")
    # Toeplitz design D (N, L) as L shifted indicator rows, built on
    # the HOST in one upload; the entire device computation is ONE
    # jitted program (eager ops would dispatch and compile one by
    # one).
    train = np.zeros(n, np.float32)
    train[ev] = 1.0
    L = int(window)
    rows_np = np.zeros((L, n), np.float32)
    for k in range(L):
        rows_np[k, k:] = train[:n - k] if k else train
    return _xdawn_jit(x, jnp.asarray(rows_np),
                      n_components=int(n_components),
                      shrink=float(shrink))


@partial(jax.jit, static_argnames=("n_components", "shrink"))
def _xdawn_jit(x, rows, *, n_components, shrink):
    hp = _HI
    c, n = x.shape
    L = rows.shape[0]
    dtd = jnp.matmul(rows, rows.T, precision=hp)       # (L, L)
    dtx = jnp.matmul(rows, x.T, precision=hp)          # (L, C)
    dtd = dtd + 1e-6 * jnp.trace(dtd) / L * jnp.eye(L)
    a = jnp.linalg.solve(dtd, dtx)                     # (L, C) evoked
    # signal covariance of the reconstructed evoked stream D @ A:
    # (DA)^T (DA) = A^T (D^T D) A
    cs = jnp.matmul(a.T, jnp.matmul(dtd, a, precision=hp),
                    precision=hp) / n
    cx = jnp.matmul(x, x.T, precision=hp) / n
    cx = cx + shrink * jnp.trace(cx) / c * jnp.eye(c)
    d, v = jnp.linalg.eigh(cx)
    d = jnp.maximum(d, 1e-12 * d[-1])
    isq = jnp.einsum("ij,j,kj->ik", v, 1.0 / jnp.sqrt(d), v,
                     precision=hp)
    m = isq @ cs @ isq
    vals, vecs = jnp.linalg.eigh(0.5 * (m + m.T))
    w = (isq @ vecs[:, ::-1][:, :n_components]).T      # (K, C)
    w = w / jnp.maximum(jnp.linalg.norm(w, axis=1, keepdims=True),
                        1e-30)
    evoked = jnp.matmul(w, a.T, precision=hp)          # (K, L)
    num = jnp.einsum("kc,cd,kd->k", w, cs, w, precision=hp)
    den = jnp.einsum("kc,cd,kd->k", w, cx, w, precision=hp)
    return w, evoked, num / jnp.maximum(den, 1e-30)
