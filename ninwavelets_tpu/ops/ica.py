"""Independent component analysis (FastICA, Hyvärinen & Oja 2000) for
artifact separation.  No reference counterpart — this is the standard
EEG preprocessing step the reference leaves to mne: unmix a (C, N)
recording into statistically independent sources, inspect/flag the
ocular-cardiac-muscle components, and reconstruct without them.

Design notes:
* whitening is an eigendecomposition of the C x C channel covariance
  (C is at most a few hundred — one small ``jnp.linalg.eigh``), with
  the data matmuls at ``Precision.HIGHEST`` (statistic path — a
  DEFAULT-precision matmul, TF32 on a GPU, would bias the covariance);
* the symmetric (parallel) FastICA fixed point runs a STATIC number of
  iterations inside one ``lax.scan``: each step is two (K, N) x (N, K)
  matmuls (the nonlinearity moment and its derivative mean) plus a
  K x K symmetric-decorrelation eigh — all dense and static, no
  data-dependent convergence branching; the final per-iteration
  convergence metric is returned so the caller can CHECK convergence
  instead of trusting it;
* component order is deterministic: sorted by explained variance of
  the mixing columns (sklearn leaves them permutation-random, which
  makes downstream component-index bookkeeping fragile);
* signs are fixed by making each mixing column's largest-|.|
  coefficient positive (ICA's intrinsic sign ambiguity).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["fastica", "ica_transform", "ica_remove", "ICAResult",
           "ica_scores", "ica_kurtosis", "ica_find_bads"]

_HI = jax.lax.Precision.HIGHEST


class ICAResult(NamedTuple):
    """Fitted ICA model.  ``sources = unmixing @ (x - mean)``;
    ``x ~= mixing @ sources + mean``."""
    unmixing: jnp.ndarray   # (K, C)
    mixing: jnp.ndarray     # (C, K)
    mean: jnp.ndarray       # (C,)
    sources: jnp.ndarray    # (K, N)
    convergence: jnp.ndarray  # (n_iter,) max |1 - |<w_new, w_old>||


def _g(u, fun: str):
    """FastICA nonlinearity g(u) and its derivative mean factor."""
    if fun == "logcosh":
        gu = jnp.tanh(u)
        gpu = 1.0 - gu * gu
    elif fun == "exp":
        e = jnp.exp(-0.5 * u * u)
        gu = u * e
        gpu = (1.0 - u * u) * e
    elif fun == "cube":
        gu = u ** 3
        gpu = 3.0 * u * u
    else:
        raise ValueError("fun must be 'logcosh', 'exp' or 'cube'")
    return gu, gpu


def _sym_decorrelate(w):
    """W <- (W W^T)^(-1/2) W via eigh of the K x K Gram."""
    s, e = jnp.linalg.eigh(jnp.matmul(w, w.T, precision=_HI))
    inv_sqrt = e @ jnp.diag(1.0 / jnp.sqrt(jnp.maximum(s, 1e-12))) @ e.T
    return jnp.matmul(inv_sqrt, w, precision=_HI)


def _whiten_from_cov(cov, xc, k, precision=None):
    """Top-K PCA whitening from a (C, C) covariance: returns
    ``(whiten (K, C), z (K, N), e_top, s_top)`` — shared by the
    single-device and sharded paths (the sharded path feeds a
    psum-completed covariance; everything after is replicated math)."""
    p = _HI if precision is None else precision
    s, e = jnp.linalg.eigh(cov)                     # ascending
    s_top = s[-k:][::-1]
    e_top = e[:, -k:][:, ::-1]
    whiten = (e_top / jnp.sqrt(jnp.maximum(s_top, 1e-12))).T  # (K, C)
    return whiten, jnp.matmul(whiten, xc, precision=p), e_top, s_top


def _ica_step(w, z, fun, n, reduce_m=None, reduce_gp=None,
              precision=None):
    """One symmetric FastICA fixed-point update.  ``reduce_m`` /
    ``reduce_gp`` complete the two data-axis moments (identity on a
    single device, ``psum`` under shard_map) — the ONLY thing that
    differs between the two paths."""
    p = _HI if precision is None else precision
    u = jnp.matmul(w, z, precision=p)               # (K, N)
    gu, gpu = _g(u, fun)
    m = jnp.matmul(gu, z.T, precision=p)
    gp = jnp.sum(gpu, axis=1)
    if reduce_m is not None:
        m = reduce_m(m)
    if reduce_gp is not None:
        gp = reduce_gp(gp)
    w_new = _sym_decorrelate(m / n - (gp / n)[:, None] * w)
    conv = jnp.max(jnp.abs(1.0 - jnp.abs(jnp.sum(w_new * w, axis=1))))
    return w_new, conv


def _finalize_components(w, whiten, e_top, s_top, xc, precision=None):
    """Unmixing/mixing assembly + the deterministic ORDER (explained
    variance) and SIGN (largest-|.| mixing coefficient positive)
    conventions — replicated small-matrix math shared verbatim by both
    paths so a convention change cannot silently fork them."""
    p = _HI if precision is None else precision
    unmixing = jnp.matmul(w, whiten, precision=p)            # (K, C)
    mixing = e_top * jnp.sqrt(jnp.maximum(s_top, 1e-12)) @ w.T  # (C, K)
    power = jnp.sum(mixing * mixing, axis=0)
    order = jnp.argsort(-power)
    unmixing = unmixing[order]
    mixing = mixing[:, order]
    flip = jnp.sign(jnp.take_along_axis(
        mixing, jnp.argmax(jnp.abs(mixing), axis=0)[None, :], axis=0))[0]
    flip = jnp.where(flip == 0, 1.0, flip)
    unmixing = unmixing * flip[:, None]
    mixing = mixing * flip[None, :]
    sources = jnp.matmul(unmixing, xc, precision=p)
    return unmixing, mixing, sources


@partial(jax.jit, static_argnames=("n_components", "fun", "n_iter"))
def _fastica_jit(x, key, *, n_components, fun, n_iter):
    c, n = x.shape
    k = n_components
    mean = jnp.mean(x, axis=1)
    xc = x - mean[:, None]
    cov = jnp.matmul(xc, xc.T, precision=_HI) / n
    whiten, z, e_top, s_top = _whiten_from_cov(cov, xc, k)

    w0 = _sym_decorrelate(jax.random.normal(key, (k, k), jnp.float32))
    w, conv = lax.scan(lambda w, _: _ica_step(w, z, fun, n), w0, None,
                       length=n_iter)
    unmixing, mixing, sources = _finalize_components(w, whiten, e_top,
                                                     s_top, xc)
    return unmixing, mixing, mean, sources, conv


def fastica(x, n_components: int | None = None, fun: str = "logcosh",
            n_iter: int = 200, seed: int = 0) -> ICAResult:
    """Symmetric FastICA of a (C, N) recording: ``ICAResult`` with
    variance-sorted, sign-fixed components.

    ``fun`` is the contrast nonlinearity (``logcosh`` is the robust
    default; ``exp`` for very super-Gaussian sources like blinks,
    ``cube`` = kurtosis); ``n_iter`` is a static iteration count —
    check ``convergence[-1]`` (should be ~0, it is
    ``max_k |1 - |cos angle(w_k_new, w_k_old)||`` of the last sweep).
    """
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("expected (channels, samples)")
    c, n = x.shape
    if n < c:
        raise ValueError("need more samples than channels")
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, channels]")
    if fun not in ("logcosh", "exp", "cube"):
        raise ValueError("fun must be 'logcosh', 'exp' or 'cube'")
    un, mix, mean, src, conv = _fastica_jit(
        x, jax.random.PRNGKey(seed), n_components=k, fun=fun,
        n_iter=int(n_iter))
    return ICAResult(un, mix, mean, src, conv)


def ica_transform(x, result: ICAResult) -> jnp.ndarray:
    """(K, N) source estimates of new data under a fitted model."""
    x = jnp.asarray(x, jnp.float32)
    c = result.unmixing.shape[1]
    if x.shape[0] != c:
        raise ValueError(
            f"data has {x.shape[0]} channels but the model was fitted "
            f"on {c} — pass the same channel subset (picks) it was "
            "fitted with")
    return jnp.matmul(result.unmixing,
                      x - result.mean[:, None], precision=_HI)


@jax.jit
def _corr_jit(src, ref):
    """|Pearson r| of each (K, N) source row against each (R, N)
    reference row, as one (K, N) x (N, R) matmul on centered,
    unit-norm rows."""
    sc = src - jnp.mean(src, axis=1, keepdims=True)
    sc = sc / jnp.maximum(jnp.linalg.norm(sc, axis=1, keepdims=True),
                          1e-20)
    rc = ref - jnp.mean(ref, axis=1, keepdims=True)
    rc = rc / jnp.maximum(jnp.linalg.norm(rc, axis=1, keepdims=True),
                          1e-20)
    return jnp.abs(jnp.matmul(sc, rc.T, precision=_HI))     # (K, R)


def ica_scores(result: ICAResult, ref) -> np.ndarray:
    """(K,) artifact score per component: the max |Pearson correlation|
    of each source with the reference channel(s) ``ref`` (1-D ``(N,)``
    or stacked ``(R, N)`` — e.g. EOG and ECG traces).

    The standard automatic-selection statistic (mne's
    ``find_bads_eog``/``find_bads_ecg`` correlation mode): ocular or
    cardiac components track the artifact channel; brain components
    don't."""
    ref = jnp.atleast_2d(jnp.asarray(ref, jnp.float32))
    src = jnp.asarray(result.sources, jnp.float32)
    if ref.shape[-1] != src.shape[-1]:
        raise ValueError(
            f"reference length {ref.shape[-1]} != source length "
            f"{src.shape[-1]}")
    return np.asarray(jnp.max(_corr_jit(src, ref), axis=1))


@jax.jit
def _kurt_jit(src):
    sc = src - jnp.mean(src, axis=1, keepdims=True)
    v = jnp.maximum(jnp.mean(sc * sc, axis=1), 1e-20)
    return jnp.mean(sc ** 4, axis=1) / (v * v) - 3.0


def ica_kurtosis(result: ICAResult) -> np.ndarray:
    """(K,) excess kurtosis per source — spiky artifacts (blinks,
    electrode pops, muscle bursts) are strongly super-Gaussian while
    ongoing brain rhythms sit near 0."""
    return np.asarray(_kurt_jit(jnp.asarray(result.sources, jnp.float32)))


def ica_find_bads(result: ICAResult, ref=None, threshold: float = 3.0,
                  measure: str = "zscore") -> tuple[list, np.ndarray]:
    """Automatically flag artifact components.

    With ``ref`` (an EOG/ECG trace or a stack of them): scores are the
    max |correlation| per component (``ica_scores``).  Without:
    scores are the excess kurtosis (``ica_kurtosis``) — the unsupervised
    spiky-component criterion.  ``measure="zscore"`` (default, mne's
    convention) flags components whose score sits ``threshold`` robust
    z-units (median / 1.4826 MAD) above the rest — self-calibrating
    across recordings; ``measure="absolute"`` compares the raw score to
    ``threshold`` directly.  Returns ``(bad_indices, scores)``; feed the
    indices to ``ica_remove``.
    """
    scores = (ica_scores(result, ref) if ref is not None
              else ica_kurtosis(result))
    if measure == "zscore":
        med = np.median(scores)
        mad = np.median(np.abs(scores - med)) * 1.4826
        z = (scores - med) / max(mad, 1e-12)
        bads = np.flatnonzero(z > float(threshold))
    elif measure == "absolute":
        bads = np.flatnonzero(scores > float(threshold))
    else:
        raise ValueError("measure must be 'zscore' or 'absolute'")
    return [int(i) for i in bads], scores


def ica_remove(x, result: ICAResult, exclude) -> jnp.ndarray:
    """(C, N) reconstruction of ``x`` with the ``exclude``d component
    indices zeroed — the artifact-removal step (mne's ``ica.apply``)."""
    x = jnp.asarray(x, jnp.float32)
    k = result.unmixing.shape[0]
    exclude = np.atleast_1d(np.asarray(exclude, np.int64))
    if exclude.size and (exclude.min() < 0 or exclude.max() >= k):
        raise ValueError(f"exclude indices must be in [0, {k})")
    keep = np.ones(k, np.float32)
    keep[exclude] = 0.0
    src = ica_transform(x, result)
    return (jnp.matmul(result.mixing * jnp.asarray(keep)[None, :], src,
                       precision=_HI) + result.mean[:, None])
