"""Automated epoch rejection: peak-to-peak thresholds and the
cross-validated global threshold search.

No reference counterpart — this is the standard preprocessing gate
(mne's ``reject=dict(eeg=...)``; Jas et al. 2017 "Autoreject"'s global
variant) applied before any of the TFR statistics this engine computes:
trials whose peak-to-peak amplitude exceeds a threshold on any channel
are dropped, and the threshold itself is chosen by cross-validation
instead of folklore.

Design — rejection is masking, never dynamic shapes:

* per-trial/channel peak-to-peak is one max-minus-min reduction over
  the (E, C, N) batch;
* the autoreject-global search evaluates EVERY candidate threshold x
  fold jointly: keep masks are (T, E) 0/1 WEIGHTS, the kept-trial
  evoked means are one weighted (T*K, E) @ (E, C*N) matmul against the
  trial stack, and the validation target (the median evoked — robust
  to the very artifacts being hunted) is a sort-based median per fold
  — no data-dependent shapes anywhere, so the whole search is one
  compiled program;
* candidate grids default to quantiles of the observed per-trial max
  peak-to-peak (always bracketing the data), drawn on device.

The adapter (``EpochsWavelet.drop_bad``) applies the mask on the HOST
(a one-time epoch subset — downstream shapes must actually shrink) and
returns a new composable adapter, mirroring ``modwt_denoise``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["ptp", "ptp_reject", "autoreject_global", "RejectResult",
           "regress_out", "find_bad_channels"]


class RejectResult(NamedTuple):
    """Outcome of the global threshold search.

    ``threshold`` float: the winning peak-to-peak threshold.
    ``drop_mask`` (E,) bool: True where the trial exceeds it (drop).
    ``thresholds`` (T,): the candidate grid.  ``cv_error`` (T,): mean
    validation RMSE per candidate (lower is better).
    """
    threshold: float
    drop_mask: jnp.ndarray
    thresholds: jnp.ndarray
    cv_error: jnp.ndarray


def ptp(x) -> jnp.ndarray:
    """(..., N) -> (...,) peak-to-peak amplitude (max - min)."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.max(x, axis=-1) - jnp.min(x, axis=-1)


def ptp_reject(x, threshold: float) -> jnp.ndarray:
    """(E, C, N) -> (E,) bool drop mask: True where ANY channel's
    peak-to-peak exceeds ``threshold`` (the mne ``reject`` rule)."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    return jnp.max(ptp(x), axis=-1) > threshold


@partial(jax.jit, static_argnames=("n_folds",))
def _cv_errors(x, thresholds, fold_ids, *, n_folds):
    """(T,) mean validation RMSE of the kept-trial evoked vs the
    fold-validation MEDIAN evoked, for every candidate threshold."""
    e = x.shape[0]
    trial_ptp = jnp.max(ptp(x), axis=-1)                  # (E,)
    keep = (trial_ptp[None, :] <= thresholds[:, None])    # (T, E) 0/1
    keep = keep.astype(jnp.float32)
    flat = x.reshape((e, -1))                             # (E, C*N)

    def fold(k):
        train = (fold_ids != k).astype(jnp.float32)       # (E,)
        w = keep * train[None, :]                         # (T, E)
        cnt = jnp.sum(w, axis=1, keepdims=True)           # (T, 1)
        mean_kept = jnp.matmul(
            w, flat, precision=lax.Precision.HIGHEST
        ) / jnp.maximum(cnt, 1.0)                         # (T, C*N)
        # Validation target: the pointwise MEDIAN over validation
        # trials — robust to the artifacts under test (Jas 2017 eq. 5).
        val = fold_ids == k
        big = jnp.where(val[:, None], flat, jnp.nan)
        target = jnp.nanmedian(big, axis=0)               # (C*N,)
        err = jnp.sqrt(jnp.mean((mean_kept - target[None, :]) ** 2,
                                axis=1))                  # (T,)
        # a threshold keeping NOTHING in train is invalid for this fold
        return jnp.where(cnt[:, 0] > 0, err, jnp.inf)

    errs = jax.vmap(fold)(jnp.arange(n_folds))            # (K, T)
    return jnp.mean(errs, axis=0)


def autoreject_global(x, thresholds=None, n_candidates: int = 30,
                      n_folds: int = 5, seed: int = 0) -> RejectResult:
    """Cross-validated global peak-to-peak threshold (Jas et al. 2017,
    the "global autoreject" variant) for an (E, C, N) epochs batch.

    For each candidate threshold, trials whose worst-channel
    peak-to-peak exceeds it are dropped from the training folds; the
    retained-trial evoked mean is scored against the validation folds'
    pointwise MEDIAN evoked (robust to the artifacts being hunted), and
    the threshold with the lowest mean RMSE wins.  ``thresholds``
    defaults to ``n_candidates`` quantiles of the observed per-trial
    max peak-to-peak, so the grid always brackets the data.

    Returns a :class:`RejectResult`; apply ``drop_mask`` yourself or
    use ``EpochsWavelet.drop_bad`` which returns a cleaned adapter.
    """
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 3:
        raise ValueError("x must be (E, C, N)")
    e = x.shape[0]
    if e < max(int(n_folds), 2):
        raise ValueError(f"need at least n_folds={n_folds} epochs")
    if thresholds is None:
        trial_ptp = jnp.max(ptp(x), axis=-1)
        qs = jnp.linspace(0.0, 1.0, int(n_candidates))
        thresholds = jnp.quantile(trial_ptp, qs)
    else:
        thresholds = jnp.asarray(thresholds, jnp.float32)
        if thresholds.ndim != 1 or thresholds.shape[0] < 1:
            raise ValueError("thresholds must be a 1-D grid")
    # round-robin fold assignment of a seeded permutation — balanced
    # folds with no dynamic shapes
    perm = np.random.default_rng(int(seed)).permutation(e)
    fold_ids = jnp.asarray(np.mod(np.argsort(perm), int(n_folds)),
                           jnp.int32)
    errs = _cv_errors(x, thresholds, fold_ids, n_folds=int(n_folds))
    best = int(jnp.argmin(errs))
    thr = float(thresholds[best])
    return RejectResult(threshold=thr,
                        drop_mask=ptp_reject(x, thr),
                        thresholds=thresholds, cv_error=errs)


@jax.jit
def _regress_out_jit(x, refs):
    xm = x - jnp.mean(x, axis=-1, keepdims=True)
    rm = refs - jnp.mean(refs, axis=-1, keepdims=True)
    # beta = (R R^T)^{-1} R X^T per batch row: tiny (K, K) solve
    g = jnp.matmul(rm, jnp.swapaxes(rm, -1, -2),
                   precision=lax.Precision.HIGHEST)
    g = g + 1e-9 * jnp.trace(g, axis1=-2, axis2=-1)[..., None, None] \
        * jnp.eye(g.shape[-1])
    cross = jnp.matmul(rm, jnp.swapaxes(xm, -1, -2),
                       precision=lax.Precision.HIGHEST)
    beta = jnp.linalg.solve(g, cross)                 # (K, C)
    return xm - jnp.matmul(jnp.swapaxes(beta, -1, -2), rm,
                           precision=lax.Precision.HIGHEST)


def regress_out(x, refs) -> jnp.ndarray:
    """Least-squares regression of reference channels out of
    (..., C, N) data (the classical EOG/ECG artifact correction —
    Gratton & Coles): each data channel loses its best linear fit on
    the (..., K, N) references.  Both are mean-centered first; the
    (K, K) normal equations get a relative ridge so collinear
    references stay solvable.  Shapes broadcast over leading batch
    dims (epochs)."""
    x = jnp.asarray(x, jnp.float32)
    refs = jnp.asarray(refs, jnp.float32)
    if refs.ndim == 1:
        refs = refs[None, :]
    if x.shape[-1] != refs.shape[-1]:
        raise ValueError("x and refs must share the time axis")
    if x.ndim != refs.ndim:
        raise ValueError("x and refs need matching batch dims "
                         "(add a channel axis to 1-D refs)")
    return _regress_out_jit(x, refs)


@partial(jax.jit, static_argnames=("sfreq", "hf_hz"))
def _chan_stats_jit(x, *, sfreq, hf_hz):
    """Per-channel QC statistics of a (C, N) recording, one compiled
    program: robust amplitude (MAD of the centered signal), high-
    frequency power fraction (Welch grid), and the full channel
    correlation matrix at HIGHEST precision (statistic path)."""
    c, n = x.shape
    med = jnp.median(x, axis=1, keepdims=True)
    mad = jnp.median(jnp.abs(x - med), axis=1) * 1.4826
    # HF/LF band powers off one Welch pass (pow2 segment <= N)
    from .irasa import welch_psd
    seg = 1 << min(10, int(np.log2(max(n, 4))))
    psd = welch_psd(x, sfreq=float(sfreq), nperseg=seg)
    freqs = jnp.arange(seg // 2 + 1) * (sfreq / seg)
    hi = freqs[None, :] >= hf_hz
    hf = jnp.sum(jnp.where(hi, psd, 0.0), axis=1)
    lf = jnp.sum(jnp.where(~hi, psd, 0.0), axis=1)
    hf_ratio = jnp.log(jnp.maximum(hf, 1e-30)
                       / jnp.maximum(lf, 1e-30))
    # correlation matrix on mean-centered channels
    xm = x - jnp.mean(x, axis=1, keepdims=True)
    norm = jnp.maximum(jnp.linalg.norm(xm, axis=1, keepdims=True), 1e-30)
    u = xm / norm
    corr = jnp.matmul(u, u.T, precision=lax.Precision.HIGHEST)
    # zero the diagonal: self-pairs must not win best-|corr| (a -2
    # offset would — |.| turns it back into 1)
    corr = corr * (1.0 - jnp.eye(c, dtype=corr.dtype))
    return mad, hf_ratio, corr


def _robust_z(v, mask, floor):
    """Robust z of ``v`` against the median/MAD of ``v[mask]``.
    ``floor`` bounds the scale from below: in a near-homogeneous
    montage the cross-channel MAD collapses and infinitesimal
    differences would otherwise z-explode into false flags (both
    criteria operate in LOG units, so the floor reads as a minimum
    fractional deviation)."""
    ref = v[mask] if mask.any() else v
    med = np.median(ref)
    mad = np.median(np.abs(ref - med)) * 1.4826
    return (v - med) / max(mad, floor)


def find_bad_channels(x, sfreq: float, *, flat_tol: float = 1e-10,
                      z_thresh: float = 5.0, hf_hz: float = 40.0,
                      corr_thresh: float = 0.3,
                      bridge_thresh: float = 0.995) -> dict:
    """Channel-level QC of a (C, N) recording (PREP-style criteria,
    Bigdely-Shamlo 2015).  Returns a dict of index lists:

    * ``flat`` — robust amplitude (1.4826 MAD) below ``flat_tol`` or
      1000x below the channel median (dead electrode);
    * ``noisy`` — robust-z of the log robust amplitude above
      ``z_thresh`` (the PREP deviation criterion);
    * ``hf`` — robust-z of the log high/low-frequency power ratio
      (split at ``hf_hz``, Welch grid) above ``z_thresh`` — muscle or
      line-dominated channels stand out against the montage's own
      spectral shape, so broadband-noise montages aren't mass-flagged;
      disabled (nothing flagged) when ``hf_hz >= sfreq/2`` — an empty
      high band would invert the ratio into a low-power detector;
    * ``uncorrelated`` — best |correlation| with every other good
      channel below ``corr_thresh`` (bad contact);
    * ``bridged`` — channel PAIRS (i, j) with |correlation| above
      ``bridge_thresh`` (electrolyte bridge — near-duplicate signals);
    * ``bads`` — the union of the single-channel criteria, sorted.

    Flat channels are excluded from every correlation criterion (their
    quantization noise correlates spuriously).  One compiled stats
    program + host thresholding (the thresholds are policy, not
    compute).  Feed ``bads`` to spherical-spline interpolation
    (``ops.csd.interpolate_channels``) or drop them.
    """
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("x must be (C, N)")
    c, n = x.shape
    if n < 8:
        raise ValueError("recording too short for channel QC")
    mad, hf, corr = (np.asarray(v) for v in
                     _chan_stats_jit(x, sfreq=float(sfreq),
                                     hf_hz=float(hf_hz)))
    med_amp = np.median(mad)
    flat = (mad < flat_tol) | (mad < 1e-3 * med_amp)
    good = ~flat
    la = np.log(np.maximum(mad, 1e-30))
    noisy = (_robust_z(la, good, 0.05) > z_thresh) & good
    if hf_hz >= sfreq / 2:          # empty high band — criterion off
        hf_bad = np.zeros(c, bool)
    else:
        hf_bad = (_robust_z(hf, good, 0.1) > z_thresh) & good
    corr = corr.copy()
    corr[flat, :] = 0.0
    corr[:, flat] = 0.0
    best = np.abs(corr).max(axis=1)
    uncorr = (best < corr_thresh) & good
    iu, ju = np.nonzero(np.triu(np.abs(corr) > bridge_thresh, 1))
    bads = sorted(set(np.flatnonzero(flat | noisy | hf_bad | uncorr)
                      .tolist()))
    return {"flat": np.flatnonzero(flat).tolist(),
            "noisy": np.flatnonzero(noisy).tolist(),
            "hf": np.flatnonzero(hf_bad).tolist(),
            "uncorrelated": np.flatnonzero(uncorr).tolist(),
            "bridged": list(zip(iu.tolist(), ju.tolist())),
            "bads": [int(b) for b in bads]}
