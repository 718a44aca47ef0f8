"""Artifact subspace reconstruction (ASR): sliding-window subspace
cleaning of continuous multichannel recordings (Mullen et al. 2015,
IEEE TBME 62:2553 — the BCILAB/EEGLAB `clean_rawdata` method).

No reference counterpart — ASR is the de-facto standard automatic
artifact remover for continuous EEG (transient high-variance components
are reconstructed from a calibration model instead of discarded),
completing the preprocessing chain next to trial rejection
(``ops/reject.py``), ICA (``ops/ica.py``), and spline repair
(``ops/csd.py``).

Design — the whole processing pass is batched tiny linear algebra:

* calibration: one covariance, one ``eigh``, per-component window-RMS
  statistics with robust (median/MAD) moments — thresholds per
  calibration principal direction;
* processing: ALL sliding windows at once — (W, C, C) covariances by
  one matmul over Hann-weighted frames, a batched ``eigh``, the keep
  test ``d_j < sum_i th_i^2 (v_cal_i . v_w_j)^2`` as one matmul, and
  the reconstruction ``R = M pinv_keep(V_w^T M) V_w^T`` WITHOUT any
  SVD: zeroing rejected rows makes the normal-equation matrix block
  diagonal, so padding its rejected diagonal with 1s gives an exact
  masked inverse by a plain batched solve;
* overlap-add: 50%-hop Hann windows (constant overlap-add), one
  scatter-free weighted fold.

Everything runs at HIGHEST matmul precision — covariance conditioning
feeds matrix inverses (the repo's standard rule for inverted paths).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["ASRModel", "asr_calibrate", "asr_process"]

_HP = jax.lax.Precision.HIGHEST


class ASRModel(NamedTuple):
    """Calibration state: ``mixing`` (C, C) = sqrtm of the calibration
    covariance, ``v_cal`` (C, C) its eigenvectors (columns), and
    ``thresholds`` (C,) the per-direction RMS limits (mu + cutoff *
    sigma of the calibration window RMS, robust moments)."""
    mixing: jnp.ndarray
    v_cal: jnp.ndarray
    thresholds: jnp.ndarray


def _frames(x, win: int, hop: int):
    """(C, N) -> (W, C, win) sliding frames (drop the ragged tail)."""
    n = x.shape[-1]
    w = max(1, (n - win) // hop + 1)
    idx = jnp.arange(win)[None, :] + hop * jnp.arange(w)[:, None]
    return x[:, idx].transpose(1, 0, 2)               # (W, C, win)


@partial(jax.jit, static_argnames=("win", "hop", "cutoff"))
def _calibrate_jit(x, *, win, hop, cutoff):
    c, n = x.shape
    x = x - jnp.mean(x, axis=-1, keepdims=True)
    cov = jnp.matmul(x, x.T, precision=_HP) / n
    d, v = jnp.linalg.eigh(cov)                       # ascending
    d = jnp.maximum(d, 1e-12 * d[-1])
    mixing = (v * jnp.sqrt(d)[None, :]) @ v.T         # sqrtm
    # per-component RMS over calibration windows
    fr = _frames(x, win, hop)                         # (W, C, win)
    proj = jnp.einsum("ck,wkt->wct", v.T, fr, precision=_HP)
    rms = jnp.sqrt(jnp.mean(proj * proj, axis=-1))    # (W, C)
    mu = jnp.median(rms, axis=0)
    sigma = 1.4826 * jnp.median(jnp.abs(rms - mu[None, :]), axis=0)
    thresholds = mu + cutoff * sigma
    return ASRModel(mixing=mixing, v_cal=v, thresholds=thresholds)


def asr_calibrate(x_cal, sfreq: float, cutoff: float = 5.0,
                  win_s: float = 0.5) -> ASRModel:
    """Fit the ASR model on (C, N) CALIBRATION data (a clean stretch —
    resting baseline, or the lowest-amplitude windows of the recording;
    see ``RawWavelet.asr_clean`` for automatic selection).

    ``cutoff`` is the standard deviations-above-calibration threshold
    (EEGLAB default 5 — smaller = more aggressive); ``win_s`` the RMS
    window."""
    x_cal = jnp.asarray(x_cal, jnp.float32)
    if x_cal.ndim != 2:
        raise ValueError("x_cal must be (C, N)")
    win = max(4, int(round(win_s * sfreq)) & ~1)      # match processing
    if x_cal.shape[-1] < 4 * win:
        raise ValueError("calibration needs at least 4 windows")
    return _calibrate_jit(x_cal, win=win, hop=win // 2,
                          cutoff=float(cutoff))


@partial(jax.jit, static_argnames=("win",))
def _process_jit(x, mixing, v_cal, thresholds, *, win):
    c, n = x.shape
    # calibration statistics are learned on mean-centered data, so the
    # recording is centered per channel GLOBALLY here (a constant DC
    # offset would otherwise blow every window past threshold) and the
    # offsets are restored on the output.  Per-WINDOW centering would
    # be wrong — it folds half of any slow artifact into a mean that
    # gets reinjected after reconstruction.
    ch_mean = jnp.mean(x, axis=-1, keepdims=True)
    x = x - ch_mean
    hop = win // 2
    # pad so every sample is covered by exactly two Hann windows
    pad = (hop, win)
    xp = jnp.pad(x, ((0, 0), pad))
    np_ = xp.shape[-1]
    w = (np_ - win) // hop + 1
    fr = _frames(xp, win, hop)                        # (W, C, win)
    hann = jnp.float32(0.5) - 0.5 * jnp.cos(
        2.0 * jnp.pi * (jnp.arange(win) + 0.5) / win)
    # window covariance on Hann-weighted frames (tapered estimate)
    frw = fr * hann[None, None, :]
    cov = jnp.einsum("wct,wdt->wcd", frw, frw,
                     precision=_HP) / jnp.sum(hann * hann)
    dw, vw = jnp.linalg.eigh(cov)                     # (W, C), (W, C, C)
    # keep test against the calibration thresholds projected onto the
    # window's eigendirections
    proj = jnp.einsum("ic,wij->wcj", v_cal, vw,
                      precision=_HP)                  # (W, Ccal, j)?
    limit = jnp.einsum("c,wcj->wj", thresholds ** 2, proj * proj)
    keep = dw <= limit                                # (W, C)
    # masked reconstruction R = M pinv_keep(Vw^T M) Vw^T
    a = jnp.einsum("wij,ik->wjk", vw, mixing,
                   precision=_HP)                     # (W, C, C) Vw^T M
    ak = jnp.where(keep[..., None], a, 0.0)
    b = jnp.einsum("wjk,wlk->wjl", ak, ak, precision=_HP)
    b = b + jnp.where(keep, 0.0, 1.0)[..., None] * jnp.eye(c)
    # pinv(ak) = ak^T b^{-1} = (b^{-1} ak)^T (b symmetric): rejected
    # rows of ak are zero, so the padded-identity diagonal never leaks
    pinv = jnp.swapaxes(jnp.linalg.solve(b, ak), -1, -2)  # (W, C, C)
    # R = M @ pinv @ Vw^T (Vw^T[j, l] = vw[l, j]); all-kept -> R = I
    r = jnp.einsum("ik,wkj,wlj->wil", mixing, pinv, vw,
                   precision=_HP)
    clean_fr = jnp.einsum("wcd,wdt->wct", r, fr, precision=_HP)
    # all-kept windows pass through untouched (R == I analytically;
    # skip its round-off)
    allkeep = jnp.all(keep, axis=-1)
    clean_fr = jnp.where(allkeep[:, None, None], fr, clean_fr)
    # Hann overlap-add (50% hop -> constant weight sum)
    wfr = clean_fr * hann[None, None, :]
    acc = jnp.zeros((c, np_))
    wsum = jnp.zeros((np_,))
    idx = (jnp.arange(win)[None, :] + hop * jnp.arange(w)[:, None])
    acc = acc.at[:, idx.reshape(-1)].add(
        jnp.moveaxis(wfr, 1, 0).reshape(c, -1))
    wsum = wsum.at[idx.reshape(-1)].add(
        jnp.broadcast_to(hann, (w, win)).reshape(-1))
    out = acc / jnp.maximum(wsum[None, :], 1e-12)
    return out[:, hop:hop + n] + ch_mean, keep


def asr_process(x, sfreq: float, model: ASRModel,
                win_s: float = 0.5):
    """Clean a (C, N) recording with a fitted :class:`ASRModel`.

    Returns ``(cleaned (C, N), keep (W, C))`` — ``keep`` flags which
    principal components of each 50%-overlapped Hann window survived
    (all-True windows pass through bit-exactly).  Stateless: windows
    are independent, so arbitrarily long recordings can stream through
    in chunks with ``win_s`` of overlap."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("x must be (C, N)")
    if x.shape[0] != model.mixing.shape[0]:
        raise ValueError("channel count does not match the model")
    win = max(4, int(round(win_s * sfreq)) & ~1)      # even
    return _process_jit(x, model.mixing, model.v_cal,
                        model.thresholds, win=win)
