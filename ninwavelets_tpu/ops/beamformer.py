"""LCMV beamforming: source-space projection from a user-supplied
leadfield (Van Veen et al. 1997, IEEE TBME 44:867).

No reference counterpart — the linearly-constrained minimum-variance
beamformer is the standard sensor-to-source projection; given a forward
model (leadfield) it is pure linear algebra, so this module stays
forward-model-agnostic: pass any (S, C) fixed-orientation or (S, 3, C)
free-orientation leadfield (from mne, FieldTrip, OpenMEEG, a spherical
model, ...), get unit-noise-gain spatial filters, source power maps,
and source time courses that feed every analysis in this framework
(the TFR engine, connectivity, statistics) unchanged.

Design: ONE (C, C) regularized covariance inverse (real solve),
then every source is independent batched tiny algebra —

* fixed orientation: ``w_s = C^{-1} l_s / (l_s^T C^{-1} l_s)`` as two
  matmuls over the whole (S, C) leadfield at once;
* free orientation: per-source (3, 3) generalized problems solved by a
  batched ``eigh`` (max-power orientation = dominant generalized
  eigenvector), then the fixed-orientation formula;
* neural activity index = source power / noise power (``w^T w``),
  the unit-gain normalization that removes the center-of-head bias.

All matmuls run at HIGHEST precision (inverted-covariance path)."""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["LCMVResult", "lcmv", "lcmv_apply",
           "DICSResult", "dics", "wavelet_csd",
           "source_coherence", "MinimumNormResult",
           "minimum_norm", "minimum_norm_apply"]

_HP = jax.lax.Precision.HIGHEST


class LCMVResult(NamedTuple):
    """Fitted beamformer: ``filters`` (S, C) spatial filters (rows
    apply to sensor data), ``power`` (S,) source variance, ``nai``
    (S,) neural activity index (unit-noise-gain power — use THIS for
    localization; raw power is center-biased), ``orientations``
    (S, 3) dipole orientations (fixed input -> the input orientations
    normalized; free input -> max-power orientation per source)."""
    filters: jnp.ndarray
    power: jnp.ndarray
    nai: jnp.ndarray
    orientations: jnp.ndarray


@partial(jax.jit, static_argnames=("reg",))
def _lcmv_fixed_jit(cov, lead, *, reg):
    c = cov.shape[0]
    covr = cov + reg * jnp.trace(cov) / c * jnp.eye(c, dtype=cov.dtype)
    ci_l = jnp.linalg.solve(covr, lead.T)             # (C, S)
    denom = jnp.sum(lead * ci_l.T, axis=1)            # l^T C^{-1} l
    denom = jnp.maximum(denom, 1e-30)
    w = ci_l.T / denom[:, None]                       # (S, C)
    power = 1.0 / denom
    noise = jnp.sum(w * w, axis=1)
    nai = power / jnp.maximum(noise, 1e-30)
    return w, power, nai


@partial(jax.jit, static_argnames=("reg",))
def _orient_jit(cov, lead3, *, reg):
    """Unit-noise-gain max-power orientation per source for a
    (S, 3, C) leadfield (Sekihara): NAI(u) = (u^T G u) / (u^T G2 u)
    with ``G = L C^{-1} L^T`` and ``G2 = L C^{-2} L^T`` — maximized by
    the dominant generalized eigenvector of (G, G2), solved batched as
    an ordinary eigh of ``G2^{-1/2} G G2^{-1/2}``.  (The naive "min
    eigvec of G" pick is biased by per-orientation leadfield norms and
    picks wrong orientations on realistic leadfields.)"""
    c = cov.shape[0]
    covr = cov + reg * jnp.trace(cov) / c * jnp.eye(c, dtype=cov.dtype)
    s = lead3.shape[0]
    # one (C, S*3) solve: sensor axis MUST lead before the flatten
    lt = lead3.transpose(2, 0, 1).reshape(c, s * 3)
    ci_lt = jnp.linalg.solve(covr, lt)                 # (C, S*3)
    ci_lt = ci_lt.reshape(c, s, 3).transpose(1, 0, 2)  # (S, C, 3)
    g = jnp.einsum("sic,sco->sio", lead3, ci_lt,
                   precision=_HP)                      # L C^{-1} L^T
    g2 = jnp.einsum("sci,sco->sio", ci_lt, ci_lt,
                    precision=_HP)                     # L C^{-2} L^T
    g = 0.5 * (g + jnp.swapaxes(g, -1, -2))
    g2 = 0.5 * (g2 + jnp.swapaxes(g2, -1, -2))
    d2, v2 = jnp.linalg.eigh(g2)
    d2 = jnp.maximum(d2, 1e-12 * d2[..., -1:])
    isq = jnp.einsum("sij,sj,skj->sik", v2, 1.0 / jnp.sqrt(d2), v2,
                     precision=_HP)
    m = jnp.einsum("sij,sjk,skl->sil", isq, g, isq, precision=_HP)
    m = 0.5 * (m + jnp.swapaxes(m, -1, -2))
    _, vm = jnp.linalg.eigh(m)
    u = jnp.einsum("sij,sj->si", isq, vm[..., -1], precision=_HP)
    return u / jnp.maximum(
        jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-30)


def lcmv(cov, leadfield, reg: float = 0.05,
         noise_cov: Optional[np.ndarray] = None) -> LCMVResult:
    """Fit LCMV spatial filters from a (C, C) data covariance and a
    leadfield: (S, C) fixed-orientation, or (S, 3, C) free-orientation
    (the max-power orientation is selected per source).

    ``reg`` is the relative Tikhonov loading on the covariance
    diagonal (the standard 5% default).  ``noise_cov`` optionally
    whitens the NAI denominator (``w^T N w`` instead of ``w^T w``).
    Returns an :class:`LCMVResult`; localize on ``nai``, reconstruct
    time courses with :func:`lcmv_apply`.
    """
    cov = jnp.asarray(cov, jnp.float32)
    lead = jnp.asarray(leadfield, jnp.float32)
    if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
        raise ValueError("cov must be (C, C)")
    c = cov.shape[0]
    if lead.ndim == 3:
        if lead.shape[-1] != c or lead.shape[1] != 3:
            raise ValueError("free-orientation leadfield must be "
                             "(S, 3, C) matching cov")
        ori = _orient_jit(cov, lead, reg=float(reg))   # (S, 3)
        lead_fixed = jnp.einsum("so,soc->sc", ori, lead,
                                precision=_HP)
    elif lead.ndim == 2:
        if lead.shape[-1] != c:
            raise ValueError("leadfield must be (S, C) matching cov")
        lead_fixed = lead
        ori = jnp.full((lead.shape[0], 3), jnp.nan, jnp.float32)
    else:
        raise ValueError("leadfield must be (S, C) or (S, 3, C)")
    w, power, nai = _lcmv_fixed_jit(cov, lead_fixed, reg=float(reg))
    if noise_cov is not None:
        ncov = jnp.asarray(noise_cov, jnp.float32)
        noise = jnp.einsum("sc,cd,sd->s", w, ncov, w, precision=_HP)
        nai = power / jnp.maximum(noise, 1e-30)
    return LCMVResult(filters=w, power=power, nai=nai,
                      orientations=ori)


def lcmv_apply(result: LCMVResult, x) -> jnp.ndarray:
    """Project sensor data (..., C, N) to source space (..., S, N)
    with the fitted filters — the output is an ordinary multichannel
    array, so every analysis in this framework (TFR, connectivity,
    statistics) runs on source time courses unchanged."""
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-2] != result.filters.shape[1]:
        raise ValueError("channel count does not match the filters")
    return jnp.einsum("sc,...cn->...sn", result.filters, x,
                      precision=_HP)


class DICSResult(NamedTuple):
    """Frequency-domain beamformer (one per analyzed frequency):
    ``filters`` (S, C) real spatial filters, ``power`` (S,) source
    cross-spectral power, ``nai`` (S,) unit-noise-gain power."""
    filters: jnp.ndarray
    power: jnp.ndarray
    nai: jnp.ndarray


@partial(jax.jit, static_argnames=("interpolate", "time_range"))
def _wavelet_csd_jit(sigs, bank_r, *, interpolate, time_range):
    from .connectivity import pair_matrix_scan
    e_n = sigs.shape[0] * (sigs.shape[-1] if time_range is None
                           else time_range[1] - time_range[0])

    def per_row(sr, si):
        return (jnp.sum(sr, axis=-1) / e_n, jnp.sum(si, axis=-1) / e_n)

    return pair_matrix_scan(sigs, bank_r, per_row, interpolate,
                            time_range=time_range, precision=_HP)


def wavelet_csd(sigs_r, bank_r, interpolate: bool = False,
                time_range=None):
    """Epoch- and time-averaged wavelet cross-spectral density per bank
    row: (E, C, N) -> ((F, C, C), (F, C, C)) real/imag pair (the
    float-pair jit-boundary convention) — the input DICS consumes, and
    exactly the sums the connectivity matrices are built from.  Jitted:
    complex intermediates stay inside one compiled program."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _wavelet_csd_jit(jnp.asarray(sigs_r, jnp.float32),
                            jnp.asarray(bank_r, jnp.float32),
                            interpolate=bool(interpolate),
                            time_range=tr)


def dics(csd_r, csd_i, leadfield, reg: float = 0.05) -> DICSResult:
    """DICS spatial filters at ONE frequency (Gross et al. 2001, PNAS
    98:694) from a (C, C) cross-spectral density (real, imag) pair and
    an (S, C) fixed-orientation leadfield: ``w_s = Re(S)^{-1} l_s /
    (l_s^T Re(S)^{-1} l_s)`` (the standard real-filter variant), source
    power ``w^T Re(S) w``, NAI normalized by ``w^T w``.  Use
    :func:`wavelet_csd` to build the CSD from this framework's banks;
    localize oscillatory sources on ``nai`` and couple them with
    :func:`source_coherence`."""
    cr = jnp.asarray(csd_r, jnp.float32)
    lead = jnp.asarray(leadfield, jnp.float32)
    if cr.ndim != 2 or cr.shape[0] != cr.shape[1]:
        raise ValueError("csd must be (C, C)")
    if lead.ndim != 2 or lead.shape[-1] != cr.shape[0]:
        raise ValueError("leadfield must be (S, C) matching the csd")
    w, _, _ = _lcmv_fixed_jit(cr, lead, reg=float(reg))
    power = jnp.einsum("sc,cd,sd->s", w, cr, w, precision=_HP)
    noise = jnp.sum(w * w, axis=1)
    return DICSResult(filters=w, power=power,
                      nai=power / jnp.maximum(noise, 1e-30))


def source_coherence(result: DICSResult, csd_r, csd_i,
                     eps: float = 1e-12) -> jnp.ndarray:
    """(S, S) magnitude-squared coherence between the beamformed
    sources at this frequency: project the sensor CSD through the DICS
    filters (``S_src = W S W^T``, complex) and normalize by the source
    auto-spectra — source-space connectivity with the volume-conduction
    suppression the beamformer provides."""
    w = result.filters
    sr = jnp.einsum("ac,cd,bd->ab", w, jnp.asarray(csd_r, jnp.float32),
                    w, precision=_HP)
    si = jnp.einsum("ac,cd,bd->ab", w, jnp.asarray(csd_i, jnp.float32),
                    w, precision=_HP)
    num = sr * sr + si * si
    p = jnp.diagonal(sr)
    den = p[:, None] * p[None, :]
    den = jnp.maximum(den, eps * jnp.max(den))
    return num / den


class MinimumNormResult(NamedTuple):
    """Linear inverse operator: ``kernel`` (S, C) maps sensor data to
    source estimates (``method`` chooses the noise normalization)."""
    kernel: jnp.ndarray
    method: str


def minimum_norm(leadfield, lam: float = 1.0 / 9.0,
                 noise_cov=None, method: str = "mne",
                 depth: float = 0.0) -> MinimumNormResult:
    """Minimum-norm linear inverse from an (S, C) fixed-orientation
    leadfield: ``K = R L^T (L R L^T + lam * N)^{-1}`` (Hamalainen) with
    optional depth weighting ``R = diag(||l_s||^{-2 depth})``.

    ``method``: ``"mne"`` (raw current estimates), ``"dspm"`` (divide
    each row by its noise standard deviation ``sqrt(K N K^T)_ss`` — an
    F/z map), or ``"sloreta"`` (divide by ``sqrt(K L R)_ss``, the
    resolution-matrix standardization with ZERO localization bias for
    a single source in the noiseless limit — the property the test
    gates).  ``lam`` follows the mne convention ``1/SNR^2`` (default
    SNR = 3); ``noise_cov`` defaults to identity.

    The complement of :func:`lcmv`: non-adaptive (covariance-free), so
    it has no correlated-source cancellation — use it when sources are
    expected to be coherent, the beamformer when spatial resolution
    matters more."""
    lead = jnp.asarray(leadfield, jnp.float32)
    if lead.ndim != 2:
        raise ValueError("leadfield must be (S, C) fixed-orientation")
    method = str(method).lower()
    if method not in ("mne", "dspm", "sloreta"):
        raise ValueError("method must be mne / dspm / sloreta")
    s, c = lead.shape
    ncov = (jnp.eye(c, dtype=jnp.float32) if noise_cov is None
            else jnp.asarray(noise_cov, jnp.float32))
    if depth:
        r = jnp.sum(lead * lead, axis=1) ** (-float(depth))
    else:
        r = jnp.ones((s,), jnp.float32)
    rl = lead * r[:, None]                          # rows of R L^T
    gram = jnp.einsum("sc,sd->cd", rl, lead, precision=_HP)  # L^T R L
    a = gram + float(lam) * ncov
    kern = jnp.linalg.solve(a, rl.T).T              # (S, C)
    if method == "dspm":
        var = jnp.einsum("sc,cd,sd->s", kern, ncov, kern,
                         precision=_HP)
        kern = kern / jnp.sqrt(jnp.maximum(var, 1e-30))[:, None]
    elif method == "sloreta":
        res = jnp.einsum("sc,sc,s->s", kern, lead, r, precision=_HP)
        kern = kern / jnp.sqrt(jnp.maximum(res, 1e-30))[:, None]
    return MinimumNormResult(kernel=kern, method=method)


def minimum_norm_apply(result: MinimumNormResult, x) -> jnp.ndarray:
    """Project sensor data (..., C, N) to (..., S, N) source
    estimates with the fitted inverse kernel."""
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-2] != result.kernel.shape[1]:
        raise ValueError("channel count does not match the kernel")
    return jnp.einsum("sc,...cn->...sn", result.kernel, x,
                      precision=_HP)
