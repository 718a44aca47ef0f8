"""Current-source density (surface Laplacian) and bad-channel
interpolation by spherical splines (Perrin, Pernier, Bertrand &
Echallier 1989, EEG Clin Neurophysiol 72:184).

No reference counterpart — CSD is the standard reference-free transform
EEG pipelines apply before connectivity (it sharpens topographies and
suppresses volume conduction, directly serving the phase-lag /
coherence families here), and the SAME spline machinery interpolates
bad channels, completing the preprocessing chain next to
``ops/reject.py`` (trial rejection) and ``ops/ica.py``.

Design: everything per-montage is a tiny (C, C) dense problem, so the
spline system (Legendre series + bordered solve) is prepared ONCE in
float64 numpy on the host (cached per montage/parameter key) and the
per-sample application is one float32 (C, C) @ (C, N) device matmul —
the only part that scales with data.  float32 could not build the
series stably anyway (the (2n+1)/(n(n+1))^m terms span ~12 decades at
the default 50 degrees), and a per-montage host solve costs microseconds.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["spline_matrices", "csd_transform", "csd",
           "interpolation_matrix", "interpolate_channels"]


def _legendre_series(cosang, m: int, n_terms: int):
    """``sum_n (2n+1) / (n (n+1))^m P_n(x)`` for n = 1..n_terms, float64.

    The Bonnet recurrence ``(n+1) P_{n+1} = (2n+1) x P_n - n P_{n-1}``
    is numerically benign on [-1, 1]; the weights decay like n^{1-2m}.
    """
    x = np.asarray(cosang, np.float64)
    p_prev = np.ones_like(x)                 # P_0
    p = x.copy()                             # P_1
    out = np.zeros_like(x)
    for n in range(1, n_terms + 1):
        w = (2 * n + 1.0) / (n * (n + 1.0)) ** m
        out += w * p
        p_next = ((2 * n + 1.0) * x * p - n * p_prev) / (n + 1.0)
        p_prev, p = p, p_next
    return out / (4.0 * np.pi)


def _unit_rows(pos):
    pos = np.asarray(pos, np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError("positions must be (C, 3)")
    nrm = np.linalg.norm(pos, axis=1, keepdims=True)
    if np.any(nrm < 1e-12):
        raise ValueError("zero-length electrode position")
    return pos / nrm


def spline_matrices(pos, stiffness: int = 4, n_legendre: int = 50):
    """Perrin spline kernels for a montage: (C, C) float64 ``G`` (the
    potential kernel ``g(cos theta_ij)``) and ``H`` (the surface-
    Laplacian kernel, one stiffness order lower).  Positions are
    projected to the unit sphere."""
    u = _unit_rows(pos)
    cosang = np.clip(u @ u.T, -1.0, 1.0)
    g = _legendre_series(cosang, stiffness, n_legendre)
    h = _legendre_series(cosang, stiffness - 1, n_legendre)
    return g, h


def _bordered_system(g, lam: float) -> np.ndarray:
    """The Perrin sum-to-zero spline system ``[[G + lam I, 1],
    [1^T, 0]]`` — shared by the CSD transform, channel interpolation,
    and the topomap grid (``utils/plotting.py``), so the constraint and
    regularization live in exactly one place."""
    c = g.shape[0]
    a = np.zeros((c + 1, c + 1))
    a[:c, :c] = g + lam * np.eye(c)
    a[:c, c] = 1.0
    a[c, :c] = 1.0
    return a


@lru_cache(maxsize=16)
def _csd_matrix_cached(pos_key, stiffness, n_legendre, lam, head_radius):
    pos = np.frombuffer(pos_key, np.float64).reshape(-1, 3)
    g, h = spline_matrices(pos, stiffness, n_legendre)
    c = g.shape[0]
    # solve [w; d] = A^{-1} [x; 0]; CSD = H w / r^2
    ainv = np.linalg.inv(_bordered_system(g, lam))
    # x -> w is the top-left (C, C) block of A^{-1} applied to x
    w_of_x = ainv[:c, :c]
    t = (h @ w_of_x) / (head_radius ** 2)
    return np.ascontiguousarray(t, np.float64)


def csd_transform(pos, stiffness: int = 4, n_legendre: int = 50,
                  lam: float = 1e-5,
                  head_radius: float = 1.0) -> np.ndarray:
    """The (C, C) float64 linear map from referenced potentials to
    current-source density for this montage (host-side, cached):
    ``CSD = T @ x`` per sample.  ``lam`` is the Perrin smoothing on the
    G diagonal; ``head_radius`` (meters) scales to physical uV/m^2 —
    the default 1.0 leaves spline units."""
    u = _unit_rows(pos)
    if not 2 <= int(stiffness) <= 6:
        raise ValueError("stiffness must be in 2..6")
    return _csd_matrix_cached(u.tobytes(), int(stiffness),
                              int(n_legendre), float(lam),
                              float(head_radius))


@jax.jit
def _apply_jit(t, x):
    # (C, C) @ (..., C, N): exact-f32 — CSD differences cancel heavily
    flat = jnp.moveaxis(x, -2, 0).reshape(x.shape[-2], -1)
    out = jnp.matmul(t, flat, precision=lax.Precision.HIGHEST)
    return jnp.moveaxis(out.reshape((x.shape[-2],) + x.shape[:-2]
                                    + (x.shape[-1],)), 0, -2)


def csd(x, pos, stiffness: int = 4, n_legendre: int = 50,
        lam: float = 1e-5, head_radius: float = 1.0) -> jnp.ndarray:
    """Current-source density of (..., C, N) data for electrode
    ``pos`` (C, 3).  Reference-free: any per-sample constant (the
    reference) maps to exactly 0, which is the point of the transform.
    The montage solve runs once on the host; the application is one
    device matmul."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim < 2 or x.shape[-2] != np.asarray(pos).shape[0]:
        raise ValueError("x must be (..., C, N) matching pos (C, 3)")
    t = jnp.asarray(csd_transform(pos, stiffness, n_legendre, lam,
                                  head_radius), jnp.float32)
    return _apply_jit(t, x)


def interpolation_matrix(pos, bad_idx, stiffness: int = 4,
                         n_legendre: int = 50,
                         lam: float = 1e-5) -> np.ndarray:
    """(B, C_good) float64 map from the GOOD channels to spline
    estimates at the bad sites (Perrin spherical-spline channel
    interpolation — mne's ``interpolate_bads`` method)."""
    u = _unit_rows(pos)
    c = u.shape[0]
    bad_idx = np.atleast_1d(np.asarray(bad_idx, int))
    if bad_idx.size == 0:
        raise ValueError("no bad channels given")
    if np.unique(bad_idx).size != bad_idx.size or \
            bad_idx.min() < 0 or bad_idx.max() >= c:
        raise ValueError("bad_idx must be unique valid channel indices")
    good = np.setdiff1d(np.arange(c), bad_idx)
    if good.size < 3:
        raise ValueError("need at least 3 good channels")
    gg, _ = spline_matrices(u[good], stiffness, n_legendre)
    ng = good.size
    ainv = np.linalg.inv(_bordered_system(gg, lam))
    # cross kernel bad x good
    cosang = np.clip(u[bad_idx] @ u[good].T, -1.0, 1.0)
    gb = _legendre_series(cosang, stiffness, n_legendre)
    # value at bad site = gb w + d, with [w; d] = A^{-1} [x; 0]
    return gb @ ainv[:ng, :ng] + ainv[ng, :ng][None, :]


def interpolate_channels(x, pos, bad_idx, stiffness: int = 4,
                         n_legendre: int = 50,
                         lam: float = 1e-5) -> jnp.ndarray:
    """Replace the listed channels of (..., C, N) data with spherical-
    spline interpolations from the good channels; other channels pass
    through untouched."""
    x = jnp.asarray(x, jnp.float32)
    c = np.asarray(pos).shape[0]
    if x.ndim < 2 or x.shape[-2] != c:
        raise ValueError("x must be (..., C, N) matching pos (C, 3)")
    bad_idx = np.atleast_1d(np.asarray(bad_idx, int))
    m = interpolation_matrix(pos, bad_idx, stiffness, n_legendre, lam)
    good = np.setdiff1d(np.arange(c), bad_idx)
    interp = _apply_interp_jit(jnp.asarray(m, jnp.float32), x,
                               tuple(int(i) for i in good),
                               tuple(int(i) for i in bad_idx))
    return interp


@partial(jax.jit, static_argnames=("good", "bad"))
def _apply_interp_jit(m, x, good, bad):
    gx = x[..., jnp.asarray(good), :]
    est = jnp.einsum("bg,...gn->...bn", m, gx,
                     precision=lax.Precision.HIGHEST)
    return x.at[..., jnp.asarray(bad), :].set(est)
