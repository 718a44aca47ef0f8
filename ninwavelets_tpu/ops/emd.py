"""Empirical Mode Decomposition (Huang et al., Proc. R. Soc. A 1998)
and its ensemble variant EEMD (Wu & Huang, AADA 2009): sift a signal
into intrinsic mode functions by repeatedly subtracting the mean of the
upper/lower extrema envelopes.  No reference counterpart — EMD completes
the adaptive-decomposition family next to EWT (``ops/ewt.py``) and VMD
(``ops/vmd.py``); with ``ops.vmd.instantaneous`` / ``hilbert_spectrum``
it forms the classical Hilbert–Huang transform.

Design notes (EMD is the textbook "impossible to vectorize"
algorithm; everything here is static-shape and batched):

* extrema knots are compacted WITHOUT dynamic shapes: the boolean
  extrema mask maps to positions ``where(mask, i, 2N + i)`` and one
  ``jnp.sort`` yields the ascending valid knots followed by ascending
  out-of-range padding (so every inter-knot gap stays > 0 and the
  tridiagonal solve never sees a degenerate row);
* all knots live ON the integer sample grid, so the per-sample segment
  index is a cumsum of the knot mask — no searchsorted, no gather-heavy
  binary search;
* the natural-cubic-spline second derivatives come from a Thomas solve
  written as two ``lax.scan``s over the knot axis with the whole batch
  (signals x {upper, lower}) riding the carry lanes; padded rows are
  identity equations, which also pins the natural boundary M_{k-1} = 0
  at the DYNAMIC end of the valid region;
* ``spline="akima"`` swaps in Akima's local slope rule — no linear
  system at all, fully parallel over knots (PyEMD's 'akima' option);
  ghost slopes at the dynamic right boundary are patched in by gather;
* sifting depth and IMF count are fixed (static) — the standard
  fixed-sift EMD of the EEMD paper (10 siftings) — so the whole
  decomposition is one ``lax.scan`` over IMF index; rows whose residual
  has fewer than 3 interior extrema freeze (emit zero IMFs), keeping
  ``sum(imfs) + residual == signal`` exact in float32;
* EEMD's noise realizations are just another batch axis: one jit call
  sifts the entire ensemble at once.

Boundary rule: the first and last samples are always knots of BOTH
envelopes (endpoint clamping).  This is simpler than mirror extension,
is exactly reproducible by the float64 oracle in the tests, and confines
the usual EMD end effects to roughly one extremal period at each edge.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["emd", "eemd", "n_imfs_default"]


def n_imfs_default(n: int) -> int:
    """The usual dyadic-bank heuristic: log2(N) minus a safety margin."""
    return max(1, int(np.log2(n)) - 3)


# ---------------------------------------------------------------- knots

def _interior_extrema(x, kind: str):
    """(B, N) bool mask of strict interior maxima ('max') / minima
    ('min'); endpoints are never marked (they are added as knots
    unconditionally)."""
    left = x[:, 1:-1] - x[:, :-2]
    right = x[:, 1:-1] - x[:, 2:]
    if kind == "max":
        hit = (left > 0) & (right > 0)
    else:
        hit = (left < 0) & (right < 0)
    return jnp.pad(hit, ((0, 0), (1, 1)))


def _knots(x, mask):
    """Compact (B, N) knot masks into sorted padded knot arrays.

    Returns ``(t, y, k)``: positions (B, K) float32 ascending (valid
    knots first, then out-of-range padding at 2N+i), values (B, K) with
    padding clamped to the last sample, and valid counts (B,) int32.
    K = N//2 + 2 (a strict interior extremum needs 2 samples of room,
    plus the two endpoint knots).
    """
    b, n = x.shape
    kmax = n // 2 + 2
    mask = mask.at[:, 0].set(True).at[:, -1].set(True)
    idx = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.where(mask, idx, 2 * n + idx)
    pos = jnp.sort(pos, axis=-1)[:, :kmax]
    y = jnp.take_along_axis(x, jnp.clip(pos, 0, n - 1), axis=-1)
    k = jnp.sum(mask, axis=-1).astype(jnp.int32)
    return pos.astype(jnp.float32), y, k, mask


# --------------------------------------------------------------- spline

def _thomas(a, b, c, d):
    """Batched tridiagonal solve: each arg (B, K); returns (B, K)."""
    def fwd(carry, abcd):
        cp_prev, dp_prev = carry
        aj, bj, cj, dj = abcd
        den = bj - aj * cp_prev
        cp = cj / den
        dp = (dj - aj * dp_prev) / den
        return (cp, dp), (cp, dp)

    bsz = a.shape[0]
    init = (jnp.zeros(bsz, a.dtype), jnp.zeros(bsz, a.dtype))
    _, (cp, dp) = lax.scan(fwd, init, (a.T, b.T, c.T, d.T))

    def bwd(m_next, cpdp):
        cpj, dpj = cpdp
        m = dpj - cpj * m_next
        return m, m

    _, m = lax.scan(bwd, jnp.zeros(bsz, a.dtype), (cp, dp), reverse=True)
    return m.T


def _natural_coeffs(t, y, k):
    """Per-segment cubic coefficients of the natural spline through the
    padded knots: returns (y, c1, c2, c3, h) each (B, K)."""
    h = jnp.diff(t, axis=-1)                       # (B, K-1) all > 0
    h = jnp.concatenate([h, jnp.ones_like(h[:, :1])], axis=-1)  # (B, K)
    slope = (jnp.roll(y, -1, axis=-1) - y) / h     # m_j on segment j
    j = jnp.arange(t.shape[-1])
    interior = (j[None, :] >= 1) & (j[None, :] <= (k[:, None] - 2))
    h_prev = jnp.roll(h, 1, axis=-1)
    s_prev = jnp.roll(slope, 1, axis=-1)
    a = jnp.where(interior, h_prev, 0.0)
    b = jnp.where(interior, 2.0 * (h_prev + h), 1.0)
    c = jnp.where(interior, h, 0.0)
    d = jnp.where(interior, 6.0 * (slope - s_prev), 0.0)
    m = _thomas(a, b, c, d)                        # second derivatives
    m_next = jnp.roll(m, -1, axis=-1)
    c1 = slope - h * (2.0 * m + m_next) / 6.0
    c2 = m / 2.0
    c3 = (m_next - m) / (6.0 * h)
    return y, c1, c2, c3


def _akima_coeffs(t, y, k):
    """Akima-slope cubic Hermite coefficients through the padded knots.

    Standard Akima ghost slopes (2*m0 - m1 ...) close both boundaries;
    the right boundary sits at the DYNAMIC index k-1, so its two ghost
    slopes are patched in with gathers before the weight rule runs.
    """
    kk = t.shape[-1]
    h = jnp.diff(t, axis=-1)
    h = jnp.concatenate([h, jnp.ones_like(h[:, :1])], axis=-1)
    m = (jnp.roll(y, -1, axis=-1) - y) / h         # slope of segment j

    # ghost slopes: left is static (segment 0), right is at k-2
    last = jnp.clip(k - 2, 0, kk - 1)              # last valid segment
    m_last = jnp.take_along_axis(m, last[:, None], axis=-1)[:, 0]
    m_prev = jnp.take_along_axis(m, jnp.clip(last - 1, 0, kk - 1)[:, None],
                                 axis=-1)[:, 0]
    g1 = 2.0 * m_last - m_prev                     # slope at segment k-1
    g2 = 2.0 * g1 - m_last                         # slope at segment k
    gl1 = 2.0 * m[:, :1] - m[:, 1:2]               # slope at segment -1
    gl2 = 2.0 * gl1 - m[:, :1]                     # slope at segment -2
    # extended slopes: column j+2 holds the slope of segment j, for
    # j in [-2, kk+1]; the two right ghosts are patched in at the
    # DYNAMIC columns k+1 and k+2 (segments k-1 and k).
    pad = jnp.zeros_like(m[:, :2])
    mext = jnp.concatenate([gl2, gl1, m, pad], axis=-1)   # (B, K+4)
    col = jnp.arange(kk + 4)[None, :]
    mext = jnp.where(col == (k + 1)[:, None], g1[:, None], mext)
    mext = jnp.where(col == (k + 2)[:, None], g2[:, None], mext)

    # Akima weight rule for the slope AT knot j: uses segments
    # j-2, j-1, j, j+1 (mext indices j, j+1, j+2, j+3).
    w1 = jnp.abs(mext[:, 3:kk + 3] - mext[:, 2:kk + 2])   # |m_{j+1}-m_j|
    w2 = jnp.abs(mext[:, 1:kk + 1] - mext[:, 0:kk])       # |m_{j-1}-m_{j-2}|
    den = w1 + w2
    flat = den < 1e-9 * (jnp.abs(mext[:, 2:kk + 2])
                         + jnp.abs(mext[:, 1:kk + 1]) + 1e-30)
    s = jnp.where(
        flat,
        0.5 * (mext[:, 1:kk + 1] + mext[:, 2:kk + 2]),
        (w1 * mext[:, 1:kk + 1] + w2 * mext[:, 2:kk + 2])
        / jnp.where(den == 0, 1.0, den))

    s_next = jnp.roll(s, -1, axis=-1)
    c1 = s
    c2 = (3.0 * m - 2.0 * s - s_next) / h
    c3 = (s + s_next - 2.0 * m) / (h * h)
    return y, c1, c2, c3


def _envelope(x, mask, spline: str):
    """(B, N) spline envelope through the knots marked by ``mask``."""
    if spline == "natural":
        return _envelope_grid(x, mask)
    b, n = x.shape
    t, y, k, mask = _knots(x, mask)
    y0, c1, c2, c3 = _akima_coeffs(t, y, k)
    # segment of sample tau = (# knots at or before tau) - 1, clipped to
    # the last valid segment k-2 (so tau = N-1 lands on segment k-2).
    seg = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
    seg = jnp.minimum(seg, (k - 2)[:, None])
    dt = jnp.arange(n, dtype=jnp.float32)[None, :] - jnp.take_along_axis(
        t, seg, axis=-1)
    g = lambda arr: jnp.take_along_axis(arr, seg, axis=-1)
    return g(y0) + dt * (g(c1) + dt * (g(c2) + dt * g(c3)))


# ------------------------------------------------- grid-domain natural

def _ffill(mask, v):
    """Forward-fill ``v`` (defined where ``mask``) along the last axis:
    out[i] = v at the last True position <= i (garbage before the first
    True — every caller marks sample 0).  One log-depth associative
    scan; no sort, no gather."""
    def comb(a, b):
        ma, va = a
        mb, vb = b
        return ma | mb, jnp.where(mb, vb, va)

    _, out = lax.associative_scan(
        comb, (mask, jnp.where(mask, v, 0.0)), axis=-1)
    return out


def _bfill(mask, v):
    """Backward-fill: out[i] = v at the first True position >= i."""
    return _ffill(mask[..., ::-1], v[..., ::-1])[..., ::-1]


def _envelope_grid(x, mask):
    """Natural-cubic-spline envelope computed ENTIRELY on the sample
    grid — the r4 rewrite of the sort-compaction path.

    The compact path (still used for Akima) spends its time in the five
    per-sample ``take_along_axis`` gathers of the evaluation stage plus
    the ``jnp.sort`` compaction.  Since every knot lies ON the integer
    grid, both disappear:

    * neighbor knot positions/values come from log-depth forward /
      backward fills (one associative scan each);
    * the Thomas solve runs over the N axis with pass-through steps at
      non-knot samples (the carry rides unchanged between knots, so the
      knot-to-knot recurrence is identical to the compact solve);
    * evaluation coefficients are fills of the knot-resident solution —
      no decompaction scatter, no seg-index gathers.

    Measured 4.1x the compact path at (64, 2048) (8.0 -> 1.9 ms).
    """
    b, n = x.shape
    mask = mask.at[:, 0].set(True).at[:, -1].set(True)
    iB = jnp.broadcast_to(jnp.arange(n, dtype=jnp.float32)[None, :],
                          (b, n))
    tprev = _ffill(mask, iB)           # knot position t_j of segment j
    tnext = _bfill(mask, iB)           # first knot >= i
    yprev = _ffill(mask, x)            # y_j
    ynext = _bfill(mask, x)
    # strictly-previous / strictly-next knot (for the knot rows): the
    # inclusive fill one sample to the left / right
    tm1 = jnp.concatenate([tprev[:, :1], tprev[:, :-1]], axis=-1)
    ym1 = jnp.concatenate([x[:, :1], yprev[:, :-1]], axis=-1)
    tp1 = jnp.concatenate([tnext[:, 1:], tnext[:, -1:]], axis=-1)
    yp1 = jnp.concatenate([ynext[:, 1:], x[:, -1:]], axis=-1)

    # Thomas rows at knots (natural BC: endpoint rows stay identity so
    # M = 0 there); non-knot samples carry the recurrence through.
    hprev = iB - tm1
    hnext = tp1 - iB
    interior = mask & (iB > 0) & (iB < n - 1)
    sl_prev = (x - ym1) / jnp.where(hprev > 0, hprev, 1.0)
    sl_next = (yp1 - x) / jnp.where(hnext > 0, hnext, 1.0)
    a = jnp.where(interior, hprev, 0.0)
    bb = jnp.where(interior, 2.0 * (hprev + hnext), 1.0)
    cc = jnp.where(interior, hnext, 0.0)
    dd = jnp.where(interior, 6.0 * (sl_next - sl_prev), 0.0)

    # Forward elimination as LOG-DEPTH associative scans (a sequential
    # 2048-step lax.scan per direction made the whole EMD latency-bound
    # — batch 4 and batch 64 took the same 96 ms/call):
    # cp_j = c_j / (b_j - a_j cp_{j-1}) is a Moebius map, composed as
    # normalized homogeneous 2x2 products; given cp, dp and the back
    # substitution are plain affine recurrences.  Non-knot samples
    # compose the identity, which is exactly the carry pass-through of
    # the sequential version.
    t00 = jnp.where(mask, 0.0, 1.0)
    t01 = jnp.where(mask, cc, 0.0)
    t10 = jnp.where(mask, -a, 0.0)
    t11 = jnp.where(mask, bb, 1.0)

    def _mob(p, q):
        p00, p01, p10, p11 = p
        q00, q01, q10, q11 = q
        r00 = q00 * p00 + q01 * p10
        r01 = q00 * p01 + q01 * p11
        r10 = q10 * p00 + q11 * p10
        r11 = q10 * p01 + q11 * p11
        # the cp ratio is scale-invariant; normalize so ~1000-deep
        # products of h-scaled entries cannot overflow f32
        s = jnp.maximum(jnp.maximum(jnp.abs(r00), jnp.abs(r01)),
                        jnp.maximum(jnp.abs(r10), jnp.abs(r11)))
        s = jnp.where(s > 0, s, 1.0)
        return r00 / s, r01 / s, r10 / s, r11 / s

    _, m01, _, m11 = lax.associative_scan(
        _mob, (t00, t01, t10, t11), axis=-1)
    cp = m01 / jnp.where(m11 != 0, m11, 1.0)   # prefix @ (0, 1)

    def _aff(p, q):                    # x -> A x + B, p earlier than q
        ap, bp = p
        aq, bq = q
        return ap * aq, bq + aq * bp

    cp_prev = jnp.concatenate([jnp.zeros_like(cp[:, :1]), cp[:, :-1]],
                              axis=-1)
    den = bb - a * cp_prev
    af = jnp.where(mask, -a / den, 1.0)
    bf = jnp.where(mask, dd / den, 0.0)
    _, dp = lax.associative_scan(_aff, (af, bf), axis=-1)

    ab = jnp.where(mask, -cp, 1.0)[:, ::-1]
    bbk = jnp.where(mask, dp, 0.0)[:, ::-1]
    _, mrev = lax.associative_scan(_aff, (ab, bbk), axis=-1)
    mgrid = jnp.where(mask, mrev[:, ::-1], 0.0)  # second derivatives

    mj = _ffill(mask, mgrid)           # M_j for segment j
    bfm = _bfill(mask, mgrid)
    mj1 = jnp.concatenate([bfm[:, 1:], bfm[:, -1:]], axis=-1)  # M_{j+1}
    yj1 = jnp.concatenate([ynext[:, 1:], x[:, -1:]], axis=-1)  # y_{j+1}
    tj1 = jnp.concatenate([tnext[:, 1:], tnext[:, -1:]], axis=-1)
    h = tj1 - tprev
    hs = jnp.where(h > 0, h, 1.0)      # dt = 0 wherever h would be 0
    dt = iB - tprev
    slope = (yj1 - yprev) / hs
    c1 = slope - hs * (2.0 * mj + mj1) / 6.0
    c2 = mj / 2.0
    c3 = (mj1 - mj) / (6.0 * hs)
    return yprev + dt * (c1 + dt * (c2 + dt * c3))


# -------------------------------------------------------------- sifting

def _mean_envelope(x, spline: str):
    if spline == "natural":
        # one stacked call: the grid path is latency-bound (log-depth
        # scan count, not FLOPs), so riding upper+lower on the batch
        # axis halves the scan launches
        b = x.shape[0]
        mm = jnp.concatenate([_interior_extrema(x, "max"),
                              _interior_extrema(x, "min")], axis=0)
        env = _envelope_grid(jnp.concatenate([x, x], axis=0), mm)
        return 0.5 * (env[:b] + env[b:])
    upper = _envelope(x, _interior_extrema(x, "max"), spline)
    lower = _envelope(x, _interior_extrema(x, "min"), spline)
    return 0.5 * (upper + lower)


def _n_extrema(x):
    return (jnp.sum(_interior_extrema(x, "max"), axis=-1)
            + jnp.sum(_interior_extrema(x, "min"), axis=-1))


@partial(jax.jit, static_argnames=("n_imfs", "n_siftings", "spline"))
def _emd_jit(x, *, n_imfs, n_siftings, spline):
    def extract(r, _):
        active = _n_extrema(r) >= 3                # (B,) bool

        def sift(h, _):
            return h - _mean_envelope(h, spline), None

        h, _ = lax.scan(sift, r, None, length=n_siftings)
        imf = jnp.where(active[:, None], h, 0.0)
        return r - imf, imf

    residual, imfs = lax.scan(extract, x, None, length=n_imfs)
    return jnp.moveaxis(imfs, 0, 1), residual      # (B, M, N), (B, N)


def emd(signal_r, n_imfs: int | None = None, n_siftings: int = 10,
        spline: str = "natural"):
    """``(imfs, residual)`` of a real (..., N) signal: intrinsic mode
    functions (..., M, N) from fast to slow, plus the monotone-trend
    residual (..., N).  ``sum(imfs, -2) + residual == signal`` exactly.

    ``n_imfs`` defaults to ``log2(N) - 3``; ``n_siftings`` is the fixed
    sifting depth per IMF (the EEMD paper's protocol — 10 is standard);
    ``spline`` is ``"natural"`` (canonical cubic-spline envelopes) or
    ``"akima"`` (local slopes, no tridiagonal solve — tighter envelopes;
    its dynamic-column ghost patches are gathers where natural splines
    run Thomas scans).  Rows whose residual
    drops below 3
    interior extrema stop early and emit zero IMFs.
    """
    if spline not in ("natural", "akima"):
        raise ValueError("spline must be 'natural' or 'akima'")
    x = jnp.asarray(signal_r, jnp.float32)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("signal too short for EMD (N >= 8)")
    if n_imfs is None:
        n_imfs = n_imfs_default(n)
    lead = x.shape[:-1]
    imfs, res = _emd_jit(x.reshape(-1, n), n_imfs=int(n_imfs),
                         n_siftings=int(n_siftings), spline=spline)
    return (imfs.reshape(*lead, int(n_imfs), n), res.reshape(*lead, n))


@partial(jax.jit,
         static_argnames=("n_imfs", "n_siftings", "spline", "n_ensembles"))
def _eemd_jit(x, key, *, n_imfs, n_siftings, spline, n_ensembles,
              noise_strength):
    b, n = x.shape
    sd = jnp.std(x, axis=-1, keepdims=True)        # (B, 1)
    noise = jax.random.normal(key, (n_ensembles, b, n), x.dtype)
    ens = x[None] + noise_strength * sd[None] * noise
    imfs, _ = _emd_jit(ens.reshape(-1, n), n_imfs=n_imfs,
                       n_siftings=n_siftings, spline=spline)
    imfs = jnp.mean(imfs.reshape(n_ensembles, b, n_imfs, n), axis=0)
    return imfs, x - jnp.sum(imfs, axis=-2)


def eemd(signal_r, n_imfs: int | None = None, n_ensembles: int = 100,
         noise_strength: float = 0.2, n_siftings: int = 10,
         spline: str = "natural", seed: int = 0):
    """Ensemble EMD (Wu & Huang 2009): ``emd`` over ``n_ensembles``
    white-noise-perturbed copies (noise sd = ``noise_strength`` x signal
    sd), IMFs averaged across the ensemble — the standard fix for mode
    mixing.  The whole ensemble is ONE batched jit call (realizations
    ride a leading batch axis).  Returns ``(imfs, residual)`` with the
    residual defined as ``signal - sum(imfs)`` so reconstruction stays
    exact after averaging.
    """
    if spline not in ("natural", "akima"):
        raise ValueError("spline must be 'natural' or 'akima'")
    x = jnp.asarray(signal_r, jnp.float32)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("signal too short for EMD (N >= 8)")
    if n_imfs is None:
        n_imfs = n_imfs_default(n)
    lead = x.shape[:-1]
    imfs, res = _eemd_jit(
        x.reshape(-1, n), jax.random.PRNGKey(seed), n_imfs=int(n_imfs),
        n_siftings=int(n_siftings), spline=spline,
        n_ensembles=int(n_ensembles),
        noise_strength=float(noise_strength))
    return (imfs.reshape(*lead, int(n_imfs), n), res.reshape(*lead, n))
