"""Signal complexity: sample entropy, multiscale entropy, permutation
entropy (Bandt-Pompe), and their multiscale profiles.

No reference counterpart — these are the standard EEG complexity
measures (anesthesia depth, consciousness, development, dementia
literatures) computed from exactly the epoched arrays the adapters
already hold, completing the nonlinear family next to
``extensions.wavelet_entropy`` (spectral) and ``ops/cycles.py``
(waveform shape).

Design:

* sample entropy is O(N^2) template matching; the Chebyshev distance
  between all embedding pairs is built as a (N', N') |x_i - x_j| plane
  whose running max over the ``m`` embedding offsets is an unrolled
  elementwise pass (m is 2-3 in practice) — no gathers, no sorting;
  batched signals stream through ``lax.map`` in fixed-size chunks so
  HBM holds a bounded number of pair planes;
* the count of matches at m and m + 1 comes off the SAME plane stack
  (the m + 1 max is one more elementwise max) — one pass, two counts;
* permutation entropy ranks each embedding window by pairwise
  comparisons ((L, m, m) broadcast, no argsort), encodes the rank
  vector as an integer Lehmer-style code, and histograms with a
  one-hot matmul — the (m^m,) bin table never leaves the device;
* multiscale profiles unroll the (static) scale list inside one jit:
  each coarse-grained series has its own static length, and Costa's
  convention (r fixed from the scale-1 std) means no per-scale host
  sync.
"""
from __future__ import annotations

from functools import partial
from math import factorial as _factorial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["sample_entropy", "multiscale_entropy",
           "permutation_entropy", "multiscale_permutation_entropy",
           "dfa"]

_CHUNK = 8  # signals per lax.map step: bounds the live pair planes


def _sampen_counts(x, m: int, r):
    """Template-match counts for one (N,) series: ``(B, A)`` = number of
    ordered pairs (i != j) whose Chebyshev distance is < r at embedding
    dimension m and m + 1.  ``r`` is a scalar (already scaled)."""
    n = x.shape[-1]
    np_ = n - m                                    # templates incl. m+1
    d = jnp.abs(x[:, None] - x[None, :])           # (N, N)
    # running Chebyshev max over the m offsets, cropped to (N', N')
    cheb = d[:np_, :np_]
    for k in range(1, m):
        cheb = jnp.maximum(cheb, d[k:k + np_, k:k + np_])
    hit_m = (cheb < r).astype(jnp.float32)
    cheb1 = jnp.maximum(cheb, d[m:m + np_, m:m + np_])
    hit_m1 = (cheb1 < r).astype(jnp.float32)
    eye = jnp.eye(np_, dtype=jnp.float32)
    return (jnp.sum(hit_m) - jnp.sum(eye),
            jnp.sum(hit_m1) - jnp.sum(eye))


@partial(jax.jit, static_argnames=("m", "scale_r"))
def _sampen_jit(x, r, *, m, scale_r):
    shape = x.shape[:-1]
    flat = x.reshape((-1, x.shape[-1]))
    rr = r * jnp.std(flat, axis=-1) if scale_r else jnp.full(
        (flat.shape[0],), r, flat.dtype)
    pad = (-flat.shape[0]) % _CHUNK
    flat = jnp.pad(flat, ((0, pad), (0, 0)))
    rr = jnp.pad(rr, (0, pad), constant_values=1.0)
    chunks = flat.reshape((-1, _CHUNK, flat.shape[-1]))
    rch = rr.reshape((-1, _CHUNK))

    def one(args):
        sig, rs = args
        return jax.vmap(lambda s, q: _sampen_counts(s, m, q))(sig, rs)

    b, a = lax.map(one, (chunks, rch))
    b = b.reshape((-1,))[:int(np.prod(shape)) if shape else 1]
    a = a.reshape((-1,))[:b.shape[0]]
    # SampEn = -ln(A / B); no matches at m -> inf by convention, which
    # we clamp to the max finite estimate -ln(1 / (B_pairs)) analog:
    # return inf as jnp.inf and let callers decide (standard tooling
    # reports inf for too-short / too-clean series).
    out = jnp.where((a > 0) & (b > 0), -jnp.log(
        jnp.maximum(a, 1e-30) / jnp.maximum(b, 1e-30)), jnp.inf)
    return out.reshape(shape) if shape else out[0]


def sample_entropy(x, m: int = 2, r: float = 0.2,
                   scale_r: bool = True) -> jnp.ndarray:
    """Sample entropy (Richman & Moorman 2000) of (..., N) series.

    ``SampEn = -ln(A / B)`` with B/A the ordered template pairs within
    Chebyshev tolerance ``r`` at embedding dimension ``m`` / ``m + 1``
    (self-matches excluded).  ``scale_r=True`` (default, the standard
    convention) uses ``r * std`` per series; otherwise ``r`` is
    absolute.  Series with no matches return ``inf`` (too short or too
    clean), never NaN.  Higher = less regular: white noise ~2.2 at the
    defaults, a pure sine ~0.
    """
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-1] < m + 2:
        raise ValueError(f"need N > m + 1 = {m + 1} samples")
    if not 1 <= int(m) <= 8:
        raise ValueError("m must be in 1..8")
    return _sampen_jit(x, float(r), m=int(m), scale_r=bool(scale_r))


def multiscale_entropy(x, m: int = 2, r: float = 0.2,
                       scales=10) -> jnp.ndarray:
    """Multiscale (sample) entropy (Costa, Goldberger & Peng 2002):
    (..., N) -> (..., S).

    Scale s coarse-grains by non-overlapping means of s samples, then
    computes sample entropy with the tolerance FIXED at ``r * std`` of
    the ORIGINAL series (Costa's convention — the tolerance must not
    shrink with the coarse-grained variance, or the profile flattens
    artificially).  ``scales`` is an int (1..scales) or an explicit
    list.  The classic signature: white noise decays with scale, 1/f
    noise stays elevated — long-range correlation survives
    coarse-graining.
    """
    x = jnp.asarray(x, jnp.float32)
    scales = tuple(range(1, int(scales) + 1)) if np.isscalar(scales) \
        else tuple(int(s) for s in scales)
    if any(s < 1 for s in scales):
        raise ValueError("scales must be >= 1")
    if x.shape[-1] // max(scales) < m + 2:
        raise ValueError("largest scale leaves fewer than m + 2 samples")
    r_abs = float(r) * jnp.std(x, axis=-1)
    # one r per series, broadcast through the per-scale sampen calls
    return _mse_scan(x, r_abs, m=int(m), scales=scales)


@partial(jax.jit, static_argnames=("m", "scales"))
def _mse_scan(x, r_abs, *, m, scales):
    outs = []
    flat_r = r_abs.reshape((-1,)) if r_abs.ndim else r_abs[None]
    for s in scales:
        ncg = x.shape[-1] // s
        cg = jnp.mean(
            x[..., :ncg * s].reshape(x.shape[:-1] + (ncg, s)), axis=-1)
        shape = cg.shape[:-1]
        flat = cg.reshape((-1, ncg))
        pad = (-flat.shape[0]) % _CHUNK
        flatp = jnp.pad(flat, ((0, pad), (0, 0)))
        rp = jnp.pad(flat_r, (0, pad), constant_values=1.0)

        def one(args, _m=m):
            sig, rs = args
            return jax.vmap(
                lambda t, q: _sampen_counts(t, _m, q))(sig, rs)

        b, a = lax.map(one, (flatp.reshape((-1, _CHUNK, ncg)),
                             rp.reshape((-1, _CHUNK))))
        b = b.reshape((-1,))[:flat.shape[0]]
        a = a.reshape((-1,))[:flat.shape[0]]
        se = jnp.where((a > 0) & (b > 0), -jnp.log(
            jnp.maximum(a, 1e-30) / jnp.maximum(b, 1e-30)), jnp.inf)
        outs.append(se.reshape(shape))
    return jnp.stack(outs, axis=-1)


def _ordinal_codes(x, m: int, tau: int):
    """(..., L) integer code of each length-m ordinal pattern (stride
    tau): rank each element by pairwise comparison with stable
    index tie-break (ties keep original order, the Bandt-Pompe
    convention), then Lehmer-style encode ``sum_k rank_k * m^k``."""
    n = x.shape[-1]
    el = n - (m - 1) * tau
    win = jnp.stack([x[..., k * tau:k * tau + el] for k in range(m)],
                    axis=-1)                               # (..., L, m)
    a = win[..., :, None]                                  # (..., L, m, 1)
    b = win[..., None, :]                                  # (..., L, 1, m)
    less = (b < a).astype(jnp.int32)
    idx = jnp.arange(m, dtype=jnp.int32)
    tie = ((b == a) & (idx[:, None] > idx[None, :])).astype(jnp.int32)
    ranks = jnp.sum(less + tie, axis=-1)                   # (..., L, m)
    weights = (m ** idx).astype(jnp.int32)
    return jnp.sum(ranks * weights, axis=-1)               # (..., L)


@partial(jax.jit, static_argnames=("m", "tau", "normalized"))
def _perm_entropy_jit(x, *, m, tau, normalized):
    codes = _ordinal_codes(x, m, tau)
    nbins = m ** m
    onehot = jax.nn.one_hot(codes, nbins, dtype=jnp.float32)
    counts = jnp.sum(onehot, axis=-2)                      # (..., m^m)
    p = counts / jnp.sum(counts, axis=-1, keepdims=True)
    h = -jnp.sum(jnp.where(p > 0, p * jnp.log(jnp.maximum(p, 1e-30)),
                           0.0), axis=-1)
    if normalized:
        h = h / float(np.log(float(_factorial(m))))
    return h


def permutation_entropy(x, m: int = 3, tau: int = 1,
                        normalized: bool = True) -> jnp.ndarray:
    """Permutation entropy (Bandt & Pompe 2002) of (..., N) series.

    Shannon entropy of the ordinal-pattern distribution of length-``m``
    embedding windows (delay ``tau``); ties resolve by original order
    (the B&P convention).  ``normalized=True`` divides by ``ln(m!)`` so
    the result lands in [0, 1]: a monotone ramp gives 0, white noise
    ~1.  Robust to amplitude scaling and monotone transforms by
    construction (only ranks enter).
    """
    x = jnp.asarray(x, jnp.float32)
    if not 2 <= int(m) <= 6:
        raise ValueError("m must be in 2..6 (m^m pattern bins)")
    if x.shape[-1] < (m - 1) * tau + m:
        raise ValueError("series too short for the embedding")
    return _perm_entropy_jit(x, m=int(m), tau=int(tau),
                             normalized=bool(normalized))


@partial(jax.jit, static_argnames=("m", "tau", "normalized", "scales"))
def _mpe_jit(x, *, m, tau, normalized, scales):
    outs = []
    for s in scales:
        ncg = x.shape[-1] // s
        cg = jnp.mean(
            x[..., :ncg * s].reshape(x.shape[:-1] + (ncg, s)), axis=-1)
        outs.append(_perm_entropy_jit(cg, m=m, tau=tau,
                                      normalized=normalized))
    return jnp.stack(outs, axis=-1)


def multiscale_permutation_entropy(x, m: int = 3, tau: int = 1,
                                   scales=10,
                                   normalized: bool = True
                                   ) -> jnp.ndarray:
    """Permutation entropy over coarse-graining scales:
    (..., N) -> (..., S) — the ordinal analog of
    :func:`multiscale_entropy` (Aziz & Arif 2005), cheaper and
    tolerance-free."""
    x = jnp.asarray(x, jnp.float32)
    scales = tuple(range(1, int(scales) + 1)) if np.isscalar(scales) \
        else tuple(int(s) for s in scales)
    if any(s < 1 for s in scales):
        raise ValueError("scales must be >= 1")
    if x.shape[-1] // max(scales) < (m - 1) * tau + m:
        raise ValueError("largest scale leaves too few samples for the "
                         "embedding")
    return _mpe_jit(x, m=int(m), tau=int(tau),
                    normalized=bool(normalized), scales=scales)


def _dfa_fluct(y, s: int):
    """RMS fluctuation of the integrated profile ``y`` (..., N) around
    per-box least-squares lines at box size ``s`` (non-overlapping
    boxes from the front; the ragged tail is dropped, the standard
    Peng convention).  Closed-form per-box regression — the design
    matrix is the same for every box, so slope/intercept are two
    moment contractions, never a solve."""
    n = y.shape[-1]
    nb = n // s
    b = y[..., :nb * s].reshape(y.shape[:-1] + (nb, s))
    t = jnp.arange(s, dtype=jnp.float32)
    tm = (s - 1) / 2.0
    tv = jnp.sum((t - tm) ** 2)
    ym = jnp.mean(b, axis=-1, keepdims=True)
    slope = jnp.sum(b * (t - tm), axis=-1, keepdims=True) / tv
    resid = b - ym - slope * (t - tm)
    return jnp.sqrt(jnp.mean(resid ** 2, axis=(-2, -1)))


@partial(jax.jit, static_argnames=("scales",))
def _dfa_jit(x, *, scales):
    y = jnp.cumsum(x - jnp.mean(x, axis=-1, keepdims=True), axis=-1)
    f = jnp.stack([_dfa_fluct(y, s) for s in scales], axis=-1)
    logs = jnp.log(jnp.asarray(scales, jnp.float32))
    logf = jnp.log(jnp.maximum(f, 1e-30))
    lm = jnp.mean(logs)
    alpha = jnp.sum((logs - lm) * (logf - jnp.mean(
        logf, axis=-1, keepdims=True)), axis=-1) / jnp.sum(
            (logs - lm) ** 2)
    return alpha, f


def dfa(x, scales=None, min_scale: int = 4, n_scales: int = 12):
    """Detrended fluctuation analysis (Peng 1995) of (..., N) series:
    the scaling exponent alpha of the integrated, per-box-detrended
    fluctuation ``F(s) ~ s^alpha``.

    ``alpha`` = 0.5 for white noise, ~1.0 for 1/f (the long-range-
    correlated regime neural amplitude envelopes live in — the
    Linkenkaer-Hansen workflow), ~1.5 for brown noise.  ``scales``
    defaults to ``n_scales`` log-spaced box sizes from ``min_scale`` to
    N/4 (boxes need >= 4 points for a meaningful linear detrend; fewer
    than ~4 boxes per scale makes F(s) noisy).  Returns
    ``(alpha (...,), fluctuations (..., S))``; the log-log fit is
    ordinary least squares over the scale list.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[-1]
    if scales is None:
        hi = n // 4
        if hi <= min_scale:
            raise ValueError("series too short for DFA (need N > "
                             f"4 * {min_scale})")
        scales = np.unique(np.round(np.geomspace(
            min_scale, hi, int(n_scales))).astype(int))
    scales = tuple(int(s) for s in scales)
    if len(scales) < 2 or min(scales) < 4 or max(scales) > n:
        raise ValueError("need >= 2 scales, each in [4, N]")
    return _dfa_jit(x, scales=scales)
