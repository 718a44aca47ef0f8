"""Discrete wavelet transforms: MODWT, multiresolution analysis, wavelet
variance, and MODWT wavelet shrinkage.

No reference counterpart — ``ninwavelets`` is CWT-only (`base.py`,
`wavelets.py`); this module widens the framework to the DISCRETE side of
wavelet analysis (Percival & Walden, "Wavelet Methods for Time Series
Analysis"): the maximal-overlap DWT (shift-invariant, defined for any
length, the standard tool for wavelet variance and shrinkage on
time-series), its exact inverse, the additive multiresolution analysis,
and denoising.

Device formulation
------------------
The textbook MODWT is a filter pyramid (level j circularly convolves the
previous smooth with an a-trous-upsampled filter) — a sequential,
gather-heavy recursion.  Here we instead build the LEVEL TRANSFER
FUNCTIONS once on host,

    Htil_j(k) = Htil(2^{j-1} k mod N) * prod_{m<j-1} Gtil(2^m k mod N)

(a (J+1, N) frequency-domain bank: J detail rows plus the level-J
scaling row), and the whole transform becomes ``ifft(bank * fft(x))`` —
EXACTLY the CWT engine's shape (`ops/cwt.py:cwt_from_bank`), one batched
FFT pipeline instead of a J-deep recursion.  The inverse is the
conjugate bank (the MODWT filter bank is a tight frame:
``sum_j |Htil_j|^2 + |Gtil_J|^2 == 1``), so reconstruction is exact to
float round-off.  Circular boundary conditions throughout (the classical
MODWT definition).  Power-of-two lengths keep the FFTs on their fastest
path (pad first).

Daubechies filters are COMPUTED (spectral factorization of the Daubechies
half-band polynomial, minimum-phase root selection) rather than
transcribed from tables, for any order 1..20; correctness is gated by the
orthonormality identities in ``tests/test_dwt.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["wavelet_filter", "modwt_bank", "modwt", "imodwt", "modwt_mra",
           "modwt_var", "modwt_denoise", "max_level",
           "wavedec", "waverec", "pow2_pad", "modwt_cov", "modwt_corr",
           "modwt_var_ci"]


# ----------------------------------------------------------------------------
# Filters
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def wavelet_filter(name: str = "db4"):
    """Orthonormal scaling/wavelet filter pair ``(g, h)`` (float64 numpy).

    ``"haar"`` / ``"db1"`` .. ``"db20"``: Daubechies extremal-phase
    filters with ``p`` vanishing moments (length ``2p``), built by
    spectral factorization: the half-band autocorrelation
    ``|G(f)|^2 = 2 cos^2p(pi f) sum_k C(p-1+k, k) sin^2k(pi f)`` is
    factored by selecting the roots of the sum polynomial inside the unit
    circle (minimum phase), then normalized to ``sum g = sqrt(2)``.
    The wavelet filter follows by quadrature mirror:
    ``h[l] = (-1)^l g[L-1-l]``.
    """
    key = name.lower()
    if key == "haar":
        key = "db1"
    if not key.startswith("db"):
        raise ValueError(f"unknown wavelet {name!r} (haar, db1..db20)")
    p = int(key[2:])
    if not 1 <= p <= 20:
        raise ValueError(f"db order must be 1..20, got {p}")
    if p == 1:
        g = np.array([1.0, 1.0]) / np.sqrt(2.0)
    else:
        # P(y) = sum_k C(p-1+k, k) y^k with y = sin^2(pi f); in z (with
        # y = (2 - z - 1/z)/4) the valid factorization keeps the roots of
        # P inside the unit disc.  np.roots on the y-polynomial, then map
        # each y-root to its z-root pair and keep |z| < 1.
        from math import comb
        coeffs = [comb(p - 1 + k, k) for k in range(p)]      # ascending
        yroots = np.roots(list(reversed(coeffs)))            # p-1 roots
        zroots = []
        for y in yroots:
            # y = (2 - z - 1/z) / 4  =>  z^2 - (2 - 4y) z + 1 = 0
            b = 2.0 - 4.0 * y
            disc = np.sqrt(b * b - 4.0 + 0j)
            z1, z2 = (b + disc) / 2.0, (b - disc) / 2.0
            zroots.append(z1 if abs(z1) < 1.0 else z2)
        # g(z) ~ (1 + z)^p * prod (z - z_r), real coefficients.
        poly = np.array([1.0 + 0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for zr in zroots:
            poly = np.convolve(poly, [1.0, -zr])
        g = np.real(poly)
        g *= np.sqrt(2.0) / g.sum()
    h = (g[::-1] * (-1.0) ** np.arange(g.size))
    return g, h


def max_level(n: int, name: str = "db4") -> int:
    """Largest level J with a non-wrapping filter: the level-J MODWT
    filter spans ``(2^J - 1)(L - 1) + 1`` samples; J is capped so that
    span fits in ``n`` (and by ``log2(n)``)."""
    L = wavelet_filter(name)[0].size
    j = 0
    while (2 ** (j + 1) - 1) * (L - 1) + 1 <= n and 2 ** (j + 1) <= n:
        j += 1
    return max(j, 1)


@functools.lru_cache(maxsize=64)
def modwt_bank(name: str, level: int, n: int):
    """(level+1, n) frequency-domain MODWT bank as a float32 numpy
    ``(real, imag)`` pair: rows 0..level-1 are the detail transfer
    functions ``Htil_j``, row ``level`` is the scaling transfer
    ``Gtil_J``.  Cached NUMPY (host) per the jit-boundary rule."""
    if level < 1:
        raise ValueError("level must be >= 1")
    if 2 ** level > n:
        raise ValueError(f"level {level} needs 2^J <= N, got N={n}")
    g, h = wavelet_filter(name)
    gt, ht = g / np.sqrt(2.0), h / np.sqrt(2.0)    # MODWT scaling
    k = np.arange(n)
    tw = np.exp(-2j * np.pi * np.outer(k, np.arange(g.size)) / n)
    G, H = tw @ gt, tw @ ht                        # base transfers at f_k
    rows = []
    gprod = np.ones(n, np.complex128)
    for j in range(1, level + 1):
        rows.append(H[(2 ** (j - 1) * k) % n] * gprod)
        gprod = gprod * G[(2 ** (j - 1) * k) % n]
    rows.append(gprod)                             # Gtil_J
    bank = np.stack(rows)
    return (np.ascontiguousarray(bank.real, np.float32),
            np.ascontiguousarray(bank.imag, np.float32))


# ----------------------------------------------------------------------------
# Transform / inverse / MRA
# ----------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("inverse",))
def _apply_bank(x, br, bi, *, inverse: bool):
    """``ifft(bank * fft(x))`` rows (forward) or the conjugate-bank
    synthesis sum (inverse).  Real in, real out (the transfers are DFTs
    of real filters, hence Hermitian)."""
    bank = jax.lax.complex(br, bi)
    if not inverse:
        spec = jnp.fft.fft(x.astype(jnp.complex64))
        w = jnp.fft.ifft(spec[..., None, :] * bank)
        return jnp.real(w).astype(jnp.float32)
    spec = jnp.fft.fft(x.astype(jnp.complex64))        # x: (..., J+1, N)
    acc = jnp.sum(jnp.conj(bank) * spec, axis=-2)
    return jnp.real(jnp.fft.ifft(acc)).astype(jnp.float32)


@jax.jit
def _mra_bank(w, br, bi):
    """Per-row synthesis WITHOUT the cross-row sum: additive components
    ``D_j = ifft(conj(Htil_j) fft(W_j))`` (and the smooth from the last
    row)."""
    bank = jax.lax.complex(br, bi)
    spec = jnp.fft.fft(w.astype(jnp.complex64))
    return jnp.real(jnp.fft.ifft(jnp.conj(bank) * spec)).astype(jnp.float32)


def modwt(x, wavelet: str = "db4", level: int | None = None):
    """Maximal-overlap DWT of ``x``: (..., N) -> (..., J+1, N) float32.

    Rows 0..J-1 are the detail coefficients ``W_1 .. W_J`` (band
    ``[1/2^{j+1}, 1/2^j]`` cycles/sample), row J the level-J scaling
    coefficients ``V_J``.  Shift-invariant, energy-preserving
    (``sum_rows ||row||^2 == ||x||^2``), circular boundary.  ``level``
    defaults to ``max_level(N, wavelet)``.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[-1]
    if level is None:
        level = max_level(n, wavelet)
    br, bi = modwt_bank(wavelet, int(level), n)
    return _apply_bank(x, jnp.asarray(br), jnp.asarray(bi), inverse=False)


def imodwt(w, wavelet: str = "db4"):
    """Exact inverse MODWT: (..., J+1, N) -> (..., N) float32.  The MODWT
    rows form a tight frame, so synthesis is the conjugate bank — no
    pyramid recursion, reconstruction error is float round-off."""
    w = jnp.asarray(w, jnp.float32)
    level = w.shape[-2] - 1
    br, bi = modwt_bank(wavelet, int(level), w.shape[-1])
    return _apply_bank(w, jnp.asarray(br), jnp.asarray(bi), inverse=True)


def modwt_mra(x, wavelet: str = "db4", level: int | None = None):
    """Multiresolution analysis: (..., N) -> (..., J+1, N) additive
    components ``D_1 .. D_J, S_J`` with ``sum(rows) == x`` exactly (to
    round-off).  Each ``D_j`` is the zero-phase band-limited part of
    ``x`` in the level-j octave — unlike the coefficients, the components
    line up with ``x`` in time."""
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[-1]
    if level is None:
        level = max_level(n, wavelet)
    br, bi = modwt_bank(wavelet, int(level), n)
    br, bi = jnp.asarray(br), jnp.asarray(bi)
    return _mra_bank(_apply_bank(x, br, bi, inverse=False), br, bi)


# ----------------------------------------------------------------------------
# Decimated DWT (periodization mode)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _dwt_transfers(name: str, n: int):
    """Base filter DFTs at length ``n`` as float32 numpy (Gr, Gi, Hr, Hi)
    — cached NUMPY per the jit-boundary rule."""
    g, h = wavelet_filter(name)
    k = np.arange(n)
    tw = np.exp(-2j * np.pi * np.outer(k, np.arange(g.size)) / n)
    G, H = tw @ g, tw @ h
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (G.real, G.imag, H.real, H.imag))


def _dwt_level(v, trans):
    """One analysis level: circular filter + take the odd samples
    (``W[t] = sum_l h_l v[(2t+1-l) mod n]``, Percival & Walden eq. 96) —
    the filtering rides one FFT, the decimation is a strided slice."""
    gr, gi, hr, hi = trans
    spec = jnp.fft.fft(v.astype(jnp.complex64))
    a = jnp.real(jnp.fft.ifft(spec * jax.lax.complex(gr, gi)))
    w = jnp.real(jnp.fft.ifft(spec * jax.lax.complex(hr, hi)))
    return (a[..., 1::2].astype(jnp.float32),
            w[..., 1::2].astype(jnp.float32))


def _idwt_level(a, w, trans):
    """One synthesis level: upsample-by-2 onto the odd slots, then the
    CONJUGATE transfers (synthesis is correlation, not convolution) —
    exact inverse of ``_dwt_level`` for orthonormal filters."""
    gr, gi, hr, hi = trans
    n = 2 * a.shape[-1]
    ua = jnp.zeros(a.shape[:-1] + (n,), jnp.float32).at[..., 1::2].set(a)
    uw = jnp.zeros(w.shape[:-1] + (n,), jnp.float32).at[..., 1::2].set(w)
    sa = jnp.fft.fft(ua.astype(jnp.complex64))
    sw = jnp.fft.fft(uw.astype(jnp.complex64))
    out = (sa * jnp.conj(jax.lax.complex(gr, gi))
           + sw * jnp.conj(jax.lax.complex(hr, hi)))
    return jnp.real(jnp.fft.ifft(out)).astype(jnp.float32)


@functools.lru_cache(maxsize=32)
def _wavedec_jitted(name: str, level: int, n: int):
    trans = [tuple(jnp.asarray(t) for t in _dwt_transfers(name, n >> j))
             for j in range(level)]

    def run(x):
        v, out = x, []
        for j in range(level):          # static unroll: shapes halve
            v, w = _dwt_level(v, trans[j])
            out.append(w)
        return tuple([v] + out[::-1])   # pywt wavedec order

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _waverec_jitted(name: str, level: int, n: int):
    trans = [tuple(jnp.asarray(t) for t in _dwt_transfers(name, n >> j))
             for j in range(level)]

    def run(coeffs):
        v = coeffs[0]
        for j in range(level - 1, -1, -1):
            v = _idwt_level(v, coeffs[level - j], trans[j])
        return v

    return jax.jit(run)


def wavedec(x, wavelet: str = "db4", level: int | None = None):
    """Decimated orthogonal DWT, periodization mode: (..., N) ->
    ``(cA_J, cD_J, ..., cD_1)`` (the pywt ``wavedec`` coefficient order;
    level-j arrays have ``N / 2^j`` samples).  Requires ``2^J | N``.

    Downsampled counterpart of ``modwt`` — the two satisfy
    ``cD_j[t] = 2^{j/2} W^M_j[(2^j (t+1) - 1) mod N]`` exactly, which the
    tests use as the cross-oracle.  Orthonormal, so the coefficient
    energies sum to ``||x||^2``.  Each level is one FFT filter pass plus
    a strided slice (compiler-friendly static shapes; the J-level loop is
    unrolled at trace time).
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[-1]
    if level is None:
        level = min(max_level(n, wavelet),
                    (n & -n).bit_length() - 1)     # largest 2^J | N
    if level < 1 or n % (1 << level):
        raise ValueError(f"level {level} needs 2^level | N (N={n})")
    return _wavedec_jitted(str(wavelet), int(level), n)(x)


def waverec(coeffs, wavelet: str = "db4"):
    """Inverse of ``wavedec``: ``(cA_J, cD_J, ..., cD_1)`` -> (..., N)
    float32, exact to round-off."""
    level = len(coeffs) - 1
    n = coeffs[-1].shape[-1] * 2
    for i, c in enumerate(coeffs):
        want = n >> (level if i == 0 else level - i + 1)
        if c.shape[-1] != want:
            raise ValueError(
                f"coeff {i} has {c.shape[-1]} samples, expected {want}")
    return _waverec_jitted(str(wavelet), int(level), n)(
        tuple(jnp.asarray(c, jnp.float32) for c in coeffs))


# ----------------------------------------------------------------------------
# Wavelet variance and shrinkage
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _interior_masks(name: str, level: int, n: int):
    """(level, n) float32 numpy mask of BOUNDARY-FREE coefficients per
    detail level, plus the (level,) interior counts: the level-j MODWT
    filter spans ``L_j = (2^j - 1)(L - 1) + 1`` samples, so coefficients
    ``t < L_j - 1`` mix in circularly wrapped samples (Percival & Walden
    eq. 306).  Levels with no interior coefficients get an all-zero row
    (count 0 -> the unbiased estimators return NaN there)."""
    L = wavelet_filter(name)[0].size
    mask = np.zeros((level, n), np.float32)
    counts = np.zeros((level,), np.float32)
    for j in range(1, level + 1):
        lj = (2 ** j - 1) * (L - 1) + 1
        m = n - lj + 1
        if m > 0:
            mask[j - 1, lj - 1:] = 1.0
            counts[j - 1] = m
    return mask, counts


def modwt_var(x, wavelet: str = "db4", level: int | None = None,
              unbiased: bool = False):
    """Wavelet variance by scale: (..., N) -> (..., J) — the level-j
    entry is ``||W_j||^2 / N``, the portion of the sample variance living
    in octave ``[1/2^{j+1}, 1/2^j]`` cycles/sample (the biased MODWT
    estimator; the rows plus the smooth's variance partition
    ``mean(x^2)`` exactly, by energy preservation).

    ``unbiased=True`` gives the Percival & Walden estimator instead:
    only boundary-FREE coefficients (those not contaminated by the
    circular wrap) enter the mean — unbiased for the true wavelet
    variance of a stationary process, at the cost of the exact
    partition.  Levels whose filter span exceeds N return NaN."""
    w = modwt(x, wavelet, level)
    d = w[..., :-1, :]
    if not unbiased:
        return jnp.mean(jnp.square(d), axis=-1)
    mask, counts = _interior_masks(wavelet, d.shape[-2], d.shape[-1])
    return (jnp.sum(jnp.square(d) * jnp.asarray(mask), axis=-1)
            / jnp.asarray(counts))


@functools.partial(jax.jit, static_argnames=("mode",))
def _shrink(w, thresholds, *, mode: str):
    t = thresholds[..., :, None]
    d = w[..., :-1, :]
    if mode == "soft":
        d = jnp.sign(d) * jnp.maximum(jnp.abs(d) - t, 0.0)
    else:
        d = jnp.where(jnp.abs(d) > t, d, 0.0)
    return jnp.concatenate([d, w[..., -1:, :]], axis=-2)


def pow2_pad(x):
    """Reflect-pad the last axis up to the next power of two, returning
    ``(padded, original_n)``.  Power-of-two lengths are the FFT's fastest
    case, and real recordings are rarely pow2 — reflection keeps the circular-boundary artifacts of the
    padded transform away from the retained samples."""
    n = x.shape[-1]
    n2 = 1 << (n - 1).bit_length()
    if n2 == n:
        return x, n
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n2 - n)]
    return jnp.pad(x, pad, mode="reflect"), n


def modwt_denoise(x, wavelet: str = "db4", level: int | None = None,
                  mode: str = "soft", sigma: float | None = None,
                  pad_pow2: bool = False):
    """Wavelet shrinkage on the MODWT: threshold the detail rows, keep
    the smooth, invert.  (..., N) -> (..., N) float32.

    ``pad_pow2=True`` reflect-pads to the next power of two before the
    transform and crops after — the fast-FFT path for arbitrary-length
    recordings (``pow2_pad``); the retained samples are unaffected except
    within one filter span of the far edge.

    The threshold is level-dependent universal: the level-j MODWT detail
    filter has squared norm ``1/2^j``, so white noise of std ``sigma``
    lands at std ``sigma / 2^{j/2}`` in level j and
    ``lambda_j = sigma sqrt(2 ln N) / 2^{j/2}``.  ``sigma`` defaults to
    the level-1 MAD estimate ``median(|W_1|) / 0.6745 * sqrt(2)``
    (Donoho-Johnstone, corrected for the level-1 filter norm).

    ``mode``: "soft" (shrink toward zero — smoother, the usual default)
    or "hard" (keep-or-kill).
    """
    if mode not in ("soft", "hard"):
        raise ValueError(f"mode must be 'soft' or 'hard', got {mode!r}")
    x = jnp.asarray(x, jnp.float32)
    if pad_pow2:
        padded, n0 = pow2_pad(x)
        if n0 != padded.shape[-1]:
            return modwt_denoise(padded, wavelet, level, mode,
                                 sigma)[..., :n0]
    n = x.shape[-1]
    if level is None:
        level = max_level(n, wavelet)
    w = modwt(x, wavelet, level)
    if sigma is None:
        sig = (jnp.median(jnp.abs(w[..., 0, :]), axis=-1) / 0.6745
               * np.sqrt(2.0))
    else:
        sig = jnp.full(x.shape[:-1], float(sigma), jnp.float32)
    j = jnp.arange(1, int(level) + 1, dtype=jnp.float32)
    lam = (sig[..., None] * np.sqrt(2.0 * np.log(n))
           / jnp.exp2(j / 2.0))
    return imodwt(_shrink(w, lam, mode=str(mode)), wavelet)


def _level_mean(d, wavelet, unbiased):
    """Per-level mean over time, biased (all N) or boundary-free."""
    if not unbiased:
        return jnp.mean(d, axis=-1)
    mask, counts = _interior_masks(wavelet, d.shape[-2], d.shape[-1])
    return jnp.sum(d * jnp.asarray(mask), axis=-1) / jnp.asarray(counts)


def modwt_cov(x, y, wavelet: str = "db4", level: int | None = None,
              unbiased: bool = False):
    """Wavelet covariance by scale (Percival & Walden ch. 9):
    (..., N) x2 -> (..., J) — the level-j entry is
    ``mean_t(Wx_j Wy_j)``, the portion of ``cov(x, y)`` living in octave
    ``[1/2^{j+1}, 1/2^j]`` cycles/sample (biased MODWT estimator; the
    levels plus the smooths' covariance partition the sample covariance
    exactly, by the tight-frame identity).  ``unbiased=True`` excludes
    the circular-wrap boundary coefficients (see ``modwt_var``)."""
    wx = modwt(x, wavelet, level)
    wy = modwt(y, wavelet, level)
    return _level_mean(wx[..., :-1, :] * wy[..., :-1, :], wavelet,
                       unbiased)


def modwt_corr(x, y, wavelet: str = "db4", level: int | None = None,
               eps: float = 0.0, unbiased: bool = False):
    """Wavelet correlation by scale: ``modwt_cov`` normalized by the two
    wavelet standard deviations per level — a scale-resolved Pearson
    correlation in [-1, 1].  ``eps`` floors the denominator (0 keeps the
    0/0 -> NaN convention for scales with no energy); ``unbiased=True``
    excludes boundary coefficients from every moment."""
    wx = modwt(x, wavelet, level)
    wy = modwt(y, wavelet, level)
    dx, dy = wx[..., :-1, :], wy[..., :-1, :]
    cov = _level_mean(dx * dy, wavelet, unbiased)
    den = jnp.sqrt(_level_mean(dx * dx, wavelet, unbiased)
                   * _level_mean(dy * dy, wavelet, unbiased))
    if eps:
        den = jnp.maximum(den, eps)
    return cov / den


def modwt_var_ci(x, wavelet: str = "db4", level: int | None = None,
                 p: float = 0.95):
    """Unbiased wavelet variance with chi-square confidence intervals:
    (..., N) -> ``(var, lo, hi)`` each (..., J).

    Percival & Walden's EDOF-1 recipe (eq. 313): the level-j estimator
    behaves as ``var * chi2_eta / eta`` with equivalent degrees of
    freedom ``eta_j = max(M_j / 2^j, 1)`` (M_j boundary-free
    coefficients, 2^j the within-scale decorrelation length), giving

        ``CI = ( eta v / chi2_{(1+p)/2},  eta v / chi2_{(1-p)/2} )``.

    The chi-square quantiles use the scipy-free Wilson–Hilferty cube
    from ``ops.tc_stats`` (fractional DOF rounded to the nearest
    integer, floored at 1).  Levels with no boundary-free coefficients
    are NaN throughout."""
    from .tc_stats import _chi2_ppf
    v = modwt_var(x, wavelet, level, unbiased=True)
    j_total = v.shape[-1]
    _, counts = _interior_masks(wavelet, j_total,
                                jnp.asarray(x).shape[-1])
    lo = np.empty(j_total, np.float32)
    hi = np.empty(j_total, np.float32)
    for j in range(1, j_total + 1):
        eta = max(int(round(counts[j - 1] / 2.0 ** j)), 1)
        lo[j - 1] = eta / _chi2_ppf((1.0 + p) / 2.0, eta)
        hi[j - 1] = eta / _chi2_ppf((1.0 - p) / 2.0, eta)
    return v, v * jnp.asarray(lo), v * jnp.asarray(hi)
