"""Spectral (wavelet-domain) Granger causality via Wilson spectral
factorization (Wilson 1972; Dhamala, Rangarajan & Ding, NeuroImage 2008).

No reference counterpart — this is the nonparametric route to DIRECTED
frequency-resolved coupling: factorize the (cross-)spectral density
matrix S(f) = H(f) Σ H(f)† into a causal transfer function H and a noise
covariance Σ, then read Geweke's Granger causality off the factors.
Applied per time slice of the wavelet cross-spectrogram it yields
time-VARYING directed influence, the capability parametric VAR fits
struggle with on nonstationary EEG.

Design notes:
* the factorization grid must be UNIFORM over [0, Nyquist] (the Wilson
  "plus operator" is an FFT across frequency), so ``wavelet_granger``
  builds its own uniform-grid bank; rows are energy-normalized because a
  per-frequency gain distorts the GC ratio (a global constant cancels);
* Wilson iterations are batched over (time, pair) with a FIXED iteration
  count (static for jit) — each step is one frequency-axis FFT pair plus
  small-matrix algebra;
* no complex linear algebra primitives are used on device: the pairwise
  path is closed-form 2x2 complex algebra, the general path embeds the
  complex solve as a real (2C, 2C) ``jnp.linalg.solve``; the init is
  diagonal (no cholesky) — Wilson converges regardless of init;
* complex arrays never cross the jit boundary: public entry points take
  float signals and return the real GC planes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["wilson_factorize", "spectral_granger_pairwise",
           "conditional_granger", "wavelet_conditional_granger",
           "dtf_pdc", "wavelet_dtf_pdc",
           "granger_from_factors", "wavelet_granger",
           "wavelet_granger_significance", "uniform_freqs"]


def uniform_freqs(n_bins: int, sfreq: float) -> np.ndarray:
    """The one-sided uniform factorization grid: ``n_bins`` frequencies
    ``k * (sfreq/2) / (n_bins - 1)``, k = 0..n_bins-1 (DC..Nyquist)."""
    return np.linspace(0.0, sfreq / 2.0, int(n_bins))


def _two_sided(s: jnp.ndarray) -> jnp.ndarray:
    """Hermitian completion of a one-sided (..., K, C, C) spectral matrix
    onto the full 2(K-1) circle: ``S(-f) = conj(S(f))`` entrywise (real
    processes have real lag covariances)."""
    body = jnp.conj(s[..., -2:0:-1, :, :])
    return jnp.concatenate([s, body], axis=-3)


def _plus_operator(g: jnp.ndarray, half: int) -> jnp.ndarray:
    """Wilson's causal-part operator on a full-circle (..., 2h, C, C)
    function: to lag domain, keep lags 1..h-1, halve lag 0 and keep only
    its upper triangle (incl. diagonal), zero the rest, back to
    frequency."""
    gam = jnp.fft.ifft(g, axis=-3)
    lag0 = jnp.triu(0.5 * gam[..., 0, :, :])
    n2 = g.shape[-3]
    keep = (jnp.arange(n2) < half)[:, None, None]
    gam = jnp.where(keep, gam, 0.0)
    gam = gam.at[..., 0, :, :].set(lag0)
    return jnp.fft.fft(gam, axis=-3)


def _solve_complex(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a^{-1} b`` for complex (..., C, C) via the real (2C, 2C) block
    embedding [[Re, -Im], [Im, Re]] — no complex LU needed."""
    ar, ai = jnp.real(a), jnp.imag(a)
    br, bi = jnp.real(b), jnp.imag(b)
    top = jnp.concatenate([ar, -ai], axis=-1)
    bot = jnp.concatenate([ai, ar], axis=-1)
    big_a = jnp.concatenate([top, bot], axis=-2)
    big_b = jnp.concatenate([br, bi], axis=-2)
    x = jnp.linalg.solve(big_a, big_b)
    c = a.shape[-1]
    return x[..., :c, :] + 1j * x[..., c:, :]


def _dagger(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.conj(jnp.swapaxes(m, -1, -2))


def _wilson_full(s_full: jnp.ndarray, *, n_iter: int = 60):
    """Run Wilson's iteration on the full-circle spectral matrix
    (..., 2h, C, C).  Returns (psi_full, h_one_sided, sigma)."""
    n2 = s_full.shape[-3]
    h = n2 // 2
    c = s_full.shape[-1]
    eye = jnp.eye(c, dtype=s_full.dtype)

    # diagonal init: psi0 = diag(sqrt(mean S_ii)) — Wilson converges from
    # any invertible causal init, and this avoids a device cholesky.
    diag0 = jnp.sqrt(jnp.maximum(
        jnp.real(jnp.diagonal(jnp.mean(s_full, axis=-3),
                              axis1=-2, axis2=-1)), 1e-20))
    psi0 = (diag0[..., None, :, None] * eye) * jnp.ones(
        s_full.shape[:-3] + (n2, 1, 1))
    psi0 = psi0.astype(s_full.dtype)

    def step(psi, _):
        x = _solve_complex(psi, s_full)
        g = _dagger(_solve_complex(psi, _dagger(x))) + eye
        gamma = _plus_operator(g, h)
        return psi @ gamma, None

    psi, _ = lax.scan(step, psi0, None, length=n_iter)
    # zero-lag coefficient = frequency mean; Sigma = A0 A0^dagger,
    # H = psi A0^{-1} (one-sided half returned).
    a0 = jnp.mean(psi, axis=-3)
    sigma = jnp.real(a0 @ _dagger(a0))
    a0inv = _solve_complex(a0.astype(psi.dtype), eye)
    h_fn = psi[..., : h + 1, :, :] @ jnp.expand_dims(a0inv, -3)
    return psi, h_fn, sigma


@partial(jax.jit, static_argnames=("n_iter",))
def _wilson_ri(sr, si, *, n_iter):
    """Float-boundary Wilson wrapper: complex is built, iterated and
    split INSIDE the compiled program (the package's float-pair
    boundary convention)."""
    _, h_fn, sigma = _wilson_full(_two_sided(sr + 1j * si), n_iter=n_iter)
    return jnp.real(h_fn), jnp.imag(h_fn), sigma


def wilson_factorize(s: jnp.ndarray, n_iter: int = 60):
    """Factorize a one-sided (..., K, C, C) Hermitian spectral density
    into ``S(f) = H(f) Sigma H(f)^dagger`` (H causal, H(lag 0) = I).

    Returns ``(H, Sigma)`` with H (..., K, C, C) complex and Sigma
    (..., C, C) real.  K-1 must be the half grid (K uniform bins from DC
    to Nyquist).

    Grid resolution caveat: the discrete factorization is exact for the
    circular process whose covariance is the inverse DFT of the sampled
    spectrum — the true lag covariance must have decayed within 2(K-1)
    lags.  Sharp resonances (poles near the unit circle) need fine
    grids: a |z| ~ 0.9 pole plateaus at ~12%% reconstruction error on
    K = 33 but reaches 6e-6 at K = 129 (see tests/test_granger.py).
    """
    s = np.asarray(s)  # host split: complex64 must not cross jit/host
    if s.shape[-1] != s.shape[-2]:
        raise ValueError("spectral matrix must be square, got %s"
                         % (s.shape,))
    if s.shape[-3] < 3:
        raise ValueError("need at least 3 frequency bins (DC..Nyquist)")
    hr, hi, sigma = _wilson_ri(
        jnp.asarray(np.real(s), jnp.float32),
        jnp.asarray(np.imag(s), jnp.float32), n_iter=n_iter)
    return np.asarray(hr) + 1j * np.asarray(hi), sigma


def granger_from_factors(h_fn: jnp.ndarray, sigma: jnp.ndarray,
                         s: jnp.ndarray) -> jnp.ndarray:
    """Geweke's pairwise spectral GC from 2x2 factors: for the (x, y)
    system, influence y -> x at f is

        ln( S_xx / (S_xx - (Sig_yy - Sig_xy^2 / Sig_xx) |H_xy|^2) ).

    ``h_fn``/``s`` are (..., K, 2, 2), ``sigma`` (..., 2, 2); returns
    (..., K, 2) = [y->x, x->y].
    """
    sxx = jnp.real(s[..., 0, 0])
    syy = jnp.real(s[..., 1, 1])
    sig = sigma[..., None, :, :]
    cond_y = sig[..., 1, 1] - sig[..., 0, 1] ** 2 / sig[..., 0, 0]
    cond_x = sig[..., 0, 0] - sig[..., 0, 1] ** 2 / sig[..., 1, 1]
    hxy2 = jnp.abs(h_fn[..., 0, 1]) ** 2
    hyx2 = jnp.abs(h_fn[..., 1, 0]) ** 2
    eps = 1e-12
    gc_yx = jnp.log(jnp.maximum(sxx, eps)
                    / jnp.maximum(sxx - cond_y * hxy2, eps))
    gc_xy = jnp.log(jnp.maximum(syy, eps)
                    / jnp.maximum(syy - cond_x * hyx2, eps))
    return jnp.stack([gc_yx, gc_xy], axis=-1)


@partial(jax.jit, static_argnames=("n_iter",))
def _pairwise_jit(s_r, s_i, pairs, *, n_iter):
    s = s_r + 1j * s_i
    # gather all (i, j) 2x2 submatrices: (..., P, K, 2, 2)
    i, j = pairs[:, 0], pairs[:, 1]
    ii = jnp.stack([i, i, j, j], -1)
    jj = jnp.stack([i, j, i, j], -1)
    # (..., K, P, 4) -> (..., P, K, 2, 2)
    g = s[..., ii, jj]
    g = jnp.moveaxis(g, -2, -3)
    g = g.reshape(*g.shape[:-1], 2, 2)
    h_fn, sigma = _wilson_full(_two_sided(g), n_iter=n_iter)[1:]
    gc = granger_from_factors(h_fn, sigma, g)
    return gc


def _pair_list(c: int) -> np.ndarray:
    return np.array([(a, b) for a in range(c) for b in range(a + 1, c)],
                    np.int32).reshape(-1, 2)


@partial(jax.jit, static_argnames=("n_iter",))
def _pairwise_assemble(s_r, s_i, pairs, *, n_iter):
    """Float-boundary all-pairs GC: factorize every 2x2 submatrix and
    scatter the two directions into the (..., K, C, C) plane — one
    compiled program, complex only inside."""
    gc = _pairwise_jit(s_r, s_i, pairs, n_iter=n_iter)
    k, c = s_r.shape[-3], s_r.shape[-1]
    out = jnp.zeros((*s_r.shape[:-3], k, c, c), jnp.float32)
    i, j = pairs[:, 0], pairs[:, 1]
    # gc[..., p, :, 0] = j->i goes to out[i, j]; [..., 1] = i->j to [j, i]
    out = out.at[..., i, j].set(jnp.moveaxis(gc[..., 0], -2, -1))
    out = out.at[..., j, i].set(jnp.moveaxis(gc[..., 1], -2, -1))
    return out


def spectral_granger_pairwise(s: jnp.ndarray,
                              n_iter: int = 60) -> jnp.ndarray:
    """All-pairs spectral Granger causality of a one-sided (..., K, C, C)
    spectral matrix: each unordered channel pair's 2x2 submatrix is
    factorized independently (batched), giving the (..., K, C, C) GC
    plane with ``out[..., i, j]`` = influence j -> i (diagonal 0).

    Pairwise (not conditional multivariate) GC — the standard Dhamala
    nonparametric estimator.  Complex input is split on HOST (the
    package's float-pair boundary convention).
    """
    s = np.asarray(s)
    c = s.shape[-1]
    return _pairwise_assemble(
        jnp.asarray(np.real(s), jnp.float32),
        jnp.asarray(np.imag(s), jnp.float32),
        jnp.asarray(_pair_list(c)), n_iter=n_iter)


# ---------------------------------------------------------------------------
# DTF / PDC off the same factors
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_iter",))
def _dtf_pdc_jit(s_r, s_i, *, n_iter):
    s = s_r + 1j * s_i
    _, h_fn, _ = _wilson_full(_two_sided(s), n_iter=n_iter)
    c = s.shape[-1]
    a_fn = _solve_complex(h_fn, jnp.eye(c, dtype=h_fn.dtype))
    h2 = jnp.square(jnp.abs(h_fn))
    a2 = jnp.square(jnp.abs(a_fn))
    dtf = jnp.sqrt(h2 / jnp.maximum(
        jnp.sum(h2, axis=-1, keepdims=True), 1e-20))
    pdc = jnp.sqrt(a2 / jnp.maximum(
        jnp.sum(a2, axis=-2, keepdims=True), 1e-20))
    return dtf, pdc


def dtf_pdc(s, n_iter: int = 60):
    """(DTF, PDC) of a one-sided (..., K, C, C) spectral matrix, both
    (..., K, C, C) with ``[..., i, j]`` = flow j -> i in [0, 1].

    Computed nonparametrically from the Wilson factors: the directed
    transfer function is the row-normalized transfer magnitude
    ``|H_ij| / sqrt(sum_m |H_im|^2)`` (Kaminski-Blinowska — sensitive to
    CASCADES: an x<-z<-y chain lights y->x up), and partial directed
    coherence the column-normalized inverse-transfer magnitude
    ``|A_ij| / sqrt(sum_k |A_kj|^2)`` with ``A = H^{-1}`` (Baccala-
    Sameshima — DIRECT links only; the mediated y->x stays at the
    noise floor).  Complex input splits on host.
    """
    s = np.asarray(s)
    if s.shape[-1] != s.shape[-2]:
        raise ValueError("spectral matrix must be square, got %s"
                         % (s.shape,))
    return _dtf_pdc_jit(jnp.asarray(np.real(s), jnp.float32),
                        jnp.asarray(np.imag(s), jnp.float32),
                        n_iter=n_iter)


def wavelet_dtf_pdc(sigs_r, sfreq: float, n_bins: int = 65,
                    time_decim: int = 16, n_iter: int = 60,
                    interpolate: bool = True):
    """Time-resolved (DTF, PDC) of an (E, C, N) epoch stack — the
    ``wavelet_granger`` cross-spectra pipeline with the normalized
    transfer measures per time slice, each (T', K, C, C)."""
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate)
    sr, si = _wavelet_granger_jit(
        sigs, bank, time_decim=int(time_decim),
        interpolate=bool(interpolate))
    return _dtf_pdc_jit(sr, si, n_iter=n_iter)


# ---------------------------------------------------------------------------
# conditional (multivariate) Granger causality
# ---------------------------------------------------------------------------

def _solve_real(a, b):
    return jnp.linalg.solve(a, b)


@partial(jax.jit, static_argnames=("n_iter",))
def _conditional_jit(s_r, s_i, *, n_iter):
    """(..., K, C, C) conditional GC from the float-pair spectral matrix.

    Derivation (reduces exactly to the bivariate Geweke formula at
    C = 2): factorize the FULL system S = H Sigma H^dagger and, for each
    excluded source j, the REDUCED system without j, S_red = G Sigma_G
    G^dagger.  The reduced innovations are eta = G^{-1} [H eps]_rows,
    i.e. eta(f) = Q(f) eps(f) with Q = G^{-1} H_rows; eta is white with
    flat spectrum Sigma_G, and the part of target i's innovation power
    attributable to source j's (partialized) innovation is
    sigma_{jj|rest} |Q_{i,j}(f)|^2, giving

        F_{j->i|rest}(f) = ln( Sigma_G[i,i]
                               / (Sigma_G[i,i]
                                  - sigma_{jj|rest} |Q_{i,j}(f)|^2) ).
    """
    s = s_r + 1j * s_i
    c = s.shape[-1]
    k = s.shape[-3]
    _, h_full, sigma = _wilson_full(_two_sided(s), n_iter=n_iter)

    # all C reduced systems batched on a new axis (static numpy index
    # arrays, C is small): keep[j] = channel indices with j removed
    keep = np.stack([np.delete(np.arange(c), j) for j in range(c)])

    # (..., K, Cx, C-1, C-1) -> (..., Cx, K, C-1, C-1)
    s_red = jnp.moveaxis(s[..., keep[:, :, None], keep[:, None, :]],
                         -4, -3)
    _, g_red, sigma_g = _wilson_full(_two_sided(s_red), n_iter=n_iter)

    # Q = G^{-1} H_rows : (..., Cx, K, C-1, C)
    h_rows = jnp.moveaxis(
        h_full[..., keep[:, :, None], np.arange(c)[None, None, :]],
        -4, -3)
    q = _solve_complex(g_red, h_rows)

    # sigma_{jj|rest} from the full innovation covariance: (..., Cx)
    sig_rr = sigma[..., keep[:, :, None], keep[:, None, :]]
    col_j = sigma[..., keep, np.arange(c)[:, None]]      # (..., Cx, C-1)
    sig_jj = jnp.diagonal(sigma, axis1=-2, axis2=-1)     # (..., C)
    solved = _solve_real(sig_rr, col_j[..., None])[..., 0]
    sigma_cond = sig_jj - jnp.sum(col_j * solved, -1)

    # |Q[pos(i), j]|^2 per excluded j: take column j along the last axis
    # (index aligns to the Cx axis and broadcasts over any batch dims)
    idx = jnp.broadcast_to(jnp.arange(c)[:, None, None, None],
                           q.shape[:-1] + (1,))
    q_j = jnp.take_along_axis(q, idx, axis=-1)[..., 0]   # (..., Cx, K, C-1)
    diag_g = jnp.diagonal(sigma_g, axis1=-2, axis2=-1)   # (..., Cx, C-1)
    num = diag_g[..., None, :]
    den = num - sigma_cond[..., None, None] * jnp.abs(q_j) ** 2
    eps = 1e-12
    f_red = jnp.log(jnp.maximum(num, eps)
                    / jnp.maximum(den, eps))       # (..., Cx, K, C-1)

    # scatter back: out[..., k, i, j] = f_red[..., j, k, pos(i in keep[j])]
    out = jnp.zeros((*s.shape[:-3], k, c, c), jnp.float32)
    for j in range(c):
        out = out.at[..., :, keep[j], j].set(f_red[..., j, :, :])
    return out


def conditional_granger(s, n_iter: int = 60) -> jnp.ndarray:
    """Conditional multivariate Granger causality of a one-sided
    (..., K, C, C) spectral matrix: ``out[..., i, j]`` is the influence
    j -> i CONDITIONED on all remaining channels (diagonal 0) — indirect
    routes that pairwise GC misreads as direct are suppressed.

    One full factorization plus C reduced ones (all batched).  Complex
    input splits on host (complex64 must not cross the jit boundary).
    """
    s = np.asarray(s)
    if s.shape[-1] != s.shape[-2] or s.shape[-1] < 3:
        raise ValueError(
            "conditional GC needs (..., K, C>=3, C) spectra; use the "
            "pairwise estimator for C = 2, got %s" % (s.shape,))
    return _conditional_jit(jnp.asarray(np.real(s), jnp.float32),
                            jnp.asarray(np.imag(s), jnp.float32),
                            n_iter=n_iter)


def wavelet_conditional_granger(sigs_r, sfreq: float, n_bins: int = 65,
                                time_decim: int = 16, n_iter: int = 60,
                                interpolate: bool = True) -> jnp.ndarray:
    """Time-resolved CONDITIONAL Granger causality of an (E, C, N) epoch
    stack: ``wavelet_granger``'s cross-spectra pipeline with the
    multivariate conditional estimator per time slice."""
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate)
    if sigs.shape[1] < 3:
        raise ValueError("conditional GC needs >= 3 channels")
    sr, si = _wavelet_granger_jit(
        sigs, bank, time_decim=int(time_decim),
        interpolate=bool(interpolate))
    return _conditional_jit(sr, si, n_iter=n_iter)


@partial(jax.jit, static_argnames=("time_decim", "interpolate"))
def _decimated_cwt(sigs, bank_r, *, time_decim, interpolate):
    """(E, C, K, T') decimated CWT coefficients of (E, C, N) signals as
    (real, imag) — the per-trial tableau the surrogate nulls re-pair."""
    from .cwt import cwt_from_bank
    n = sigs.shape[-1]
    t_idx = jnp.arange(0, n, time_decim)

    def step(_, sig):
        w = cwt_from_bank(sig, bank_r, interpolate)[..., t_idx]
        return 0, (jnp.real(w), jnp.imag(w))

    _, (wr, wi) = lax.scan(step, 0, sigs)
    return wr, wi


@partial(jax.jit, static_argnames=())
def _cross_from_tableau(wr, wi, perms):
    """Epoch-mean cross spectra with each channel's trial axis re-paired
    by its own permutation: (..., E, C, K, T') tableau + (C, E) perms ->
    (T', K, C, C) complex as (real, imag).  Identity perms give the
    observed cross spectra."""
    w = wr + 1j * wi
    # gather channel c's trials in permuted order: out[e, c] =
    # w[perms[c, e], c] via one two-array advanced index
    wp = w[perms.T, jnp.arange(w.shape[1])[None, :]]
    cross = jnp.einsum("eakt,ebkt->tkab", wp, jnp.conj(wp))
    return jnp.real(cross) / w.shape[0], jnp.imag(cross) / w.shape[0]


def wavelet_granger_significance(sigs_r, sfreq: float,
                                 n_surrogates: int = 19, seed: int = 0,
                                 n_bins: int = 65, time_decim: int = 16,
                                 n_iter: int = 60,
                                 interpolate: bool = True):
    """``(gc, p)``: time-resolved pairwise GC plus trial-shuffle
    surrogate p-values.

    Each surrogate independently permutes every channel's trial axis
    before the cross spectra — per-channel spectra and trial counts are
    preserved while genuine cross-trial alignment (and hence any true
    directed coupling) is destroyed, the standard nonparametric GC null.
    All surrogates factorize in ONE batched Wilson call.  ``p`` is the
    (1 + count) / (n + 1) exceedance of the observed GC per
    (time, frequency, direction) cell (diagonal 1).
    """
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate)
    e, c, _ = sigs.shape
    wr, wi = _decimated_cwt(sigs, bank, time_decim=int(time_decim),
                            interpolate=bool(interpolate))
    ident = jnp.tile(jnp.arange(e)[None, :], (c, 1))
    sr, si = _cross_from_tableau(wr, wi, ident)
    pairs = jnp.asarray(_pair_list(c))
    gc = _pairwise_assemble(sr, si, pairs, n_iter=n_iter)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, n_surrogates * c).reshape(
        n_surrogates, c, 2)
    perms = jnp.stack([
        jnp.stack([jax.random.permutation(keys[s, ch], e)
                   for ch in range(c)]) for s in range(n_surrogates)])
    surr = [
        _cross_from_tableau(wr, wi, perms[s]) for s in range(n_surrogates)]
    sr_all = jnp.stack([a for a, _ in surr])
    si_all = jnp.stack([b for _, b in surr])
    gc_surr = _pairwise_assemble(sr_all, si_all, pairs, n_iter=n_iter)
    count = jnp.sum(gc_surr >= gc[None], axis=0)
    p = (count + 1.0) / (n_surrogates + 1.0)
    eye = jnp.eye(gc.shape[-1], dtype=bool)
    p = jnp.where(eye, 1.0, p)
    return gc, p


def _granger_inputs(sigs_r, sfreq, n_bins, interpolate,
                    b: float = 17.5, r: float = 3.0):
    """Validated signals + the energy-normalized uniform-grid bank
    (per-frequency gain would distort the GC ratio; DC row synthesized
    as the first analyzed bin — wavelets have no DC atom)."""
    from .bank import make_fft_bank
    from ..models.zoo import Morse

    sigs = jnp.asarray(sigs_r, jnp.float32)
    if sigs.ndim != 3:
        raise ValueError("expected (epochs, channels, N), got %s"
                         % (sigs.shape,))
    freqs = uniform_freqs(n_bins, sfreq)
    freqs[0] = freqs[1]  # no DC wavelet: reuse the first analyzed bin
    morse = Morse(sfreq, b=b, r=r)
    bank = jnp.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(freqs, jnp.float32), sigs.shape[-1],
        sfreq, bool(interpolate)))
    norms = jnp.sqrt(jnp.sum(jnp.abs(bank) ** 2, -1, keepdims=True)
                     / sigs.shape[-1])
    return sigs, bank / jnp.maximum(norms, 1e-20)


@partial(jax.jit, static_argnames=("time_decim", "interpolate"))
def _wavelet_granger_jit(sigs, bank_r, *, time_decim, interpolate):
    from .cwt import cwt_from_bank
    e, c, n = sigs.shape

    # epoch-accumulated cross spectra at the decimated time points:
    # (T', K, C, C) complex, built from one CWT per epoch (scan keeps
    # memory at O(C*K*N)).
    t_idx = jnp.arange(0, n, time_decim)

    def step(acc, sig):
        w = cwt_from_bank(sig, bank_r, interpolate)      # (C, K, N)
        wt = w[..., t_idx]                               # (C, K, T')
        cross = jnp.einsum("akt,bkt->tkab", wt, jnp.conj(wt))
        return acc + cross, None

    init = jnp.zeros((t_idx.shape[0], bank_r.shape[0], c, c),
                     jnp.complex64)
    cross, _ = lax.scan(step, init, sigs)
    cross = cross / e
    return jnp.real(cross), jnp.imag(cross)


def wavelet_granger(sigs_r, sfreq: float, n_bins: int = 65,
                    b: float = 17.5, r: float = 3.0,
                    time_decim: int = 16, n_iter: int = 60,
                    interpolate: bool = True):
    """Time-resolved pairwise spectral Granger causality of an (E, C, N)
    multi-channel epoch stack (Dhamala et al. 2008, wavelet variant).

    Builds an ENERGY-normalized Morse bank on the uniform ``n_bins``
    factorization grid (DC row synthesized as the first analyzed bin —
    wavelets have no DC atom), epoch-averages the wavelet cross-spectral
    matrix at every ``time_decim``-th sample, Wilson-factorizes each
    (time, pair) 2x2 spectral matrix, and returns the (T', K, C, C) GC
    array with ``[..., i, j]`` = influence j -> i at each time/frequency
    (T' = ceil(N / time_decim), K = n_bins).

    ``n_bins - 1`` should be a power of two (the factorization FFTs run
    over 2(K-1) points).
    """
    sigs, bank = _granger_inputs(sigs_r, sfreq, n_bins, interpolate, b, r)
    sr, si = _wavelet_granger_jit(
        sigs, bank, time_decim=int(time_decim),
        interpolate=bool(interpolate))
    c = sigs.shape[1]
    return _pairwise_assemble(sr, si, jnp.asarray(_pair_list(c)),
                              n_iter=n_iter)
