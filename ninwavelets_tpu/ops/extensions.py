"""Beyond-reference extensions: more analytic families and cross-signal ops.

The reference ships five wavelet families (SURVEY C10-C14); this module adds
the other standard CWT families (Paul, DOG, Bump) in the same engine
convention — a frequency-domain ``trans_formula(grid, freq)`` peaking at
``grid == freq``, peak amplitude 2, analytic (zero at negative/zero
frequency) — plus cross-signal products the reference lacks entirely:
cross-power spectra and epoch-wise wavelet coherence.

All spectra are float32-safe (log-space where powers would overflow) and
vmappable over the analysis-frequency axis, like ``ops.spectra``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .cwt import cwt_from_bank


# ----------------------------------------------------------------------------
# Additional analytic families (no reference counterpart)
# ----------------------------------------------------------------------------

def paul_spectrum(freq_grid: jnp.ndarray, freq, m: float = 4.0
                  ) -> jnp.ndarray:
    """Paul wavelet of order m, peak-normalized:
    ``2 * H(w) * w**m * exp(m * (1 - w))`` with ``w = grid / freq``.

    The textbook Paul spectrum is ``w**m e^{-w}`` (peak at w = m); the
    engine convention rescales so the peak sits at the analysis frequency
    with amplitude 2, matching the Morse normalization style
    (``ops.spectra.morse_spectrum``).  Evaluated in log-space for float32.
    """
    w = freq_grid / jnp.asarray(freq, freq_grid.dtype)
    m = float(m)
    safe_w = jnp.where(w > 0, w, 1.0)
    log_mag = m * jnp.log(safe_w) + m * (1.0 - safe_w)
    return jnp.where(w > 0, 2.0 * jnp.exp(log_mag), 0.0)


def dog_spectrum(freq_grid: jnp.ndarray, freq, m: float = 2.0
                 ) -> jnp.ndarray:
    """Analytic DOG (derivative-of-Gaussian) wavelet of order m,
    peak-normalized: ``2 * H(w) * w**m * exp(m/2 * (1 - w**2))``.

    The textbook DOG spectrum is ``w**m e^{-w^2/2}`` (peak at w = sqrt(m));
    rescaled so the peak sits at the analysis frequency with amplitude 2.
    ``m = 2`` is the analytic counterpart of the MexicanHat family.
    """
    w = freq_grid / jnp.asarray(freq, freq_grid.dtype)
    m = float(m)
    safe_w = jnp.where(w > 0, w, 1.0)
    log_mag = m * jnp.log(safe_w) + 0.5 * m * (1.0 - safe_w * safe_w)
    return jnp.where(w > 0, 2.0 * jnp.exp(log_mag), 0.0)


def bump_spectrum(freq_grid: jnp.ndarray, freq, sigma: float = 0.6
                  ) -> jnp.ndarray:
    """Bump wavelet, peak-normalized: ``2 * exp(1 - 1/(1 - u**2))`` on
    ``|u| < 1`` with ``u = (w - 1) / sigma``, ``w = grid / freq``; zero
    elsewhere.  Compactly supported in frequency — excellent frequency
    resolution, poor time resolution.
    """
    w = freq_grid / jnp.asarray(freq, freq_grid.dtype)
    u = (w - 1.0) / float(sigma)
    inside = (jnp.abs(u) < 1.0) & (w > 0)
    safe_u2 = jnp.where(inside, u * u, 0.0)
    val = 2.0 * jnp.exp(1.0 - 1.0 / (1.0 - safe_u2))
    return jnp.where(inside, val, 0.0)


# ----------------------------------------------------------------------------
# Cross-signal ops (no reference counterpart)
# ----------------------------------------------------------------------------

def cross_power_from_bank(sig_a: jnp.ndarray, sig_b: jnp.ndarray,
                          bank: jnp.ndarray, interpolate: bool = False):
    """Cross-wavelet product ``Wa * conj(Wb)`` as a (real, imag) float pair.

    Args:
      sig_a, sig_b: (..., N) signals (same shape).
      bank: (F, N) frequency-domain bank.
    Returns:
      ((..., F, N), (..., F, N)) — real and imaginary parts of the
      cross-spectrum; its magnitude is cross-power, its angle the relative
      phase between the signals at each (frequency, time) point.
    """
    ca = cwt_from_bank(sig_a, bank, interpolate)
    cb = cwt_from_bank(sig_b, bank, interpolate)
    x = ca * jnp.conj(cb)
    return x.real, x.imag


def epoch_coherence_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                              bank: jnp.ndarray, interpolate: bool = False,
                              eps: float = 1e-12,
                              vma_axes=()) -> jnp.ndarray:
    """Epoch-wise magnitude-squared wavelet coherence:

        ``|mean_E Wa conj(Wb)|**2 / (mean_E |Wa|**2 * mean_E |Wb|**2)``

    The ensemble average over epochs plays the role the usual time/scale
    smoothing plays for single trials, so no smoothing kernel is needed —
    the natural formulation for the epochs data this framework targets.
    Streams over the epoch axis with ``lax.scan`` (O(F*N) memory).

    Args:
      sigs_a, sigs_b: (E, ..., N) epoch batches (same shape).
    Returns:
      (..., F, N) float32 in [0, 1] (up to float error).
    """
    xr, xi, pa, pb = coherence_sums(sigs_a, sigs_b, bank, interpolate,
                                    vma_axes)
    return coherence_from_sums(xr, xi, pa, pb, sigs_a.shape[0], eps)


def coherence_sums(sigs_a, sigs_b, bank, interpolate: bool = False,
                   vma_axes=()):
    """Epoch-SUMMED coherence accumulators ``(sum cross_r, sum cross_i,
    sum |Wa|^2, sum |Wb|^2)`` — the shard-local half of
    ``epoch_coherence_from_bank``; a mesh reduction (``pmean`` over the
    epoch shards) followed by ``coherence_from_sums`` completes the global
    statistic (``parallel.sharded.sharded_coherence``)."""
    shape = sigs_a.shape[1:-1] + (bank.shape[0], sigs_a.shape[-1])
    zeros = jnp.zeros(shape, jnp.float32)
    if vma_axes:
        zeros = lax.pcast(zeros, tuple(vma_axes), to="varying")

    def step(acc, sigs):
        sa, sb = sigs
        ca = cwt_from_bank(sa, bank, interpolate)
        cb = cwt_from_bank(sb, bank, interpolate)
        x = ca * jnp.conj(cb)
        xr, xi, pa, pb = acc
        return (xr + x.real, xi + x.imag,
                pa + jnp.square(ca.real) + jnp.square(ca.imag),
                pb + jnp.square(cb.real) + jnp.square(cb.imag)), None

    (xr, xi, pa, pb), _ = lax.scan(step, (zeros,) * 4, (sigs_a, sigs_b))
    return xr, xi, pa, pb


def coherence_from_sums(xr, xi, pa, pb, n_epochs: int,
                        eps: float = 1e-12, vma_axes=()) -> jnp.ndarray:
    """``|mean cross|^2 / (mean power_a * mean power_b)`` from the epoch
    sums.

    ``vma_axes``: mesh axes the den plane is SHARDED over (shard_map
    callers pass ``(FREQ_AXIS,)``) — the relative floor's max must be
    completed globally with ``pmax``, or a freq shard whose rows are
    all dead (a Bump bank's out-of-band block) floors against
    ``eps * 0`` and returns 0/0 NaN where the single-device path
    returns 0."""
    num = (jnp.square(xr) + jnp.square(xi)) / (n_epochs * n_epochs)
    den = (pa / n_epochs) * (pb / n_epochs)
    if eps:
        # Relative floor: rows with no spectral support (den == 0, e.g. a
        # Bump row outside its band) return coherence 0 instead of 0/0 NaN,
        # keeping the documented [0, 1] contract.
        m = jnp.max(den)
        for ax in vma_axes:
            m = lax.pmax(m, ax)
        den = jnp.maximum(den, eps * m)
    return num / den


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _epoch_coherence_jit(sa, sb, bank_r, bank_i, *, interpolate, eps):
    bank = bank_r if bank_i is None else lax.complex(bank_r, bank_i)
    return epoch_coherence_from_bank(sa, sb, bank, interpolate, eps)


def epoch_coherence(sigs_a_r, sigs_b_r, bank_r, bank_i=None,
                    interpolate: bool = False, eps: float = 1e-12):
    """Jitted float-boundary wrapper for ``epoch_coherence_from_bank``
    (real or complex banks, the latter as a float pair)."""
    return _epoch_coherence_jit(sigs_a_r, sigs_b_r, bank_r, bank_i,
                                interpolate=bool(interpolate),
                                eps=float(eps))


def bicoherence_from_banks(sigs: jnp.ndarray, bank1: jnp.ndarray,
                           bank2: jnp.ndarray, bank12: jnp.ndarray,
                           interpolate: bool = False, eps: float = 1e-12,
                           vma_axes=()) -> jnp.ndarray:
    """Magnitude-squared wavelet bicoherence (quadratic phase coupling):

        ``b^2(f1, f2) = |sum W(f1) W(f2) conj(W(f1+f2))|^2 /
                        (sum |W(f1) W(f2)|^2 * sum |W(f1+f2)|^2)``

    (Kim & Powers 1979 normalization; sums run over time and epochs).  A
    cell is ~1 when the oscillation at ``f1 + f2`` keeps the phase
    RELATION ``phi_12 = phi_1 + phi_2`` — the signature of quadratic
    nonlinearity (harmonics, wave-wave interaction) that linear spectra
    and 1:1 coherence cannot see.  In [0, 1] up to float error.

    Args:
      sigs: (E, ..., N) real epochs (use E=1 for one long stationary
        record).
      bank1, bank2: (F1, N) / (F2, N) banks at the two frequency grids.
      bank12: (F1 * F2, N) bank at the SUM frequencies, row-major pairs
        ``(f1[i] + f2[j])`` — all sum rows must stay below Nyquist (the
        adapter validates).
    Returns:
      (..., F1, F2) float32.  The per-epoch (..., F1, F2, N) triple
      product is transient but does materialize — size the grids
      accordingly (typical bicoherence grids are <= 64 x 64).
    """
    f1, f2 = bank1.shape[0], bank2.shape[0]
    shape = sigs.shape[1:-1] + (f1, f2)
    zeros = jnp.zeros(shape, jnp.float32)
    if vma_axes:
        zeros = lax.pcast(zeros, tuple(vma_axes), to="varying")

    def step(acc, s):
        w1 = cwt_from_bank(s, bank1, interpolate)
        w2 = cwt_from_bank(s, bank2, interpolate)
        w12 = cwt_from_bank(s, bank12, interpolate)
        w12 = w12.reshape(s.shape[:-1] + (f1, f2, s.shape[-1]))
        pair = w1[..., :, None, :] * w2[..., None, :, :]
        t = pair * jnp.conj(w12)
        nr, ni, d1, d2 = acc
        p_pair = jnp.square(pair.real) + jnp.square(pair.imag)
        p12 = jnp.square(w12.real) + jnp.square(w12.imag)
        return (nr + jnp.sum(t.real, -1), ni + jnp.sum(t.imag, -1),
                d1 + jnp.sum(p_pair, -1), d2 + jnp.sum(p12, -1)), None

    (nr, ni, d1, d2), _ = lax.scan(step, (zeros,) * 4, sigs)
    num = jnp.square(nr) + jnp.square(ni)
    den = d1 * d2
    if eps:
        den = jnp.maximum(den, eps * jnp.max(den))
    return num / den


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _bicoherence_jit(sigs, b1, b2, b12, *, interpolate, eps):
    return bicoherence_from_banks(sigs, b1, b2, b12, interpolate, eps)


def bicoherence(sigs_r, bank1_r, bank2_r, bank12_r,
                interpolate: bool = False, eps: float = 1e-12):
    """Jitted float-boundary wrapper for ``bicoherence_from_banks`` (real
    analytic banks — the statistic needs the analytic phases)."""
    return _bicoherence_jit(sigs_r, bank1_r, bank2_r, bank12_r,
                            interpolate=bool(interpolate), eps=float(eps))


def _coherence_smooth(planes: jnp.ndarray, f_grid: jnp.ndarray,
                      sfreq: float, cycles: float,
                      scale_width: float) -> jnp.ndarray:
    """Torrence–Webster smoothing of real (..., F, N) planes: per-row
    Gaussian smoothing IN TIME with width proportional to the row's
    period (``cycles / f``), then a boxcar IN SCALE of ``scale_width``
    octaves.

    Both passes stay in the engine's fast lanes: the time pass multiplies
    each row's rfft by a closed-form Gaussian transfer (the kernel
    ``exp(-t^2 / (2 s_f^2))`` has transfer ``exp(-(2 pi nu s_f)^2 / 2)``)
    — no per-row convolutions; the scale pass is one (F, F) normalized
    boxcar matmul over the frequency axis (rows within ``scale_width/2``
    octaves average together).  Time smoothing is circular (FFT) — edge
    wrap lives inside the cone of influence the caller should mask anyway
    (``ops.tc_stats.coi_mask``).
    """
    n = planes.shape[-1]
    nu = jnp.fft.rfftfreq(n, 1.0 / sfreq).astype(jnp.float32)
    s_f = cycles / f_grid                                   # (F,) seconds
    arg = (2.0 * jnp.pi) * nu[None, :] * s_f[:, None]
    transfer = jnp.exp(-0.5 * arg * arg)                    # (F, N//2+1)
    sm = jnp.fft.irfft(jnp.fft.rfft(planes, axis=-1) * transfer, n=n,
                       axis=-1)
    oct_dist = jnp.abs(jnp.log2(f_grid[:, None] / f_grid[None, :]))
    w = (oct_dist <= 0.5 * scale_width).astype(jnp.float32)
    w = w / jnp.sum(w, axis=1, keepdims=True)               # (F, F)
    return jnp.einsum('ij,...jn->...in', w, sm)


def wavelet_coherence_from_bank(sig_a: jnp.ndarray, sig_b: jnp.ndarray,
                                bank: jnp.ndarray, f_grid: jnp.ndarray,
                                sfreq: float, interpolate: bool = False,
                                cycles: float = 1.0,
                                scale_width: float = 0.6,
                                eps: float = 1e-12,
                                return_phase: bool = False):
    """SINGLE-TRIAL magnitude-squared wavelet coherence with time/scale
    smoothing (Torrence & Webster 1999 / Grinsted 2004 style):

        ``|S(W_ab / s)|**2 / (S(|Wa|**2 / s) * S(|Wb|**2 / s))``

    where ``S`` smooths in time (Gaussian, width ~ the local period) and
    scale (boxcar in octaves) and ``1/s`` is the standard scale weight
    (any constant factor cancels; ``1/s ∝ f`` is used).  This is the
    estimator for CONTINUOUS recordings — without smoothing the ratio is
    identically 1; with epoched data prefer ``epoch_coherence_from_bank``
    (the ensemble mean replaces the smoothing).

    Args:
      sig_a, sig_b: (..., N) signals (same shape).
      bank: (F, N) frequency-domain bank; f_grid: the F analysis
        frequencies (Hz).
      cycles: time-smoothing width in periods of each row's frequency.
      scale_width: boxcar width in octaves for the scale pass.
      return_phase: also return the smoothed relative phase
        ``arctan2(S(x_i), S(x_r))`` (radians; positive = a leads b).

    Returns:
      (..., F, N) coherence in [0, 1] (up to float error), optionally a
      second (..., F, N) phase plane.
    """
    ca = cwt_from_bank(sig_a, bank, interpolate)
    cb = cwt_from_bank(sig_b, bank, interpolate)
    x = ca * jnp.conj(cb)
    inv_s = f_grid[:, None]
    planes = jnp.stack([x.real * inv_s, x.imag * inv_s,
                        (jnp.square(ca.real) + jnp.square(ca.imag)) * inv_s,
                        (jnp.square(cb.real) + jnp.square(cb.imag)) * inv_s])
    sm = _coherence_smooth(planes, f_grid, sfreq, cycles, scale_width)
    num = jnp.square(sm[0]) + jnp.square(sm[1])
    den = sm[2] * sm[3]
    if eps:
        den = jnp.maximum(den, eps * jnp.max(den))
    coh = num / den
    if return_phase:
        return coh, jnp.arctan2(sm[1], sm[0])
    return coh


@partial(jax.jit, static_argnames=("sfreq", "interpolate", "cycles",
                                   "scale_width", "eps", "return_phase"))
def _wavelet_coherence_jit(sa, sb, bank_r, bank_i, f_grid, *, sfreq,
                           interpolate, cycles, scale_width, eps,
                           return_phase):
    bank = bank_r if bank_i is None else lax.complex(bank_r, bank_i)
    return wavelet_coherence_from_bank(sa, sb, bank, f_grid, sfreq,
                                       interpolate, cycles, scale_width,
                                       eps, return_phase)


def wavelet_coherence(sig_a_r, sig_b_r, bank_r, freqs, sfreq: float,
                      bank_i=None, interpolate: bool = False,
                      cycles: float = 1.0, scale_width: float = 0.6,
                      eps: float = 1e-12, return_phase: bool = False):
    """Jitted float-boundary wrapper for ``wavelet_coherence_from_bank``."""
    f_grid = jnp.asarray(jnp.asarray(freqs), jnp.float32)
    return _wavelet_coherence_jit(sig_a_r, sig_b_r, bank_r, bank_i, f_grid,
                                  sfreq=float(sfreq),
                                  interpolate=bool(interpolate),
                                  cycles=float(cycles),
                                  scale_width=float(scale_width),
                                  eps=float(eps),
                                  return_phase=bool(return_phase))


# ----------------------------------------------------------------------------
# Imaginary coherency
# ----------------------------------------------------------------------------

def imcoh_from_sums(xr, xi, pa, pb, eps: float = 1e-12,
                    vma_axes=()) -> jnp.ndarray:
    """``Im(mean cross) / sqrt(mean |Wa|^2 mean |Wb|^2)`` from the
    ``coherence_sums`` planes (the epoch count cancels between numerator
    and denominator).  Same relative denominator floor — and the same
    ``vma_axes`` global-max completion — as ``coherence_from_sums``."""
    den = jnp.sqrt(pa * pb)
    if eps:
        m = jnp.max(den)
        for ax in vma_axes:
            m = lax.pmax(m, ax)
        den = jnp.maximum(den, eps * m)
    return xi / den


def imcoh_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                    bank: jnp.ndarray, interpolate: bool = False,
                    eps: float = 1e-12) -> jnp.ndarray:
    """Imaginary part of coherency (Nolte 2004): (E, ..., N) x2 ->
    (..., F, N) in [-1, 1].

        ``ImCoh = Im( mean_E Wa conj(Wb) ) /
                  sqrt( mean_E |Wa|^2 * mean_E |Wb|^2 )``

    The original volume-conduction-robust coupling measure: an
    instantaneous common source contributes a purely REAL cross-spectrum,
    so only genuinely lagged interaction survives the Im.  Unlike the
    phase-lag family (``ops.connectivity.phase_lag``) it keeps the
    coherency NORMALIZATION (amplitude-weighted, signed by lag
    direction), making it the natural companion to ``epoch_coherence`` —
    and it rides the very same four epoch sums."""
    xr, xi, pa, pb = coherence_sums(sigs_a, sigs_b, bank, interpolate)
    return imcoh_from_sums(xr, xi, pa, pb, eps)


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _imcoh_jit(sa, sb, bank_r, bank_i, *, interpolate, eps):
    bank = bank_r if bank_i is None else lax.complex(bank_r, bank_i)
    return imcoh_from_bank(sa, sb, bank, interpolate, eps)


def imcoh(sigs_a_r, sigs_b_r, bank_r, bank_i=None,
          interpolate: bool = False, eps: float = 1e-12):
    """Jitted float-boundary wrapper for ``imcoh_from_bank``."""
    return _imcoh_jit(sigs_a_r, sigs_b_r, bank_r, bank_i,
                      interpolate=bool(interpolate), eps=float(eps))


# ----------------------------------------------------------------------------
# Phase slope index
# ----------------------------------------------------------------------------

def psi_from_sums(xr, xi, pa, pb, band=None, eps: float = 1e-12,
                  normalize: bool = True):
    """Phase slope index from the ``coherence_sums`` planes.

        ``PSI = sum_f Im( conj(C_f) C_{f+1} )``,  C = S_ab / sqrt(S_aa S_bb)

    summed over consecutive BANK ROWS in ``band`` (a (lo, hi) row-index
    slice; default all rows): if channel a consistently LEADS channel b,
    the cross-spectral phase grows with frequency and every term is
    positive — the sign is the direction (+: a -> b), near zero for
    no or zero-lag coupling.  Rows must be frequency-ordered (ascending
    or descending flips only the sign convention).  With ``normalize``
    the sum is scaled by ``sum_f |C_f| |C_{f+1}|`` so the result lands in
    [-1, 1] (a phase-slope coherence); raw PSI otherwise.
    Returns the (..., N) time-resolved index (collapse time yourself).
    """
    den = jnp.sqrt(pa * pb)
    if eps:
        den = jnp.maximum(den, eps * jnp.max(den))
    cr, ci = xr / den, xi / den                      # coherency per row
    lo, hi = (0, cr.shape[-2]) if band is None else band
    cr, ci = cr[..., lo:hi, :], ci[..., lo:hi, :]
    a_r, a_i = cr[..., :-1, :], ci[..., :-1, :]
    b_r, b_i = cr[..., 1:, :], ci[..., 1:, :]
    # Im(conj(a) b) = a_r b_i - a_i b_r
    psi = jnp.sum(a_r * b_i - a_i * b_r, axis=-2)
    if not normalize:
        return psi
    mag = jnp.sum(jnp.sqrt((a_r * a_r + a_i * a_i)
                           * (b_r * b_r + b_i * b_i)), axis=-2)
    if eps:
        mag = jnp.maximum(mag, eps)
    return psi / mag


def psi_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                  bank: jnp.ndarray, band=None, interpolate: bool = False,
                  eps: float = 1e-12,
                  normalize: bool = True) -> jnp.ndarray:
    """Phase slope index (Nolte 2008): (E, ..., N) x2 -> (..., N).

    A DIRECTED coupling measure: the slope of the cross-spectral phase
    across the ``band`` rows of the bank.  Positive where channel a
    leads channel b (information flows a -> b), negative for the
    reverse, ~0 for independent or zero-lag (volume-conduction)
    coupling — the directed companion of ``imcoh``.  The bank rows must
    be built on an ascending frequency grid."""
    xr, xi, pa, pb = coherence_sums(sigs_a, sigs_b, bank, interpolate)
    return psi_from_sums(xr, xi, pa, pb, band, eps, normalize)


@partial(jax.jit, static_argnames=("band", "interpolate", "eps",
                                   "normalize"))
def _psi_jit(sa, sb, bank_r, bank_i, *, band, interpolate, eps, normalize):
    bank = bank_r if bank_i is None else lax.complex(bank_r, bank_i)
    return psi_from_bank(sa, sb, bank, band, interpolate, eps, normalize)


def psi(sigs_a_r, sigs_b_r, bank_r, bank_i=None, band=None,
        interpolate: bool = False, eps: float = 1e-12,
        normalize: bool = True):
    """Jitted float-boundary wrapper for ``psi_from_bank`` (``band`` is a
    static (lo, hi) row-index pair)."""
    b = None if band is None else (int(band[0]), int(band[1]))
    return _psi_jit(sigs_a_r, sigs_b_r, bank_r, bank_i, band=b,
                    interpolate=bool(interpolate), eps=float(eps),
                    normalize=bool(normalize))


def cfd_from_banks(sigs: jnp.ndarray, bank_slow: jnp.ndarray,
                   bank_fast: jnp.ndarray, band=None,
                   interpolate: bool = False, eps: float = 1e-12,
                   normalize: bool = True) -> jnp.ndarray:
    """Cross-frequency directionality (Jiang, Bahramisharif, van Gerven
    & Jensen, PLoS Biol 2015): (E, ..., N) -> (..., N).

    DOES the slow phase drive the fast amplitude, or the reverse?  The
    fast band's amplitude envelope (mean over ``bank_fast`` rows) is
    treated as a signal and the phase slope index is computed between
    the raw signal and that envelope across the ``band`` rows of
    ``bank_slow``: positive = the slow oscillation LEADS the fast
    amplitude (phase -> amplitude coupling direction), negative = the
    amplitude leads, ~0 for zero-lag comodulation.

    Caveat (inherent to any phase-slope measure): the slow rhythm must
    be BROADBAND across the analyzed rows — a pure sinusoidal driver
    puts the same spectral line in every wavelet row, the cross-phase
    is then flat across rows, and the slope (hence CFD) is ~0 no matter
    how strong or lagged the coupling.
    """
    wa = cwt_from_bank(sigs, bank_fast, interpolate)
    env = jnp.mean(jnp.abs(wa), axis=-2)               # (E, ..., N)
    return psi_from_bank(sigs, env, bank_slow, band, interpolate, eps,
                         normalize)


@partial(jax.jit, static_argnames=("band", "interpolate", "eps",
                                   "normalize"))
def _cfd_jit(sigs, bs, bf, *, band, interpolate, eps, normalize):
    return cfd_from_banks(sigs, bs, bf, band, interpolate, eps,
                          normalize)


def cfd(sigs_r, bank_slow_r, bank_fast_r, band=None,
        interpolate: bool = False, eps: float = 1e-12,
        normalize: bool = True):
    """Jitted float-boundary wrapper for ``cfd_from_banks`` (real
    analytic banks; ``band`` is a static (lo, hi) slow-row pair)."""
    b = None if band is None else (int(band[0]), int(band[1]))
    return _cfd_jit(jnp.asarray(sigs_r), jnp.asarray(bank_slow_r),
                    jnp.asarray(bank_fast_r), band=b,
                    interpolate=bool(interpolate), eps=float(eps),
                    normalize=bool(normalize))


# ----------------------------------------------------------------------------
# wavelet entropy (Rosso 2001)
# ----------------------------------------------------------------------------

def wavelet_entropy(power: jnp.ndarray, normalized: bool = True,
                    eps: float = 1e-30) -> jnp.ndarray:
    """Time-resolved wavelet entropy of a (..., F, N) power plane
    (Rosso et al. 2001): the Shannon entropy of the relative wavelet
    energy distribution over frequency at each time point,

        H(t) = -sum_f p_f(t) ln p_f(t),   p_f = P(f, t) / sum_f P(f, t)

    normalized by ``ln F`` into [0, 1] when ``normalized`` (1 = white,
    energy spread over every band; 0 = a single band).  Pure reductions —
    rides any power source (CWT, multitaper, superlet) eagerly or under
    jit.  Extension; no reference counterpart.
    """
    power = jnp.asarray(power, jnp.float32)
    tot = jnp.maximum(jnp.sum(power, axis=-2, keepdims=True), eps)
    p = power / tot
    h = -jnp.sum(jnp.where(p > 0, p * jnp.log(jnp.maximum(p, eps)), 0.0),
                 axis=-2)
    if normalized:
        f = power.shape[-2]
        # one band: h is identically 0; ln(1) = 0 would give 0/0 NaN
        h = h / np.log(f) if f > 1 else jnp.zeros_like(h)
    return h


# ----------------------------------------------------------------------------
# Monte-Carlo significance for the smoothed wavelet coherence
# ----------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("sfreq", "interpolate", "cycles",
                                   "scale_width", "eps", "q",
                                   "n_surrogates"))
def _wtc_null_jit(bank_r, f_grid, noise, alpha_a, alpha_b, *, sfreq,
                  interpolate, cycles, scale_width, eps, q, n_surrogates):
    # AR(1) surrogate pairs, generated on device: x_t = a x_{t-1} + e_t
    def ar1(alpha, eps_sn):
        def step(x, e):
            x = alpha * x + e
            return x, x

        return lax.scan(step, jnp.zeros(eps_sn.shape[0]), eps_sn.T)[1].T

    xa = ar1(alpha_a, noise[0])                        # (S, N)
    xb = ar1(alpha_b, noise[1])

    def per_surrogate(_, pair):
        a, b = pair
        wtc = wavelet_coherence_from_bank(a, b, bank_r, f_grid, sfreq,
                                          interpolate, cycles,
                                          scale_width, eps)
        return None, wtc

    wtcs = lax.scan(per_surrogate, None, (xa, xb))[1]  # (S, F, N)
    # pooled per-frequency quantile over (surrogate, time) — Grinsted's
    # scale-dependent significance level
    return jnp.quantile(jnp.moveaxis(wtcs, 1, 0)
                        .reshape(bank_r.shape[0], -1), q, axis=-1)


def wtc_significance(sig_a_r, sig_b_r, bank_r, freqs, sfreq: float,
                     n_surrogates: int = 100, q: float = 0.95,
                     seed: int = 0, interpolate: bool = False,
                     cycles: float = 1.0, scale_width: float = 0.6,
                     eps: float = 1e-12):
    """(F,) Monte-Carlo significance levels for the smoothed wavelet
    coherence (Grinsted, Moore & Jevrejeva 2004): coherence of
    ``n_surrogates`` independent AR(1) pairs — lag-1 coefficients fitted
    to the two inputs — pooled over (surrogate, time) per frequency row
    at quantile ``q``.  Observed ``wavelet_coherence`` above the level is
    significant against the red-noise null.  Memory holds the
    (S, F, N) surrogate stack; size ``n_surrogates`` accordingly.
    """
    from .tc_stats import ar1_coefficient
    a = np.asarray(sig_a_r, np.float32)
    b = np.asarray(sig_b_r, np.float32)
    n = a.shape[-1]
    alpha_a = ar1_coefficient(a.reshape(-1, n)[0])
    alpha_b = ar1_coefficient(b.reshape(-1, n)[0])
    noise = jax.random.normal(jax.random.PRNGKey(seed),
                              (2, int(n_surrogates), n), jnp.float32)
    return _wtc_null_jit(jnp.asarray(bank_r),
                         jnp.asarray(freqs, jnp.float32),
                         noise, jnp.float32(alpha_a),
                         jnp.float32(alpha_b), sfreq=float(sfreq),
                         interpolate=bool(interpolate),
                         cycles=float(cycles),
                         scale_width=float(scale_width), eps=float(eps),
                         q=float(q), n_surrogates=int(n_surrogates))
