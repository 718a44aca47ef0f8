"""Cross-channel connectivity metrics: phase locking and phase-amplitude
coupling.

No reference counterpart — the reference stops at single-signal TFRs plus
the epochs ITC (``mneutils.py:57-71``); these are the standard next
statistics an EEG pipeline computes from exactly the coefficients this
engine already produces.  Everything is built on ``cwt_from_bank`` and
formulated as dense device work:

* PLV is the cross-channel analog of ITC — a unit-phase epoch mean,
  streamed through ``lax.scan`` at O(F*N) memory; the sharded variant
  (``parallel.sharded_plv``) reduces shard-local sums with one ``psum``.
* PAC collapses the time axis with MATMULS: the mean-vector-length
  comodulogram is ``unit_phase @ amplitude.T`` and the Tort binned-
  amplitude histogram is ``one_hot(phase_bin) @ amplitude.T`` — both matmul
  contractions over N, not scatter loops.
* The all-pairs matrices (``plv_matrix``, ``coherence_matrix``) contract
  the EPOCH axis with matmuls: the (C, C) pairwise epoch sums at every
  (frequency, time) cell are one batched ``(C, 2E) @ (2E, C)`` product,
  streamed one bank row at a time (one signal FFT up front, one iFFT per
  row) so memory stays O(E*C*N + C*C*N).
"""
from __future__ import annotations

from functools import lru_cache as _lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .cwt import analytic_spectrum, cwt_from_bank

__all__ = ["lagged_coherence", "lagged_coherence_morse",
           "plv_from_bank", "plv", "plv_sums", "pac_from_banks", "pac",
           "pair_matrix_scan", "plv_matrix_from_bank", "plv_matrix",
           "pac_mean_from_banks",
           "coherence_matrix_from_bank", "coherence_matrix",
           "nm_plv_from_bank", "nm_plv", "nm_plv_sums",
           "surrogate_pvalues", "plv_significance", "pac_significance",
           "pac_pair_from_banks", "pac_pair", "erpac",
           "erpac_from_banks",
           "phase_lag_sums", "phase_lag_from_sums", "phase_lag_from_bank",
           "phase_lag", "PHASE_LAG_METHODS",
           "phase_lag_significance",
           "ppc_from_bank", "ppc",
           "wpli_matrix_from_bank", "wpli_matrix",
           "ppc_matrix_from_bank", "ppc_matrix",
           "psi_matrix_from_bank", "psi_matrix",
           "partial_coherence", "partial_coherence_from_bank",
           "partial_coherence_per_row",
           "kuramoto_order", "kuramoto_order_from_bank"]


# ----------------------------------------------------------------------------
# Phase-locking value
# ----------------------------------------------------------------------------

def plv_sums(sigs_a, sigs_b, bank, interpolate: bool = False,
             eps: float = 0.0, vma_axes=()):
    """Epoch-SUMMED unit cross-phase planes ``(sum_r, sum_i)`` — the
    shard-local half of ``plv_from_bank`` (mirrors ``coherence_sums``).

    The unit cross-phase of epoch e is ``X / |X|`` with
    ``X = Wa * conj(Wb)``; zero-magnitude cells follow the ITC convention
    (0/0 -> NaN) unless ``eps`` floors the magnitude.
    """
    shape = sigs_a.shape[1:-1] + (bank.shape[0], sigs_a.shape[-1])
    zeros = jnp.zeros(shape, jnp.float32)
    if vma_axes:
        zeros = lax.pcast(zeros, tuple(vma_axes), to="varying")

    def step(acc, sigs):
        sa, sb = sigs
        x = (cwt_from_bank(sa, bank, interpolate)
             * jnp.conj(cwt_from_bank(sb, bank, interpolate)))
        mag = jnp.abs(x)
        if eps:
            mag = jnp.maximum(mag, eps)
        return (acc[0] + x.real / mag, acc[1] + x.imag / mag), None

    (sr, si), _ = lax.scan(step, (zeros, zeros), (sigs_a, sigs_b))
    return sr, si


def plv_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                  bank: jnp.ndarray, interpolate: bool = False,
                  eps: float = 0.0) -> jnp.ndarray:
    """Phase-locking value between two channels over epochs:

        ``PLV = | mean_E exp(i (phi_a - phi_b)) |``

    the cross-channel analog of the reference's inter-trial coherence
    (same unit-phase mean, phase DIFFERENCE instead of phase): 1 where the
    two channels keep a fixed phase relation across trials at that
    (frequency, time) cell, ~1/sqrt(E) under independence.

    Args:
      sigs_a, sigs_b: (E, ..., N) epoch batches (same shape).
      bank: (F, N) frequency-domain bank.
      eps: optional magnitude floor; 0 keeps the ITC convention that
        zero-power cells go NaN rather than inventing a phase.

    Returns:
      (..., F, N) float32 in [0, 1].
    """
    sr, si = plv_sums(sigs_a, sigs_b, bank, interpolate, eps)
    return jnp.sqrt(sr * sr + si * si) / sigs_a.shape[0]


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _plv_jit(sa, sb, bank_r, *, interpolate, eps):
    return plv_from_bank(sa, sb, bank_r, interpolate, eps)


def plv(sigs_a_r, sigs_b_r, bank_r, interpolate: bool = False,
        eps: float = 0.0):
    """Jitted float-boundary wrapper for ``plv_from_bank`` (real analytic
    banks)."""
    return _plv_jit(sigs_a_r, sigs_b_r, bank_r,
                    interpolate=bool(interpolate), eps=float(eps))


# ----------------------------------------------------------------------------
# Phase-lag family: PLI / wPLI / debiased wPLI^2, and PPC
# ----------------------------------------------------------------------------
#
# All built on the IMAGINARY part of the per-epoch cross-spectrum
# ``Im S_e = Im(Wa conj(Wb))``: volume conduction / field spread produces
# zero-lag (real) coupling, so statistics that only see Im S are immune to
# the common-source artifact PLV and coherence inherit.  Every member is a
# plain epoch reduction of elementwise images of Im S — the same single-pass
# shape as ITC/PLV/coherence, so the sums stream through a scan here, ride
# one psum across epoch shards (parallel.sharded_phase_lag).

PHASE_LAG_METHODS = ("pli", "wpli", "dwpli")


def phase_lag_sums(sigs_a, sigs_b, bank, interpolate: bool = False,
                   vma_axes=()):
    """Epoch-SUMMED phase-lag accumulators
    ``(sum Im, sum |Im|, sum sign(Im), sum Im^2)`` of the per-epoch cross
    spectrum ``Im(Wa conj(Wb))`` — the shard-local half of
    ``phase_lag_from_bank`` (mirrors ``coherence_sums``).  Every
    ``PHASE_LAG_METHODS`` statistic is a closed form of these four planes
    (``phase_lag_from_sums``), so one pass serves all of them."""
    shape = sigs_a.shape[1:-1] + (bank.shape[0], sigs_a.shape[-1])
    zeros = jnp.zeros(shape, jnp.float32)
    if vma_axes:
        zeros = lax.pcast(zeros, tuple(vma_axes), to="varying")

    def step(acc, sigs):
        sa, sb = sigs
        wa = cwt_from_bank(sa, bank, interpolate)
        wb = cwt_from_bank(sb, bank, interpolate)
        # Im(Wa conj Wb).  XLA fuses a*d - b*c into an FMA (first product
        # unrounded, second rounded), so a self-pair's Im comes out as
        # rounding noise instead of 0 — and the sign/ratio statistics
        # AMPLIFY that noise into a random value.  Whenever the two
        # ROUNDED products agree the true Im is below fp32 resolution:
        # pin those cells to exact 0 so degenerate pairs hit the
        # documented 0/0 -> NaN path.  (optimization_barrier does not
        # stop the FMA on the CPU backend; this select does, portably.)
        p = wa.imag * wb.real
        q = wa.real * wb.imag
        im = jnp.where(p == q, jnp.float32(0), p - q)
        s_im, s_abs, s_sgn, s_sq = acc
        return (s_im + im, s_abs + jnp.abs(im), s_sgn + jnp.sign(im),
                s_sq + im * im), None

    return lax.scan(step, (zeros,) * 4, (sigs_a, sigs_b))[0]


def phase_lag_from_sums(sums, n_epochs: int, method: str = "wpli",
                        eps: float = 0.0):
    """Finish a phase-lag statistic from the ``phase_lag_sums`` planes.

    * ``"pli"`` — phase-lag index (Stam 2007): ``|mean_E sign(Im S)|``,
      in [0, 1]; 1 when the lag never changes sign across epochs.
    * ``"wpli"`` — weighted PLI (Vinck 2011): ``|sum Im| / sum |Im|``,
      in [0, 1]; down-weights near-zero-lag epochs so noise around the
      real axis cannot flip the sign count.
    * ``"dwpli"`` — DEBIASED wPLI-square (Vinck 2011 eq. 31):
      ``((sum Im)^2 - sum Im^2) / ((sum |Im|)^2 - sum Im^2)`` — removes
      the positive sample bias of wpli^2 by dropping the diagonal
      (j == k) terms; an unbiased estimator of squared wPLI that can go
      slightly NEGATIVE under the null (values near 0 mean no coupling).
      Needs at least 2 epochs.

    ``eps = 0`` keeps the ITC 0/0 convention: cells whose cross-spectrum
    is purely real in every epoch (e.g. a channel against itself) return
    NaN for wpli/dwpli rather than inventing a lag; a positive ``eps``
    floors the denominator so such cells read 0 instead.
    """
    s_im, s_abs, s_sgn, s_sq = sums
    if method == "pli":
        return jnp.abs(s_sgn) / n_epochs
    if method == "wpli":
        den = jnp.maximum(s_abs, eps) if eps else s_abs
        return jnp.abs(s_im) / den
    if method == "dwpli":
        den = s_abs * s_abs - s_sq
        if eps:
            den = jnp.maximum(den, eps)
        return (s_im * s_im - s_sq) / den
    raise ValueError(f"method must be one of {PHASE_LAG_METHODS}, "
                     f"got {method!r}")


def phase_lag_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                        bank: jnp.ndarray, method: str = "wpli",
                        interpolate: bool = False,
                        eps: float = 0.0) -> jnp.ndarray:
    """Phase-lag connectivity between two channels over epochs:
    (E, ..., N) x2 -> (..., F, N).  See ``phase_lag_from_sums`` for the
    estimators; all three are invariant to any common scaling of the
    coefficients (only the SIGN and relative weight of Im S matter)."""
    sums = phase_lag_sums(sigs_a, sigs_b, bank, interpolate)
    return phase_lag_from_sums(sums, sigs_a.shape[0], method, eps)


@partial(jax.jit, static_argnames=("method", "interpolate", "eps"))
def _phase_lag_jit(sa, sb, bank_r, *, method, interpolate, eps):
    return phase_lag_from_bank(sa, sb, bank_r, method, interpolate, eps)


def phase_lag(sigs_a_r, sigs_b_r, bank_r, method: str = "wpli",
              interpolate: bool = False, eps: float = 0.0):
    """Jitted float-boundary wrapper for ``phase_lag_from_bank`` (real
    analytic banks)."""
    return _phase_lag_jit(sigs_a_r, sigs_b_r, bank_r, method=str(method),
                          interpolate=bool(interpolate), eps=float(eps))


@partial(jax.jit, static_argnames=("method", "interpolate", "eps",
                                   "n_surrogates", "min_shift", "seed"))
def _phase_lag_sig_jit(sa, sb, bank_r, *, method, interpolate, eps,
                       n_surrogates, min_shift, seed):
    obs = phase_lag_from_bank(sa, sb, bank_r, method, interpolate, eps)
    pv = surrogate_pvalues(
        lambda shifted: phase_lag_from_bank(sa, shifted, bank_r, method,
                                            interpolate, eps),
        obs, sb, jax.random.PRNGKey(seed), n_surrogates, min_shift)
    return obs, pv


def phase_lag_significance(sigs_a_r, sigs_b_r, bank_r,
                           method: str = "wpli",
                           interpolate: bool = False, eps: float = 0.0,
                           n_surrogates: int = 199,
                           min_shift: int | None = None, seed: int = 0):
    """Phase-lag statistic plus circular-shift surrogate p-values
    (``((..., F, N) stat, same-shape p)``) in one jitted program — the
    ``plv_significance`` convention applied to the phase-lag family
    (surrogates roll channel b per epoch, destroying the cross-channel
    lag while preserving each signal exactly).  Cost is
    ``n_surrogates + 1`` passes."""
    if method not in PHASE_LAG_METHODS:
        raise ValueError(f"method must be one of {PHASE_LAG_METHODS}, "
                         f"got {method!r}")
    return _phase_lag_sig_jit(sigs_a_r, sigs_b_r, bank_r,
                              method=str(method),
                              interpolate=bool(interpolate),
                              eps=float(eps),
                              n_surrogates=int(n_surrogates),
                              min_shift=min_shift, seed=int(seed))


def ppc_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                  bank: jnp.ndarray, interpolate: bool = False,
                  eps: float = 0.0) -> jnp.ndarray:
    """Pairwise phase consistency (Vinck 2010): (E, ..., N) x2 ->
    (..., F, N).

        ``PPC = (|sum_E u|^2 - E) / (E (E - 1))``

    with ``u = exp(i (phi_a - phi_b))`` — the mean cosine of the phase
    difference over all DISTINCT epoch pairs.  An unbiased, sample-size-
    free estimator of squared phase locking: PLV^2 carries a +1/E bias
    that makes runs with different epoch counts incomparable; PPC removes
    exactly that diagonal term (E[PPC] = 0 under the null, slightly
    negative values are normal).  Free off the same sums as PLV — needs
    at least 2 epochs."""
    sr, si = plv_sums(sigs_a, sigs_b, bank, interpolate, eps)
    e = sigs_a.shape[0]
    return (sr * sr + si * si - e) / (e * (e - 1.0))


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _ppc_jit(sa, sb, bank_r, *, interpolate, eps):
    return ppc_from_bank(sa, sb, bank_r, interpolate, eps)


def ppc(sigs_a_r, sigs_b_r, bank_r, interpolate: bool = False,
        eps: float = 0.0):
    """Jitted float-boundary wrapper for ``ppc_from_bank`` (real analytic
    banks)."""
    return _ppc_jit(sigs_a_r, sigs_b_r, bank_r,
                    interpolate=bool(interpolate), eps=float(eps))


# ----------------------------------------------------------------------------
# n:m cross-frequency phase locking
# ----------------------------------------------------------------------------

def nm_plv_from_bank(sigs_a: jnp.ndarray, sigs_b: jnp.ndarray,
                     bank_a: jnp.ndarray, bank_b: jnp.ndarray,
                     n: int = 1, m: int = 1, interpolate: bool = False,
                     eps: float = 0.0, vma_axes=()) -> jnp.ndarray:
    """n:m cross-frequency phase-locking value (Tass 1998):

        ``PLV_nm = | mean_E exp(i (n phi_a - m phi_b)) |``

    phase-phase coupling between oscillations at DIFFERENT frequencies —
    the rhythms lock when ``n f_a = m f_b`` (e.g. theta-gamma 1:6, or an
    oscillation against its own harmonic with ``sigs_a is sigs_b``).
    ``exp(i n phi)`` is the n-th power of the unit coefficient, so each
    epoch costs two CWTs plus elementwise complex powers; epochs stream
    through a scan like ``plv_sums``.

    Row pairing is positional: row k of ``bank_a`` couples to row k of
    ``bank_b``; build ``bank_b`` at ``(n / m) *`` the ``bank_a``
    frequencies so each pair satisfies the resonance (the
    ``EpochsWavelet.nm_plv`` convenience does exactly that).  At
    ``n = m = 1`` this reduces to ``plv_from_bank`` with per-row banks.

    Args:
      sigs_a, sigs_b: (E, ..., N) epoch batches (same shape).
      bank_a, bank_b: (F, N) frequency-domain banks, row-paired.
      n, m: positive integer lock ratio.
    Returns:
      (..., F, N) float32 in [0, 1].
    """
    sr, si = nm_plv_sums(sigs_a, sigs_b, bank_a, bank_b, n, m, interpolate,
                         eps, vma_axes)
    return jnp.sqrt(sr * sr + si * si) / sigs_a.shape[0]


def nm_plv_sums(sigs_a, sigs_b, bank_a, bank_b, n: int = 1, m: int = 1,
                interpolate: bool = False, eps: float = 0.0, vma_axes=()):
    """Epoch-SUMMED ``exp(i(n phi_a - m phi_b))`` planes ``(sum_r,
    sum_i)`` — the shard-local half of ``nm_plv_from_bank`` (mirrors
    ``plv_sums``; ``parallel.sharded_nm_plv`` psums these across epoch
    shards before the magnitude)."""
    if n < 1 or m < 1:
        raise ValueError("n and m must be positive integers")
    shape = sigs_a.shape[1:-1] + (bank_a.shape[0], sigs_a.shape[-1])
    zeros = jnp.zeros(shape, jnp.float32)
    if vma_axes:
        zeros = lax.pcast(zeros, tuple(vma_axes), to="varying")

    def unit_pow(w, k):
        mag = jnp.abs(w)
        if eps:
            mag = jnp.maximum(mag, eps)
        u = w / mag
        out = u
        for _ in range(int(k) - 1):      # tiny static k: unrolled multiply
            out = out * u
        return out

    def step(acc, sigs):
        sa, sb = sigs
        ua = unit_pow(cwt_from_bank(sa, bank_a, interpolate), n)
        ub = unit_pow(cwt_from_bank(sb, bank_b, interpolate), m)
        z = ua * jnp.conj(ub)
        return (acc[0] + z.real, acc[1] + z.imag), None

    (sr, si), _ = lax.scan(step, (zeros, zeros), (sigs_a, sigs_b))
    return sr, si


@partial(jax.jit, static_argnames=("n", "m", "interpolate", "eps"))
def _nm_plv_jit(sa, sb, bank_a, bank_b, *, n, m, interpolate, eps):
    return nm_plv_from_bank(sa, sb, bank_a, bank_b, n, m, interpolate, eps)


def nm_plv(sigs_a_r, sigs_b_r, bank_a_r, bank_b_r, n: int = 1, m: int = 1,
           interpolate: bool = False, eps: float = 0.0):
    """Jitted float-boundary wrapper for ``nm_plv_from_bank`` (real
    analytic banks — phase needs the analytic signal)."""
    return _nm_plv_jit(sigs_a_r, sigs_b_r, bank_a_r, bank_b_r,
                       n=int(n), m=int(m), interpolate=bool(interpolate),
                       eps=float(eps))


# ----------------------------------------------------------------------------
# Surrogate significance
# ----------------------------------------------------------------------------

def surrogate_pvalues(stat_fn, observed: jnp.ndarray, sigs_b: jnp.ndarray,
                      key, n_surrogates: int = 199,
                      min_shift: int | None = None) -> jnp.ndarray:
    """Right-tail p-values of ``observed`` under circular-shift surrogates.

    The null: channel b has no consistent temporal relation to channel a.
    Each surrogate rolls every epoch of ``sigs_b`` by an independent
    random offset (preserving its spectrum and waveform exactly while
    destroying cross-channel alignment), recomputes the statistic via
    ``stat_fn(shifted_b)``, and counts exceedances:

        ``p = (1 + #{surrogate >= observed}) / (n_surrogates + 1)``

    (the standard add-one permutation estimate; the smallest achievable p
    is ``1 / (n_surrogates + 1)`` — use 199/999 for 0.005/0.001 floors).
    Memory is O(plane): surrogates stream through a ``lax.scan`` counter;
    compute is ``n_surrogates`` times the statistic.

    Args:
      stat_fn: ``shifted_sigs_b -> plane`` closure (same shape as
        ``observed``); called under jit.
      observed: the statistic on the real pairing.
      sigs_b: (E, ..., N) epoch batch to shift.
      key: ``jax.random`` PRNG key.
      min_shift: minimum |offset| in samples (default N // 8) so
        surrogates cannot land near zero lag.
    """
    nt = sigs_b.shape[-1]
    lo = nt // 8 if min_shift is None else int(min_shift)
    if not 0 < lo < nt - lo:
        raise ValueError(f"min_shift {lo} leaves no admissible offsets")

    def step(cnt, k):
        shifts = jax.random.randint(k, (sigs_b.shape[0],), lo, nt - lo)
        shifted = jax.vmap(lambda s, sh: jnp.roll(s, sh, axis=-1))(
            sigs_b, shifts)
        return cnt + (stat_fn(shifted) >= observed).astype(jnp.float32), None

    keys = jax.random.split(key, int(n_surrogates))
    cnt = lax.scan(step, jnp.zeros_like(observed), keys)[0]
    return (cnt + 1.0) / (float(n_surrogates) + 1.0)


@partial(jax.jit, static_argnames=("interpolate", "eps", "n_surrogates",
                                   "min_shift", "seed"))
def _plv_sig_jit(sa, sb, bank_r, *, interpolate, eps, n_surrogates,
                 min_shift, seed):
    obs = plv_from_bank(sa, sb, bank_r, interpolate, eps)
    pv = surrogate_pvalues(
        lambda shifted: plv_from_bank(sa, shifted, bank_r, interpolate,
                                      eps),
        obs, sb, jax.random.PRNGKey(seed), n_surrogates, min_shift)
    return obs, pv


def plv_significance(sigs_a_r, sigs_b_r, bank_r, interpolate: bool = False,
                     eps: float = 0.0, n_surrogates: int = 199,
                     min_shift: int | None = None, seed: int = 0):
    """PLV plus circular-shift surrogate p-values: ``((..., F, N) plv,
    same-shape p)`` in one jitted program.  Cost is ``n_surrogates + 1``
    PLV passes — size the surrogate count to the p-value floor you need
    (``1 / (n_surrogates + 1)``)."""
    return _plv_sig_jit(sigs_a_r, sigs_b_r, bank_r,
                        interpolate=bool(interpolate), eps=float(eps),
                        n_surrogates=int(n_surrogates),
                        min_shift=min_shift, seed=int(seed))


# ----------------------------------------------------------------------------
# Phase-amplitude coupling
# ----------------------------------------------------------------------------

def _phase_amp(sig, bank_phase, bank_amp, interpolate, eps):
    """Unit phase vectors (complex, (..., Fp, N)) of the low band and
    amplitudes ((..., Fa, N)) of the high band."""
    wp = cwt_from_bank(sig, bank_phase, interpolate)
    wa = cwt_from_bank(sig, bank_amp, interpolate)
    u = wp / jnp.maximum(jnp.abs(wp), eps)
    return u, jnp.abs(wa)


def pac_pair_from_banks(sig_phase: jnp.ndarray, sig_amp: jnp.ndarray,
                        bank_phase: jnp.ndarray, bank_amp: jnp.ndarray,
                        interpolate: bool = False, method: str = "mvl",
                        n_bins: int = 18, eps: float = 1e-20):
    """``pac_from_banks`` with the phase and amplitude taken from two
    DIFFERENT signals — the cross-channel comodulogram, and the building
    block of the circular-shift surrogate null (phase from the real
    signal, amplitude from a rolled copy)."""
    wp = cwt_from_bank(sig_phase, bank_phase, interpolate)
    wa = cwt_from_bank(sig_amp, bank_amp, interpolate)
    u = wp / jnp.maximum(jnp.abs(wp), eps)
    return _pac_score(u, jnp.abs(wa), sig_phase.shape[-1], method,
                      n_bins, eps)


def pac_from_banks(signal: jnp.ndarray, bank_phase: jnp.ndarray,
                   bank_amp: jnp.ndarray, interpolate: bool = False,
                   method: str = "mvl", n_bins: int = 18,
                   eps: float = 1e-20):
    """Phase-amplitude coupling comodulogram: (..., N) ->
    (..., F_phase, F_amp).

    For every (low, high) frequency pair: does the amplitude envelope of
    the high band depend on the instantaneous phase of the low band?
    Both estimators collapse the time axis with a single matmul:

    * ``method="mvl"`` — amplitude-normalized mean vector length
      (Canolty 2006 / Ozkurt 2010): ``|sum_t A u| / sqrt(N sum_t A^2)``
      with ``u = exp(i phi_low)``; the sum is ``u @ A.T``.  In [0, 1].
    * ``method="tort"`` — Tort 2010 modulation index: bin the low-band
      phase into ``n_bins``, average the high-band amplitude per bin
      (``one_hot(bin) @ A.T``), and score the bin distribution's KL
      divergence from uniform, normalized by ``log(n_bins)``.  In [0, 1],
      0 for phase-independent amplitude.

    Batch dims are vmapped; epochs should be averaged by the caller (the
    ``pac`` wrapper does a scan-mean over a leading epoch axis).
    """
    u, a = _phase_amp(signal, bank_phase, bank_amp, interpolate, eps)
    return _pac_score(u, a, signal.shape[-1], method, n_bins, eps)


def _pac_score(u, a, n, method, n_bins, eps):
    if method == "mvl":
        # (..., Fp, N) @ (..., N, Fa) -> (..., Fp, Fa)
        mr = u.real @ jnp.swapaxes(a, -1, -2)
        mi = u.imag @ jnp.swapaxes(a, -1, -2)
        denom = jnp.sqrt(n * jnp.sum(a * a, axis=-1))       # (..., Fa)
        return jnp.sqrt(mr * mr + mi * mi) / jnp.maximum(
            denom[..., None, :], eps)
    if method != "tort":
        raise ValueError("method must be 'mvl' or 'tort'")
    # Tort MI: phase bins from the unit vector (atan2 is fine inside jit).
    phase = jnp.arctan2(u.imag, u.real)                     # (..., Fp, N)
    idx = jnp.clip(((phase + jnp.pi) * (n_bins / (2.0 * jnp.pi)))
                   .astype(jnp.int32), 0, n_bins - 1)
    onehot = jax.nn.one_hot(idx, n_bins, dtype=jnp.float32,
                            axis=-2)                        # (..., Fp, B, N)
    counts = jnp.sum(onehot, axis=-1)                       # (..., Fp, B)
    sums = onehot @ jnp.swapaxes(a, -1, -2)[..., None, :, :]
    # sums: (..., Fp, B, Fa); mean amplitude per bin (empty bins -> 0).
    mean_amp = sums / jnp.maximum(counts, 1.0)[..., None]
    p = mean_amp / jnp.maximum(jnp.sum(mean_amp, axis=-2, keepdims=True),
                               eps)                         # over bins
    plogp = jnp.where(p > 0, p * jnp.log(p), 0.0)
    kl = jnp.log(float(n_bins)) + jnp.sum(plogp, axis=-2)   # (..., Fp, Fa)
    return kl / jnp.log(float(n_bins))


def pac_mean_from_banks(sig, bank_phase, bank_amp, interpolate, method,
                        n_bins, vma_axes=()):
    """Epoch-mean comodulogram via a scan (O(Fp*Fa) accumulator); shared
    by the jitted wrapper and the per-shard path (``parallel.sharded`` —
    vma_axes casts the zero init to the shard_map varying-axes type)."""
    zero = jnp.zeros(sig.shape[1:-1] + (bank_phase.shape[0],
                                        bank_amp.shape[0]), jnp.float32)
    if vma_axes:
        zero = lax.pcast(zero, tuple(vma_axes), to="varying")

    def step(acc, s):
        return acc + pac_from_banks(s, bank_phase, bank_amp, interpolate,
                                    method, n_bins), None

    return lax.scan(step, zero, sig)[0] / sig.shape[0]


def pac_pair_mean(sig_p, sig_a, bank_phase, bank_amp, interpolate,
                  method, n_bins):
    """Epoch-mean cross-signal comodulogram via a scan."""
    zero = jnp.zeros(sig_p.shape[1:-1] + (bank_phase.shape[0],
                                          bank_amp.shape[0]), jnp.float32)

    def step(acc, pair):
        sp, sa = pair
        return acc + pac_pair_from_banks(sp, sa, bank_phase, bank_amp,
                                         interpolate, method, n_bins), None

    return lax.scan(step, zero, (sig_p, sig_a))[0] / sig_p.shape[0]


@partial(jax.jit, static_argnames=("interpolate", "method", "n_bins"))
def pac_pair(sig_phase_r, sig_amp_r, bank_phase_r, bank_amp_r, *,
             interpolate: bool = False, method: str = "mvl",
             n_bins: int = 18):
    """Jitted epoch-mean CROSS-SIGNAL comodulogram: phase from the
    first (E, N) batch, amplitude from the second."""
    return pac_pair_mean(sig_phase_r, sig_amp_r, bank_phase_r,
                         bank_amp_r, interpolate, method, n_bins)


@partial(jax.jit, static_argnames=("interpolate", "method", "n_bins",
                                   "n_surrogates", "min_shift", "seed"))
def _pac_sig_jit(sig, bp, ba, *, interpolate, method, n_bins,
                 n_surrogates, min_shift, seed):
    obs = pac_mean_from_banks(sig, bp, ba, interpolate, method, n_bins)
    pv = surrogate_pvalues(
        lambda shifted: pac_pair_mean(sig, shifted, bp, ba, interpolate,
                                      method, n_bins),
        obs, sig, jax.random.PRNGKey(seed), n_surrogates, min_shift)
    return obs, pv


_CYCLE_CACHE: dict = {}


def _min_phase_cycles(bp) -> int:
    """Minimum peak FFT bin (= cycles in the window) over the phase
    bank's rows, cached per bank OBJECT: the check costs a full D2H
    fetch of the bank, and the adapter reuses one device-resident bank
    across calls — fetching it per call would be a per-call transfer.  The id-keyed entry holds a weakref; a dead or reused
    id recomputes."""
    import weakref
    if isinstance(bp, jax.core.Tracer):
        return 10**9        # under a user's jit: skip the host check
    key = id(bp)
    hit = _CYCLE_CACHE.get(key)
    if hit is not None and hit[0]() is bp:
        return hit[1]
    val = int(np.argmax(np.abs(np.asarray(bp)), axis=-1).min())
    try:
        _CYCLE_CACHE[key] = (weakref.ref(bp), val)
    except TypeError:        # non-weakref-able input (plain ndarray ok?)
        pass
    if len(_CYCLE_CACHE) > 256:
        _CYCLE_CACHE.clear()
    return val


def pac_significance(signal_r, bank_phase_r, bank_amp_r,
                     interpolate: bool = False, method: str = "mvl",
                     n_bins: int = 18, n_surrogates: int = 199,
                     min_shift: int | None = None, seed: int = 0):
    """Epoch-mean PAC comodulogram plus circular-shift surrogate
    p-values: ``((Fp, Fa) pac, same-shape p)``.

    The null rolls each epoch's AMPLITUDE-providing copy by a random
    offset while the phase copy stays put — per-band spectra and
    waveforms are preserved, phase-amplitude alignment destroyed (Tort
    2010's recommended surrogate).  ``signal_r`` is (E, N).

    VALIDITY REGIME: the shift null needs enough phase cycles per
    window — with too few, distinct shifts are highly correlated, the
    surrogate distribution under-disperses and the test turns
    anticonservative (measured FPR 0.13 at alpha=0.05 with ~6 cycles,
    exactly 0.05 with ~25 — benchmarks/stats_calibration.py).  A
    phase row's peak FFT bin IS its cycle count in the window; below
    8 cycles a warning is logged — lengthen the window (or epochs'
    crop) rather than trusting the p-values."""
    sig = jnp.asarray(signal_r, jnp.float32)
    if sig.ndim == 1:
        sig = sig[None]
    bp = jnp.asarray(bank_phase_r)
    min_cycles = _min_phase_cycles(bp)
    if min_cycles < 8:
        from ..utils.observability import log
        log.warning(
            "pac_significance: slowest phase band has only %d cycles "
            "in the window — the circular-shift null is "
            "anticonservative below ~8 cycles (measured FPR 0.13 at "
            "6); lengthen the analysis window", min_cycles)
    return _pac_sig_jit(sig, bp, jnp.asarray(bank_amp_r),
                        interpolate=bool(interpolate), method=str(method),
                        n_bins=int(n_bins),
                        n_surrogates=int(n_surrogates),
                        min_shift=min_shift, seed=int(seed))


@partial(jax.jit, static_argnames=("interpolate", "method", "n_bins",
                                   "mean_epochs"))
def _pac_jit(sig, bp, ba, *, interpolate, method, n_bins, mean_epochs):
    if not mean_epochs:
        return pac_from_banks(sig, bp, ba, interpolate, method, n_bins)
    return pac_mean_from_banks(sig, bp, ba, interpolate, method, n_bins)


def pac(signal_r, bank_phase_r, bank_amp_r, interpolate: bool = False,
        method: str = "mvl", n_bins: int = 18,
        mean_epochs: bool = False):
    """Jitted float-boundary wrapper for ``pac_from_banks``.  With
    ``mean_epochs=True`` the leading axis is an epoch axis: the
    comodulogram is computed per epoch and averaged through a scan
    (O(Fp*Fa) accumulator)."""
    return _pac_jit(signal_r, bank_phase_r, bank_amp_r,
                    interpolate=bool(interpolate), method=str(method),
                    n_bins=int(n_bins), mean_epochs=bool(mean_epochs))


def erpac_from_banks(sigs: jnp.ndarray, bank_phase: jnp.ndarray,
                     bank_amp: jnp.ndarray, interpolate: bool = False,
                     eps: float = 1e-20) -> jnp.ndarray:
    """Event-related PAC (Voytek et al. 2013): TIME-RESOLVED
    phase-amplitude coupling across trials, (E, N) -> (Fp, Fa, N).

    At every time point the circular-linear correlation between the
    low-band phase (across trials) and the high-band amplitude (across
    trials):

        rho_cl = sqrt((r_ca^2 + r_sa^2 - 2 r_ca r_sa r_cs)
                      / (1 - r_cs^2))

    with r_ca = corr(cos phi, A), r_sa = corr(sin phi, A), r_cs =
    corr(cos phi, sin phi) — unlike the comodulogram (which collapses
    time) this shows WHEN coupling appears relative to the event.  All
    correlations are trial-axis reductions; the (Fp, Fa) crossing is one
    E-contraction einsum per plane (batched over time).
    """
    u, a = _phase_amp(sigs, bank_phase, bank_amp, interpolate, eps)
    cosp, sinp = jnp.real(u), jnp.imag(u)          # (E, Fp, N)

    def center(x):
        return x - jnp.mean(x, axis=0, keepdims=True)

    cc, ss, aa = center(cosp), center(sinp), center(a)

    def norm(x):
        return jnp.sqrt(jnp.maximum(jnp.sum(x * x, 0), eps))

    nc, ns, na = norm(cc), norm(ss), norm(aa)
    # cross-frequency correlations: contract trials -> (Fp, Fa, N)
    r_ca = jnp.einsum("eft,egt->fgt", cc, aa) / (nc[:, None] * na[None])
    r_sa = jnp.einsum("eft,egt->fgt", ss, aa) / (ns[:, None] * na[None])
    # same-row circular self-correlation (Fp, N), broadcast over Fa
    r_cs = (jnp.sum(cc * ss, 0) / (nc * ns))[:, None, :]
    num = r_ca ** 2 + r_sa ** 2 - 2.0 * r_ca * r_sa * r_cs
    den = jnp.maximum(1.0 - r_cs ** 2, eps)
    return jnp.sqrt(jnp.clip(num / den, 0.0, 1.0))


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def _erpac_jit(sigs, bp, ba, *, interpolate, eps):
    return erpac_from_banks(sigs, bp, ba, interpolate, eps)


def erpac(sigs_r, bank_phase_r, bank_amp_r, interpolate: bool = False,
          eps: float = 1e-20) -> jnp.ndarray:
    """Jitted float-boundary wrapper for ``erpac_from_banks``."""
    sigs_r = jnp.asarray(sigs_r, jnp.float32)
    if sigs_r.ndim != 2:
        raise ValueError("erpac needs an (epochs, N) trial stack (the "
                         "correlation runs ACROSS trials), got %s"
                         % (sigs_r.shape,))
    return _erpac_jit(sigs_r, jnp.asarray(bank_phase_r),
                      jnp.asarray(bank_amp_r),
                      interpolate=bool(interpolate), eps=float(eps))


# ----------------------------------------------------------------------------
# All-pairs connectivity matrices
# ----------------------------------------------------------------------------

def _pair_sums(w: jnp.ndarray, precision=None):
    """Pairwise epoch sums ``S[a, b, n] = sum_e w[e, a, n] conj(w[e, b, n])``
    as a (real, imag) pair of (C, C, n) planes.

    One complex Hermitian contraction folded into TWO real batched matmuls
    of shape (n: C x 2E @ 2E x C): with ``u = [wr; wi]`` stacked on the
    epoch axis, ``S_r = u . u`` and ``S_i = [wi; -wr] . u`` — the epoch
    axis is the matmul contraction, the time axis the batch.

    ``precision=None`` is DEFAULT (TF32 on a GPU, fine for the ratio
    statistics); epilogues that INVERT the sums (partial coherence) must
    pass ``lax.Precision.HIGHEST`` — condition-number amplification
    turns the ~1e-3 TF32 round-off into O(0.1) errors,
    invisible on the CPU test mesh.
    """
    u = jnp.concatenate([w.real, w.imag], axis=0)             # (2E, C, n)
    v = jnp.concatenate([w.imag, -w.real], axis=0)
    sr = jnp.einsum('ean,ebn->abn', u, u, precision=precision)
    si = jnp.einsum('ean,ebn->abn', v, u, precision=precision)
    return sr, si


def pair_matrix_scan(sigs: jnp.ndarray, bank: jnp.ndarray, per_row,
                     interpolate: bool = False, unit: bool = False,
                     eps: float = 0.0, time_range=None, precision=None):
    """Stream an all-pairs statistic over the bank rows.

    For each frequency row: iFFT the (E, C, N) coefficient slab (the
    signal spectrum is computed ONCE up front), optionally unit-normalize
    (PLV), window the time axis, form the pairwise epoch sums with
    ``_pair_sums``, and hand ``(sr, si)`` to ``per_row`` to finish the
    statistic.  Memory is O(E*C*N + C*C*n) — the (E, C, F, N) coefficient
    tensor never exists.

    Args:
      sigs: (E, C, N) epochs-by-channels batch.
      bank: (F, N) frequency-domain bank (real or complex).
      per_row: ``(sr, si) -> (C, C)`` row epilogue (runs traced).
      unit: normalize coefficients to unit magnitude (phase-only).
      eps: magnitude floor for the unit normalization; 0 keeps the ITC
        convention that zero-power cells go NaN.
      time_range: optional (start, stop) SAMPLE window the statistic is
        averaged over (transform first, window after — no edge aliasing).
    Returns:
      (F, C, C) stacked row results.
    """
    spec = analytic_spectrum(sigs, interpolate)               # (E, C, N)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])

    def row(_, bank_row):
        w = jnp.fft.ifft(spec * bank_row)                     # (E, C, N)
        if unit:
            mag = jnp.abs(w)
            if eps:
                mag = jnp.maximum(mag, eps)
            w = w / mag
        return None, per_row(*_pair_sums(w[..., n0:n1], precision))

    return lax.scan(row, None, bank)[1]


def plv_matrix_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                         interpolate: bool = False, eps: float = 0.0,
                         time_range=None) -> jnp.ndarray:
    """All-pairs phase-locking matrix: (E, C, N) -> (F, C, C).

    ``PLV[f, a, b] = mean_t | mean_E exp(i (phi_a - phi_b)) |`` — the
    pairwise form of ``plv_from_bank`` for every channel pair at once,
    time-averaged (over ``time_range`` samples if given) into the (C, C)
    connectivity matrix per frequency that source-connectivity pipelines
    consume.  Symmetric with unit diagonal; ~1/sqrt(E) under independence.
    """
    e = sigs.shape[0]

    def per_row(sr, si):
        return jnp.mean(jnp.sqrt(sr * sr + si * si), axis=-1) / e

    return pair_matrix_scan(sigs, bank, per_row, interpolate, unit=True,
                            eps=eps, time_range=time_range)


def coherence_matrix_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                               interpolate: bool = False,
                               eps: float = 1e-12,
                               time_range=None) -> jnp.ndarray:
    """All-pairs epoch-wise wavelet coherence: (E, C, N) -> (F, C, C).

    ``|mean_E Wa conj(Wb)|^2 / (mean_E |Wa|^2 mean_E |Wb|^2)`` per cell
    (the pairwise form of ``extensions.epoch_coherence_from_bank``),
    time-averaged into the (C, C) matrix per frequency.  The per-channel
    power sums are the DIAGONAL of the pairwise sums — free.
    """
    e = sigs.shape[0]

    def per_row(sr, si):
        num = (sr * sr + si * si) / (e * e)                   # (C, C, n)
        p = jnp.einsum('aan->an', sr) / e                     # (C, n)
        den = p[:, None, :] * p[None, :, :]
        if eps:
            # Relative floor (matches coherence_from_sums): dead rows -> 0.
            den = jnp.maximum(den, eps * jnp.max(den))
        return jnp.mean(num / den, axis=-1)

    return pair_matrix_scan(sigs, bank, per_row, interpolate,
                            time_range=time_range)


def ppc_matrix_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                         interpolate: bool = False, eps: float = 0.0,
                         time_range=None) -> jnp.ndarray:
    """All-pairs pairwise phase consistency: (E, C, N) -> (F, C, C).

    ``PPC[f, a, b] = mean_t (|sum_E u|^2 - E) / (E (E - 1))`` with
    ``u = exp(i (phi_a - phi_b))`` — the bias-free counterpart of
    ``plv_matrix_from_bank`` (see ``ppc_from_bank``); comes off the SAME
    unit-phase pairwise epoch sums, so it costs exactly one extra
    subtract.  Diagonal is 1; needs at least 2 epochs."""
    e = sigs.shape[0]

    def per_row(sr, si):
        return jnp.mean((sr * sr + si * si - e) / (e * (e - 1.0)), axis=-1)

    return pair_matrix_scan(sigs, bank, per_row, interpolate, unit=True,
                            eps=eps, time_range=time_range)


def wpli_matrix_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                          method: str = "wpli",
                          interpolate: bool = False, eps: float = 0.0,
                          time_range=None) -> jnp.ndarray:
    """All-pairs phase-lag connectivity: (E, C, N) -> (F, C, C).

    The pairwise form of ``phase_lag_from_bank`` (any
    ``PHASE_LAG_METHODS`` estimator), statistic finished per
    (channel, channel, time) cell then time-averaged (over ``time_range``
    samples if given).  Unlike ``plv_matrix_from_bank`` the epoch axis
    CANNOT be contracted with a matmul — wpli/dwpli need ``|Im S_e|`` per
    epoch BEFORE the sum — so each bank row scans epochs accumulating the
    four ``phase_lag_sums`` planes as (C, C, n) outer products (elementwise work,
    O(E C^2 n) per row; fine for EEG channel counts).  The diagonal (and
    any zero-lag pair) is 0/0 -> NaN at ``eps = 0`` by the documented
    convention."""
    if method not in PHASE_LAG_METHODS:
        raise ValueError(f"method must be one of {PHASE_LAG_METHODS}, "
                         f"got {method!r}")
    e, c = sigs.shape[0], sigs.shape[1]
    spec = analytic_spectrum(sigs, interpolate)               # (E, C, N)
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    nt = n1 - n0

    def row(_, bank_row):
        w = jnp.fft.ifft(spec * bank_row)[..., n0:n1]         # (E, C, n)
        wr, wi = w.real, w.imag

        def step(acc, ri):
            r, i = ri
            # One outer product minus its own transpose, with cells whose
            # rounded products agree pinned to exact 0 (XLA fuses the
            # subtract into an FMA whose first product is UNROUNDED — see
            # phase_lag_sums): the diagonal becomes a true 0/0 NaN
            # instead of amplified rounding noise.
            p = i[:, None, :] * r[None, :, :]
            pt = jnp.swapaxes(p, 0, 1)
            im = jnp.where(p == pt, jnp.float32(0), p - pt)
            s_im, s_abs, s_sgn, s_sq = acc
            return (s_im + im, s_abs + jnp.abs(im), s_sgn + jnp.sign(im),
                    s_sq + im * im), None

        zeros = jnp.zeros((c, c, nt), jnp.float32)
        sums = lax.scan(step, (zeros,) * 4, (wr, wi))[0]
        return None, jnp.mean(
            phase_lag_from_sums(sums, e, method, eps), axis=-1)

    return lax.scan(row, None, bank)[1]


@partial(jax.jit, static_argnames=("method", "interpolate", "eps",
                                   "time_range"))
def _wpli_matrix_jit(sigs, bank_r, *, method, interpolate, eps, time_range):
    return wpli_matrix_from_bank(sigs, bank_r, method, interpolate, eps,
                                 time_range)


def wpli_matrix(sigs_r, bank_r, method: str = "wpli",
                interpolate: bool = False, eps: float = 0.0,
                time_range=None):
    """Jitted float-boundary wrapper for ``wpli_matrix_from_bank`` (real
    analytic banks only — the lag sign needs the analytic signal)."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _wpli_matrix_jit(sigs_r, bank_r, method=str(method),
                            interpolate=bool(interpolate), eps=float(eps),
                            time_range=tr)


@partial(jax.jit, static_argnames=("interpolate", "eps", "time_range"))
def _ppc_matrix_jit(sigs, bank_r, *, interpolate, eps, time_range):
    return ppc_matrix_from_bank(sigs, bank_r, interpolate, eps, time_range)


def ppc_matrix(sigs_r, bank_r, interpolate: bool = False, eps: float = 0.0,
               time_range=None):
    """Jitted float-boundary wrapper for ``ppc_matrix_from_bank``."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _ppc_matrix_jit(sigs_r, bank_r, interpolate=bool(interpolate),
                           eps=float(eps), time_range=tr)


@partial(jax.jit, static_argnames=("interpolate", "eps", "time_range"))
def _plv_matrix_jit(sigs, bank_r, *, interpolate, eps, time_range):
    return plv_matrix_from_bank(sigs, bank_r, interpolate, eps, time_range)


def plv_matrix(sigs_r, bank_r, interpolate: bool = False, eps: float = 0.0,
               time_range=None):
    """Jitted float-boundary wrapper for ``plv_matrix_from_bank`` (real
    analytic banks only — phase needs the analytic signal)."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _plv_matrix_jit(sigs_r, bank_r, interpolate=bool(interpolate),
                           eps=float(eps), time_range=tr)


@partial(jax.jit, static_argnames=("interpolate", "eps", "time_range"))
def _coh_matrix_jit(sigs, bank_r, bank_i, *, interpolate, eps, time_range):
    bank = bank_r if bank_i is None else lax.complex(bank_r, bank_i)
    return coherence_matrix_from_bank(sigs, bank, interpolate, eps,
                                      time_range)


def coherence_matrix(sigs_r, bank_r, bank_i=None, interpolate: bool = False,
                     eps: float = 1e-12, time_range=None):
    """Jitted float-boundary wrapper for ``coherence_matrix_from_bank``
    (real or complex banks, the latter as a float pair)."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _coh_matrix_jit(sigs_r, bank_r, bank_i,
                           interpolate=bool(interpolate), eps=float(eps),
                           time_range=tr)


# ----------------------------------------------------------------------------
# Kuramoto order parameter (global synchrony)
# ----------------------------------------------------------------------------

def kuramoto_order_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                             interpolate: bool = False,
                             eps: float = 1e-12,
                             mean_epochs: bool = True) -> jnp.ndarray:
    """Global phase synchrony across channels: (E, C, N) -> (F, N)
    (or (E, F, N) with ``mean_epochs=False``).

    The Kuramoto order parameter ``R(f, t) = |mean_c exp(i phi_c)|`` —
    1 when every channel shares the instantaneous phase, ~1/sqrt(C)
    under independence.  The whole-head complement of the pairwise PLV
    family (one number per (f, t) instead of a (C, C) matrix); bank
    rows stream through ``lax.scan`` at O(E*C*N) memory."""
    spec = analytic_spectrum(sigs, interpolate)               # (E, C, N)

    def row(_, bank_row):
        w = jnp.fft.ifft(spec * bank_row)
        mag = jnp.maximum(jnp.abs(w), eps)
        u = w / mag
        r = jnp.abs(jnp.mean(u, axis=-2))                     # (E, N)
        return None, jnp.mean(r, axis=0) if mean_epochs else r

    out = lax.scan(row, None, bank)[1]                        # (F, ...)
    return out if mean_epochs else jnp.moveaxis(out, 0, 1)


@partial(jax.jit, static_argnames=("interpolate", "eps", "mean_epochs"))
def _kuramoto_jit(sigs, bank_r, *, interpolate, eps, mean_epochs):
    return kuramoto_order_from_bank(sigs, bank_r, interpolate, eps,
                                    mean_epochs)


def kuramoto_order(sigs_r, bank_r, interpolate: bool = False,
                   eps: float = 1e-12, mean_epochs: bool = True):
    """Jitted float-boundary wrapper for ``kuramoto_order_from_bank``
    (real analytic banks only)."""
    return _kuramoto_jit(sigs_r, bank_r, interpolate=bool(interpolate),
                         eps=float(eps), mean_epochs=bool(mean_epochs))


# ----------------------------------------------------------------------------
# Partial coherence (conditional on all other channels)
# ----------------------------------------------------------------------------

def partial_coherence_per_row(sr, si, e: int, lam: float):
    """(C, C) magnitude-squared partial coherence from one bank row's
    pairwise epoch sums (the ``pair_matrix_scan`` epilogue contract).

    ``PCoh_ij = |S^{-1}_ij|^2 / (S^{-1}_ii S^{-1}_jj)`` — the precision
    (inverse cross-spectral) matrix zeroes exactly where channels i and
    j are uncorrelated GIVEN every other channel, so purely mediated
    coupling (i - k - j chains) that ordinary coherence reports
    vanishes here.  ``lam`` is a relative Tikhonov floor on the
    diagonal (the inverse of a rank-deficient or ill-conditioned S is
    otherwise garbage); the complex inverse runs as the real (2C, 2C)
    block solve — no complex linalg primitives on device."""
    from .granger import _solve_complex
    c = sr.shape[0]
    s = (jnp.mean(sr, axis=-1) + 1j * jnp.mean(si, axis=-1)) / e
    tr = jnp.real(jnp.trace(s)) / c
    s = s + lam * jnp.maximum(tr, 1e-30) * jnp.eye(c, dtype=s.dtype)
    sinv = _solve_complex(s, jnp.eye(c, dtype=s.dtype))
    d = jnp.maximum(jnp.real(jnp.diagonal(sinv)), 1e-30)
    num = jnp.real(sinv) ** 2 + jnp.imag(sinv) ** 2
    return num / (d[:, None] * d[None, :])


def partial_coherence_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                                interpolate: bool = False,
                                lam: float = 1e-5,
                                time_range=None) -> jnp.ndarray:
    """All-pairs partial coherence: (E, C, N) -> (F, C, C).

    The conditional counterpart of ``coherence_matrix_from_bank``:
    channel-pair coupling with every OTHER channel partialed out, from
    the inverse of the epoch- and time-averaged wavelet cross-spectral
    matrix per bank row.  A pair whose marginal coherence is entirely
    mediated by a third channel drops to ~0 here.  Symmetric, diagonal
    1 by construction.  Needs E * n_time >= C independent samples for a
    well-conditioned inverse (``lam`` floors the rest).
    """
    if sigs.shape[1] < 2:
        raise ValueError("partial coherence needs at least 2 channels")
    e = sigs.shape[0]

    def per_row(sr, si):
        return partial_coherence_per_row(sr, si, e, lam)

    return pair_matrix_scan(sigs, bank, per_row, interpolate,
                            time_range=time_range,
                            precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("interpolate", "lam", "time_range"))
def _pcoh_matrix_jit(sigs, bank_r, *, interpolate, lam, time_range):
    return partial_coherence_from_bank(sigs, bank_r, interpolate, lam,
                                       time_range)


def partial_coherence(sigs_r, bank_r, interpolate: bool = False,
                      lam: float = 1e-5, time_range=None):
    """Jitted float-boundary wrapper for
    ``partial_coherence_from_bank``."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _pcoh_matrix_jit(sigs_r, bank_r, interpolate=bool(interpolate),
                            lam=float(lam), time_range=tr)


# ----------------------------------------------------------------------------
# Phase-slope index (directed connectivity)
# ----------------------------------------------------------------------------

def _psi_row_creps(spec, bank_row, n0, n1, e, eps, complete=None):
    """Coherency REPLICATES for one bank row: the full-sample estimate
    plus the (locally held) leave-one-epoch-out estimates, as a (real,
    imag) pair of (E_local + 1, C, C) stacks (the LAST row is the full
    sample).  ``e`` is the GLOBAL epoch count; ``complete`` (the sharded
    path's ``psum``) finishes the total cross-spectral sums across
    devices — identity when None.

    The per-epoch time-summed cross products ``sum_t W_a conj(W_b)`` are
    four HIGHEST-precision batched matmuls (time is the contraction) —
    jackknife replicates differ from the total by O(1/E), so default
    bf16 matmul round-off (~5e-3) would swamp exactly the differences
    the jackknife variance is built from."""
    w = jnp.fft.ifft(spec * bank_row)[..., n0:n1]             # (E, C, n)
    wr, wi = jnp.real(w), jnp.imag(w)
    hp = jax.lax.Precision.HIGHEST
    sr = (jnp.einsum('ean,ebn->eab', wr, wr, precision=hp)
          + jnp.einsum('ean,ebn->eab', wi, wi, precision=hp))
    si = (jnp.einsum('ean,ebn->eab', wi, wr, precision=hp)
          - jnp.einsum('ean,ebn->eab', wr, wi, precision=hp))
    tot_r, tot_i = jnp.sum(sr, axis=0), jnp.sum(si, axis=0)
    if complete is not None:
        tot_r, tot_i = complete(tot_r), complete(tot_i)
    rep_r = jnp.concatenate(
        [(tot_r[None] - sr) / (e - 1.0), tot_r[None] / e], axis=0)
    rep_i = jnp.concatenate(
        [(tot_i[None] - si) / (e - 1.0), tot_i[None] / e], axis=0)
    # coherency: S_ab / sqrt(S_aa S_bb); the diagonal of rep_r IS the
    # per-replicate power (rep_i diagonal is rounding noise)
    p = jnp.einsum('raa->ra', rep_r)                          # (E+1, C)
    den = jnp.sqrt(jnp.maximum(p[:, :, None] * p[:, None, :], 0.0))
    den = jnp.maximum(den, eps * jnp.max(den))
    return rep_r / den, rep_i / den


def psi_reps_scan(sigs, bank, n0, n1, e, eps, interpolate,
                  complete=None) -> jnp.ndarray:
    """(E_local + 1, C, C) PSI replicates: leave-one-out rows for every
    locally held epoch plus the full-sample estimate last, accumulated
    over adjacent bank-row pairs inside ``lax.scan``.  Shared by the
    single-device and ``parallel.sharded_psi_matrix`` paths."""
    spec = analytic_spectrum(sigs, interpolate)

    def creps(row):
        return _psi_row_creps(spec, row, n0, n1, e, eps, complete)

    def step(prev, bank_row):
        cur = creps(bank_row)
        pr, pi = prev
        cr, ci = cur
        return cur, pr * ci - pi * cr          # Im(conj(prev) * cur)

    _, incs = lax.scan(step, creps(bank[0]), bank[1:])
    reps = jnp.sum(incs, axis=0)
    # Pin the diagonal to exact 0 (a channel has no slope against
    # itself).  On CPU the two si einsums cancel exactly; a reduced-
    # precision matmul lowering leaves rounding noise there (same
    # failure mode as the documented wpli self-pair gotcha), and the
    # jackknife normalization would blow that noise up to O(1) values.
    c = reps.shape[-1]
    return reps * (1.0 - jnp.eye(c, dtype=reps.dtype))


def psi_matrix_from_bank(sigs: jnp.ndarray, bank: jnp.ndarray,
                  interpolate: bool = False, eps: float = 1e-12,
                  time_range=None, normalize: bool = True) -> jnp.ndarray:
    """Phase-slope index over every channel pair: (E, C, N) -> (C, C).

    The all-pairs, jackknife-normalized form of the pairwise
    time-resolved ``extensions.psi``.  Nolte et al. 2008 (PRL 100:234101): ``PSI_ab = Im sum_f
    conj(C_ab(f)) C_ab(f + df)`` with ``C`` the complex coherency —
    positive ``PSI[a, b]`` means channel ``a`` temporally LEADS ``b``
    (consistent phase-lag slope across the band), and unlike the
    imaginary part of coherency alone the sign is a genuine direction
    estimate that vanishes for instantaneous (volume-conducted) mixing.
    Antisymmetric with zero diagonal.

    Here ``C(f)`` comes from the wavelet cross-spectra of the given bank
    rows (epoch- and time-averaged); adjacent-row pairs play f/f + df,
    so the bank rows MUST be in ascending frequency order, and the slope
    interpretation is cleanest on a uniformly spaced grid (a log grid
    yields a log-frequency slope — same sign, different weighting).

    ``normalize=True`` (standard practice and the default) divides by
    the leave-one-epoch-out jackknife standard error, making the result
    a z-like statistic (|PSI| > 2 is the conventional threshold); the
    replicates stream through the SAME per-row scan, so the cost is one
    extra batch row per epoch.  Needs E >= 3 for a meaningful jackknife.

    Memory is O(E*C*N + E*C*C): the (E, C, F, N) coefficient tensor
    never exists — one signal FFT up front, one iFFT per bank row,
    accumulated across adjacent-row pairs inside ``lax.scan``.
    """
    e = sigs.shape[0]
    if e < 2:
        raise ValueError("psi needs at least 2 epochs (>= 3 for a "
                         "meaningful jackknife)")
    if bank.shape[0] < 2:
        raise ValueError("psi needs at least 2 bank rows (adjacent "
                         "frequency pairs form the slope)")
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])
    psi_reps = psi_reps_scan(sigs, bank, n0, n1, e, eps,
                             interpolate)                     # (E+1, C, C)
    psi = psi_reps[e]
    if not normalize:
        return psi
    jk = psi_reps[:e]
    jk_mean = jnp.mean(jk, axis=0)
    var = (e - 1.0) * jnp.mean((jk - jk_mean) ** 2, axis=0)
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    return jnp.where(std > 0, psi / jnp.where(std > 0, std, 1.0), 0.0)


@partial(jax.jit, static_argnames=("interpolate", "eps", "time_range",
                                   "normalize"))
def _psi_matrix_jit(sigs, bank_r, *, interpolate, eps, time_range, normalize):
    return psi_matrix_from_bank(sigs, bank_r, interpolate, eps,
                                time_range, normalize)


def psi_matrix(sigs_r, bank_r, interpolate: bool = False, eps: float = 1e-12,
        time_range=None, normalize: bool = True):
    """Jitted float-boundary wrapper for ``psi_matrix_from_bank`` (real
    analytic banks only — coherency phase needs the analytic signal)."""
    tr = None if time_range is None else (int(time_range[0]),
                                          int(time_range[1]))
    return _psi_matrix_jit(sigs_r, bank_r, interpolate=bool(interpolate),
                    eps=float(eps), time_range=tr,
                    normalize=bool(normalize))


# ----------------------------------------------------------------------------
# Lagged coherence (rhythmicity)
# ----------------------------------------------------------------------------

def _lagged_indices(freqs, sfreq: float, n: int, lag: int):
    """Host-side per-frequency sample grids: ``idx[f, k]`` is the k-th
    coefficient sample, spaced ``lag`` periods apart; ``valid[f, k]``
    masks samples past the signal end (strides differ per frequency, so
    K is the MAX count and short rows are masked — static shapes)."""
    freqs = np.asarray(freqs, np.float64)
    stride = lag * sfreq / freqs                     # samples per lag
    k_max = int(np.floor((n - 1) / stride.min())) + 1
    k = np.arange(k_max)[None, :]
    pos = k * stride[:, None]
    valid = pos <= n - 1
    idx = np.minimum(np.round(pos), n - 1).astype(np.int32)
    return jnp.asarray(idx), jnp.asarray(valid)


@partial(jax.jit, static_argnames=("interpolate", "pooled"))
def _lagged_coh_jit(sig, bank_r, idx, valid, *, interpolate,
                    pooled=False):
    w = cwt_from_bank(sig, bank_r, interpolate)      # (..., F, N)
    shape = w.shape[:-1] + (idx.shape[-1],)
    wk = jnp.take_along_axis(w, jnp.broadcast_to(idx, shape), axis=-1)
    a, b = wk[..., :-1], wk[..., 1:]
    m = (valid[..., :-1] & valid[..., 1:]).astype(jnp.float32)
    num = jnp.sum(a * jnp.conj(b) * m, axis=-1)
    p_a = jnp.sum(jnp.abs(a) ** 2 * m, axis=-1)
    p_b = jnp.sum(jnp.abs(b) ** 2 * m, axis=-1)
    if pooled:  # pool the pair sums over every leading axis (epochs)
        red = tuple(range(num.ndim - 1))
        num, p_a, p_b = (jnp.sum(v, axis=red) for v in (num, p_a, p_b))
    return jnp.abs(num) / jnp.maximum(jnp.sqrt(p_a * p_b), 1e-20)


def lagged_coherence(sig_r, bank_r, freqs, sfreq: float, lag: int = 1,
                     interpolate: bool = False,
                     pooled: bool = False) -> jnp.ndarray:
    """Wavelet lagged coherence — rhythmicity per frequency (after
    Fransen et al. 2015, with the wavelet's own support as the spectral
    window): coefficients sampled ``lag`` periods apart, and

    ``L(f) = |sum_k w_k conj(w_{k+1})| / sqrt(sum|w_k|^2 sum|w_{k+1}|^2)``

    — 1 for a sustained rhythm whose phase advances deterministically
    cycle to cycle, low for noise or one-off transients (what plain
    power cannot distinguish).  ``sig_r`` is (..., N) real; returns
    (..., F), or (F,) with ``pooled=True`` (the pair sums pool over
    every leading axis — the right estimator for epoched data, where
    per-epoch ratios would be averaged with equal weight regardless of
    how many pairs each epoch contributes).  ``freqs`` must be the Hz
    values of the bank rows."""
    sig = jnp.asarray(sig_r, jnp.float32)
    bank_r = jnp.asarray(bank_r, jnp.float32)
    n = sig.shape[-1]
    if bank_r.shape != (len(np.atleast_1d(freqs)), n):
        raise ValueError("bank must be (F, N) matching freqs and signal")
    if lag < 1:
        raise ValueError("lag must be >= 1 period")
    if np.asarray(freqs, np.float64).min() * n < lag * sfreq:
        raise ValueError("signal too short for even one lag at the "
                         "lowest frequency")
    idx, valid = _lagged_indices(freqs, sfreq, n, int(lag))
    return _lagged_coh_jit(sig, bank_r, idx, valid,
                           interpolate=bool(interpolate),
                           pooled=bool(pooled))


@_lru_cache(maxsize=None)
def _short_morse_def(beta: float, gamma: float):
    """Reverse-mode Morse WaveletDef with (beta, gamma) baked in, cached
    (WaveletDef is a static jit key — see ops.superlets._morlet_def)."""
    from .bank import WaveletDef, WaveletMode
    from .spectra import morse_spectrum

    def tf(grid, freq=1.0):
        return morse_spectrum(grid, freq, beta, gamma)

    return WaveletDef(mode=WaveletMode.Reverse, trans_formula=tf,
                      params=("lagged-coh-morse", float(beta),
                              float(gamma)))


def lagged_coherence_morse(sig_r, freqs, sfreq: float,
                           n_cycles: float = 3.0, lag=None,
                           gamma: float = 3.0,
                           pooled: bool = False) -> jnp.ndarray:
    """:func:`lagged_coherence` with a self-consistent window: a SHORT
    Morse bank whose duration is ~``n_cycles`` periods
    (``beta = n_cycles^2 / gamma`` so ``P = sqrt(beta gamma) = n_cycles``)
    and ``lag`` defaulting to ``ceil(n_cycles)`` — samples one window
    apart are near-independent under noise, which is what makes the
    metric discriminative (with a long analysis wavelet and ``lag=1``
    the wavelet's own autocorrelation pushes even white noise toward 1;
    measured 0.85 for the default ``Morse(beta=17.5)`` at lag 1)."""
    from .bank import make_fft_bank_ri
    sig = jnp.asarray(sig_r, jnp.float32)
    if lag is None:
        lag = int(np.ceil(n_cycles))
    beta = float(n_cycles) ** 2 / float(gamma)
    br, _ = make_fft_bank_ri(_short_morse_def(beta, float(gamma)),
                             jnp.asarray(np.asarray(freqs, np.float32)),
                             int(sig.shape[-1]), float(sfreq), True)
    return lagged_coherence(sig, br, freqs, sfreq, lag=int(lag),
                            interpolate=True, pooled=bool(pooled))
