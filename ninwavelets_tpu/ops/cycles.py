"""Cycle-by-cycle waveform analysis (Cole & Voytek, J. Neurophysiol.
2019 — the "bycycle" method).  No reference counterpart — this is the
time-domain complement of the TFR family: instead of asking how much
band power there is, it segments an oscillation into individual cycles
and measures each one's shape (period, rise-decay and peak-trough
asymmetry, amplitude, monotonicity), then flags which cycles belong to
genuine bursts.  Waveform asymmetries carry physiology (e.g. sawtooth
beta in motor cortex) that any Fourier/wavelet power spectrum discards.

Design notes:
* the narrowband localizer runs on the rfft grid (raised-cosine band
  edges; input reflect-padded to a power of two, the FFT's fastest
  length), extrema are then localized on the RAW signal as in
  bycycle;
* cycle segmentation is static-shape throughout: rising/falling
  zero-crossings of the filtered trace become segment ids via a cumsum,
  per-segment extrema come from ``jax.ops.segment_max`` scatter
  reductions (value pass + index-recovery pass), and every per-cycle
  table is padded to a static width ``ceil(N f_hi / sfreq) + 2`` with a
  validity count per row;
* no data-dependent shapes, no host loops: one jit compiles the whole
  pipeline for a (B, N) batch and every feature is a gather/arithmetic
  over the padded extrema tables;
* burst flagging follows bycycle's four criteria (amplitude fraction,
  amplitude consistency, period consistency, monotonicity) with the
  consecutive-cycle requirement implemented as a boolean convolution.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["cycle_features", "CycleTable"]


class CycleTable(NamedTuple):
    """Padded per-cycle features, each (..., K); entries at index >=
    ``n_cycles`` are zero/False padding.  Cycles run trough-to-trough
    with one peak inside; times are in seconds from the signal start."""
    n_cycles: jnp.ndarray        # (...,) int32 valid cycles per row
    time_trough: jnp.ndarray     # (..., K) left trough time [s]
    time_peak: jnp.ndarray       # (..., K) peak time [s]
    period_s: jnp.ndarray        # (..., K) trough-to-trough period [s]
    freq_hz: jnp.ndarray         # (..., K) 1 / period
    volt_amp: jnp.ndarray        # (..., K) mean of rise and decay swing
    rdsym: jnp.ndarray           # (..., K) rise fraction of the period
    ptsym: jnp.ndarray           # (..., K) peak fraction of peak+trough
    monotonicity: jnp.ndarray    # (..., K) monotone fraction of flanks
    is_burst: jnp.ndarray        # (..., K) bool, bycycle burst criteria


def _bandpass(x, sfreq, f_lo, f_hi, trans_frac=0.25):
    """Raised-cosine bandpass on the rfft grid of the pow2-padded row."""
    from .dwt import pow2_pad
    n = x.shape[-1]
    x, _ = pow2_pad(x)
    n2 = x.shape[-1]
    f = jnp.arange(n2 // 2 + 1, dtype=jnp.float32) * (sfreq / n2)
    tl = f_lo * trans_frac
    th = f_hi * trans_frac

    def edge(d, w):                       # 0 below, 1 above, cosine ramp
        return 0.5 * (1.0 + jnp.sin(jnp.pi * jnp.clip(d / w, -0.5, 0.5)))

    gain = edge(f - f_lo, 2.0 * tl) * edge(f_hi - f, 2.0 * th)
    y = jnp.fft.irfft(jnp.fft.rfft(x) * gain, n=n2, axis=-1)
    return y[..., :n]


def _seg_argext(values, seg, valid, num_segments, mode):
    """Per-segment argmax ('max') / argmin ('min') of ``values`` over
    samples where ``valid``; returns (idx (S,), found (S,)) per row via
    two scatter passes."""
    n = values.shape[-1]
    v = jnp.where(valid, values if mode == "max" else -values, -jnp.inf)
    best = jax.ops.segment_max(v, seg, num_segments=num_segments)
    hit = valid & (v >= best[seg])
    idx = jax.ops.segment_min(
        jnp.where(hit, jnp.arange(n), n), seg,
        num_segments=num_segments)
    found = best > -jnp.inf
    return jnp.where(found, idx, 0), found


def _row_features(x, xf, sfreq, kmax):
    """All features for one (N,) row; returns a CycleTable of (K,)."""
    n = x.shape[-1]
    t_idx = jnp.arange(n)
    # rising zero-crossings of the filtered trace start half-cycles
    rise = jnp.concatenate([jnp.zeros(1, bool),
                            (xf[:-1] < 0) & (xf[1:] >= 0)])
    fall = jnp.concatenate([jnp.zeros(1, bool),
                            (xf[:-1] >= 0) & (xf[1:] < 0)])
    # peak segment p: [rise_p, next fall); trough segment q: [fall_q, next rise)
    pseg = jnp.cumsum(rise.astype(jnp.int32)) - 1          # -1 before first
    qseg = jnp.cumsum(fall.astype(jnp.int32)) - 1
    in_peak = (pseg >= 0) & (xf >= 0)
    in_trough = (qseg >= 0) & (xf < 0)
    pk_idx, pk_ok = _seg_argext(x, jnp.maximum(pseg, 0), in_peak, kmax,
                                "max")
    tr_idx, tr_ok = _seg_argext(x, jnp.maximum(qseg, 0), in_trough, kmax,
                                "min")

    n_rise = jnp.sum(rise)
    n_fall = jnp.sum(fall)
    # drop UNCLOSED trailing half-cycles: if the last crossing is a
    # rise, the final peak segment runs to the array end (no closing
    # fall) and its argmax is not a real peak; symmetrically for falls.
    kk0 = jnp.arange(kmax)
    last_rise = jnp.max(jnp.where(rise, t_idx, -1))
    last_fall = jnp.max(jnp.where(fall, t_idx, -1))
    pk_ok = pk_ok & ~((kk0 == n_rise - 1) & (last_rise > last_fall))
    tr_ok = tr_ok & ~((kk0 == n_fall - 1) & (last_fall > last_rise))
    # pair troughs with the peak that follows them.  If the first
    # extremum overall is a peak (first rise before first fall), peak j
    # sits AFTER trough j-1: shift peaks left by one.
    first_rise = jnp.argmax(rise)
    first_fall = jnp.argmax(fall)
    peak_leads = (first_rise < first_fall) & (n_rise > 0) & (n_fall > 0)
    kk = jnp.arange(kmax)
    pk_of = jnp.where(peak_leads, kk + 1, kk)              # peak for trough j
    pk_t = jnp.take(pk_idx, jnp.clip(pk_of, 0, kmax - 1))
    pk_valid = jnp.take(pk_ok, jnp.clip(pk_of, 0, kmax - 1)) & (pk_of < kmax)

    # cycle j: trough j -> peak(j) -> trough j+1
    tr_next = jnp.take(tr_idx, jnp.clip(kk + 1, 0, kmax - 1))
    tr_next_ok = jnp.take(tr_ok, jnp.clip(kk + 1, 0, kmax - 1)) \
        & (kk + 1 < kmax)
    valid = tr_ok & tr_next_ok & pk_valid \
        & (pk_t > tr_idx) & (tr_next > pk_t)
    n_cycles = jnp.sum(valid)
    # compact valid cycles to the front (stable order preserved)
    order = jnp.argsort(jnp.where(valid, kk, kmax))
    take = lambda a: jnp.where(jnp.arange(kmax) < n_cycles,
                               jnp.take(a, order), 0)

    tr0 = take(tr_idx)
    tr1 = take(tr_next)
    pk = take(pk_t)
    period = (tr1 - tr0).astype(jnp.float32)
    period = jnp.maximum(period, 1.0)
    rise_t = (pk - tr0).astype(jnp.float32)
    rdsym = rise_t / period

    xv = lambda i: jnp.take(x, jnp.clip(i, 0, n - 1))
    amp = 0.5 * ((xv(pk) - xv(tr0)) + (xv(pk) - xv(tr1)))

    # monotonicity: monotone fraction of the raw-signal flanks.  Sample
    # i belongs to cycle j's rise if tr0_j <= i < pk_j etc. — scatter the
    # monotone indicator with the trough/peak segment ids.
    dx = jnp.concatenate([jnp.zeros(1, x.dtype), jnp.diff(x)])
    cyc_of_sample = jnp.cumsum(
        jnp.zeros(n, jnp.int32).at[tr0].add(
            jnp.where(jnp.arange(kmax) < n_cycles, 1, 0))) - 1
    in_cyc = cyc_of_sample >= 0
    pk_of_sample = jnp.take(pk, jnp.clip(cyc_of_sample, 0, kmax - 1))
    tr1_of_sample = jnp.take(tr1, jnp.clip(cyc_of_sample, 0, kmax - 1))
    on_rise = in_cyc & (t_idx >= jnp.take(
        tr0, jnp.clip(cyc_of_sample, 0, kmax - 1))) & (t_idx < pk_of_sample)
    on_decay = in_cyc & (t_idx >= pk_of_sample) & (t_idx < tr1_of_sample)
    seg_ids = jnp.where(in_cyc, cyc_of_sample, kmax)
    mono_hits = jnp.where(on_rise, (dx > 0).astype(jnp.float32), 0.0) \
        + jnp.where(on_decay, (dx < 0).astype(jnp.float32), 0.0)
    flank = (on_rise | on_decay).astype(jnp.float32)
    hits = jax.ops.segment_sum(mono_hits, seg_ids, num_segments=kmax + 1)
    tot = jax.ops.segment_sum(flank, seg_ids, num_segments=kmax + 1)
    mono = (hits[:kmax] / jnp.maximum(tot[:kmax], 1.0))

    # peak/trough durations from RAW-waveform flank-midpoint crossings
    # (the bycycle rule — filter zero crossings would erase exactly the
    # harmonic structure that makes peaks sharp): rise crossing = first
    # rise-flank sample at or above the trough-peak midpoint, decay
    # crossing = first decay-flank sample at or below it.
    cidx = jnp.clip(cyc_of_sample, 0, kmax - 1)
    mid_r = jnp.take(0.5 * (xv(tr0) + xv(pk)), cidx)
    mid_d = jnp.take(0.5 * (xv(pk) + xv(tr1)), cidx)
    rise_zx = jax.ops.segment_min(
        jnp.where(on_rise & (x >= mid_r), t_idx, n), seg_ids,
        num_segments=kmax + 1)[:kmax]
    decay_zx = jax.ops.segment_min(
        jnp.where(on_decay & (x <= mid_d), t_idx, n), seg_ids,
        num_segments=kmax + 1)[:kmax]
    rise_zx = jnp.where(rise_zx >= n, pk, rise_zx)       # fallback: peak
    decay_zx = jnp.where(decay_zx >= n, tr1, decay_zx)   # fallback: trough
    peak_dur = jnp.maximum((decay_zx - rise_zx).astype(jnp.float32), 1.0)
    rise_zx_next = jnp.take(rise_zx, jnp.clip(kk + 1, 0, kmax - 1))
    # the compacted neighbor is only usable when it is RAW-adjacent
    # (nothing was dropped in between — its left trough is our right
    # trough); otherwise fall back to the within-cycle estimate.
    tr0_next = jnp.take(tr0, jnp.clip(kk + 1, 0, kmax - 1))
    adjacent = ((kk + 1) < jnp.sum(valid)) & (tr0_next == tr1)
    trough_dur = jnp.where(
        adjacent, (rise_zx_next - decay_zx).astype(jnp.float32),
        period - peak_dur)                               # edge fallback
    trough_dur = jnp.maximum(trough_dur, 1.0)
    ptsym = peak_dur / (peak_dur + trough_dur)

    dt = 1.0 / sfreq
    pad = jnp.arange(kmax) < n_cycles
    z = lambda a: jnp.where(pad, a, 0.0)
    return (n_cycles.astype(jnp.int32), z(tr0 * dt), z(pk * dt),
            z(period * dt), z(jnp.where(pad, sfreq / period, 0.0)),
            z(amp), z(rdsym), z(ptsym), z(mono))


def _burst_flags(n_cycles, amp, period, mono, kmax, amp_fraction,
                 amp_consistency, period_consistency,
                 monotonicity_threshold, min_n_cycles):
    pad = jnp.arange(kmax)[None, :] < n_cycles[:, None]
    # amplitude fraction: rank of each cycle's amp among the row's cycles
    rank = jnp.sum(
        (amp[:, None, :] < amp[:, :, None]) & pad[:, None, :], -1)
    frac = rank.astype(jnp.float32) / jnp.maximum(
        (n_cycles - 1)[:, None].astype(jnp.float32), 1.0)
    c_amp = frac >= amp_fraction

    def consistency(v):
        # edge cycles get a one-sided rule on BOTH ends: the first
        # cycle's prv duplicates itself (the concat below), and the
        # LAST VALID cycle's nxt must too — shifting left would pull
        # the zero padding in and veto every burst's final cycle.
        kk = jnp.arange(kmax)[None, :]
        shifted = jnp.concatenate([v[:, 1:], v[:, -1:]], axis=-1)
        nxt = jnp.where(kk >= (n_cycles - 1)[:, None], v, shifted)
        prv = jnp.concatenate([v[:, :1], v[:, :-1]], axis=-1)
        r_n = jnp.minimum(v, nxt) / jnp.maximum(jnp.maximum(v, nxt), 1e-12)
        r_p = jnp.minimum(v, prv) / jnp.maximum(jnp.maximum(v, prv), 1e-12)
        return jnp.minimum(r_n, r_p)

    c_ac = consistency(amp) >= amp_consistency
    c_pc = consistency(period) >= period_consistency
    c_mono = mono >= monotonicity_threshold
    ok = c_amp & c_ac & c_pc & c_mono & pad
    # require min_n_cycles consecutive: a cycle bursts iff it sits in a
    # run of >= min_n_cycles passing cycles (boolean convolution)
    okf = ok.astype(jnp.float32)
    kern = jnp.ones((min_n_cycles,), jnp.float32)
    runs = jax.vmap(lambda r: jnp.convolve(r, kern, mode="valid"))(okf)
    full = runs >= min_n_cycles - 0.5            # run starting at j
    w = kmax - min_n_cycles + 1
    member = jnp.zeros_like(okf, dtype=bool)
    for s in range(min_n_cycles):                # static small loop
        member = member.at[:, s:s + w].set(
            member[:, s:s + w] | full)
    return member & ok


@partial(jax.jit, static_argnames=("sfreq", "f_lo", "f_hi", "kmax",
                                   "amp_fraction", "amp_consistency",
                                   "period_consistency",
                                   "monotonicity_threshold",
                                   "min_n_cycles"))
def _cycles_jit(x, *, sfreq, f_lo, f_hi, kmax, amp_fraction,
                amp_consistency, period_consistency,
                monotonicity_threshold, min_n_cycles):
    xf = _bandpass(x, sfreq, f_lo, f_hi)
    feats = jax.vmap(lambda a, b: _row_features(a, b, sfreq, kmax))(x, xf)
    (n_cycles, t_tr, t_pk, period, freq, amp, rdsym, ptsym, mono) = feats
    burst = _burst_flags(n_cycles, amp, period / (1.0 / sfreq), mono,
                         kmax, amp_fraction, amp_consistency,
                         period_consistency, monotonicity_threshold,
                         min_n_cycles)
    return CycleTable(n_cycles, t_tr, t_pk, period, freq, amp, rdsym,
                      ptsym, mono, burst)


def cycle_features(signal_r, sfreq: float, f_range,
                   amp_fraction: float = 0.0,
                   amp_consistency: float = 0.5,
                   period_consistency: float = 0.5,
                   monotonicity_threshold: float = 0.8,
                   min_n_cycles: int = 3) -> CycleTable:
    """Cycle-by-cycle shape features of a real (..., N) signal in the
    ``f_range = (f_lo, f_hi)`` band: a ``CycleTable`` of padded (..., K)
    per-cycle features plus bycycle-style burst flags.

    Cycles are segmented by the zero crossings of a raised-cosine
    bandpass of the signal, but peaks/troughs (and therefore every
    feature) are localized on the RAW signal inside each half-cycle —
    the bycycle convention, which preserves the waveform asymmetries
    the filter would smooth away.  The four burst thresholds follow
    bycycle's defaults; cycles only count as bursting inside a run of
    ``min_n_cycles`` consecutive passing cycles.
    """
    f_lo, f_hi = (float(f_range[0]), float(f_range[1]))
    if not (0.0 < f_lo < f_hi):
        raise ValueError("f_range must satisfy 0 < f_lo < f_hi")
    if f_hi >= sfreq / 2.0:
        raise ValueError("f_hi must be below Nyquist")
    x = jnp.asarray(signal_r, jnp.float32)
    n = x.shape[-1]
    if n < 16:
        raise ValueError("signal too short")
    # crossing rate is bounded by the top of the TRANSITION band
    # (1.25 f_hi), with margin; overflowing cycles would be dropped
    kmax = int(np.ceil(1.5 * n * f_hi / sfreq)) + 4
    lead = x.shape[:-1]
    out = _cycles_jit(
        x.reshape(-1, n), sfreq=float(sfreq), f_lo=f_lo, f_hi=f_hi,
        kmax=kmax, amp_fraction=float(amp_fraction),
        amp_consistency=float(amp_consistency),
        period_consistency=float(period_consistency),
        monotonicity_threshold=float(monotonicity_threshold),
        min_n_cycles=int(min_n_cycles))
    if lead:
        return CycleTable(out.n_cycles.reshape(lead),
                          *[f.reshape(*lead, kmax) for f in out[1:]])
    return CycleTable(out.n_cycles[0], *[f[0] for f in out[1:]])
