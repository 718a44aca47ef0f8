"""Evoked-response (ERP) measurement: peaks, mean amplitudes,
fractional-area latencies, and jackknife onset latencies.

No reference counterpart — these are the standard component-measurement
tools (Luck, "An Introduction to the ERP Technique") applied to exactly
the epoched arrays the adapters hold, complementing the evoked/induced
power split the TFR side already has.

Design: every measure is a windowed reduction (argmax / mean /
cumsum-threshold crossing) over a static slice — no dynamic shapes; the
jackknife onset family builds ALL leave-one-out evoked waveforms with
one rank-1 update of the epoch sum (never E separate means) and the
Miller-Ulrich variance correction is a closed form.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["evoked", "peak_measures", "mean_amplitude",
           "fractional_area_latency", "fractional_peak_onset",
           "jackknife_onsets", "PeakResult"]


class PeakResult(NamedTuple):
    """Windowed peak measurement: ``latency`` (samples, absolute index
    into the epoch), ``amplitude`` (signal units), both shaped like the
    input minus the time axis."""
    latency: jnp.ndarray
    amplitude: jnp.ndarray


def evoked(x) -> jnp.ndarray:
    """(E, ..., N) -> (..., N) trial-average waveform."""
    return jnp.mean(jnp.asarray(x, jnp.float32), axis=0)


def _window(x, window, n):
    if window is None:
        return 0, n
    lo, hi = int(window[0]), int(window[1])
    if not 0 <= lo < hi <= n:
        raise ValueError(f"window {window} outside 0..{n}")
    return lo, hi


@partial(jax.jit, static_argnames=("lo", "hi", "polarity"))
def _peak_jit(x, *, lo, hi, polarity):
    seg = x[..., lo:hi]
    seg = seg if polarity >= 0 else -seg
    idx = jnp.argmax(seg, axis=-1)
    amp = jnp.take_along_axis(x[..., lo:hi], idx[..., None],
                              axis=-1)[..., 0]
    return (idx + lo).astype(jnp.int32), amp


def peak_measures(x, window=None, polarity: int = 1) -> PeakResult:
    """Largest positive (``polarity=+1``) or negative (``-1``) peak of
    (..., N) waveforms inside ``window`` (a (lo, hi) SAMPLE pair;
    default all): absolute-sample latency + signed amplitude."""
    x = jnp.asarray(x, jnp.float32)
    lo, hi = _window(x, window, x.shape[-1])
    lat, amp = _peak_jit(x, lo=lo, hi=hi, polarity=int(polarity))
    return PeakResult(latency=lat, amplitude=amp)


def mean_amplitude(x, window) -> jnp.ndarray:
    """Mean amplitude of (..., N) waveforms over the (lo, hi) sample
    window — the measurement Luck recommends over peak amplitude (it is
    linear in the data, so trial averaging and measurement commute)."""
    x = jnp.asarray(x, jnp.float32)
    lo, hi = _window(x, window, x.shape[-1])
    return jnp.mean(x[..., lo:hi], axis=-1)


@partial(jax.jit, static_argnames=("lo", "hi", "fraction", "polarity"))
def _frac_area_jit(x, *, lo, hi, fraction, polarity):
    seg = x[..., lo:hi]
    seg = seg if polarity >= 0 else -seg
    seg = jnp.maximum(seg, 0.0)               # signed-area convention
    c = jnp.cumsum(seg, axis=-1)
    total = c[..., -1:]
    # first sample where the running area crosses fraction * total
    hit = c >= fraction * total
    idx = jnp.argmax(hit, axis=-1)
    return (idx + lo).astype(jnp.int32)


def fractional_area_latency(x, window, fraction: float = 0.5,
                            polarity: int = 1) -> jnp.ndarray:
    """Latency (absolute samples) at which ``fraction`` of the
    component's area inside ``window`` has accumulated (50% = the
    standard midpoint latency — far more noise-robust than the peak).
    Only same-polarity area counts (negative excursions clip to 0)."""
    x = jnp.asarray(x, jnp.float32)
    lo, hi = _window(x, window, x.shape[-1])
    if not 0.0 < float(fraction) < 1.0:
        raise ValueError("fraction must be in (0, 1)")
    return _frac_area_jit(x, lo=lo, hi=hi, fraction=float(fraction),
                          polarity=int(polarity))


@partial(jax.jit, static_argnames=("lo", "hi", "criterion", "polarity"))
def _frac_peak_onset_jit(x, *, lo, hi, criterion, polarity):
    seg = x[..., lo:hi]
    seg = seg if polarity >= 0 else -seg
    pk = jnp.argmax(seg, axis=-1)
    pamp = jnp.take_along_axis(seg, pk[..., None], axis=-1)
    # last sample BEFORE the peak that is still below criterion * peak:
    # scan the below-threshold mask restricted to t <= peak
    t = jnp.arange(seg.shape[-1])
    below = (seg < criterion * pamp) & (t <= pk[..., None])
    # argmax of reversed mask -> LAST True index
    rev = jnp.flip(below, axis=-1)
    last = seg.shape[-1] - 1 - jnp.argmax(rev, axis=-1)
    any_below = jnp.any(below, axis=-1)
    onset = jnp.where(any_below, last, 0)
    return (onset + lo).astype(jnp.int32)


def fractional_peak_onset(x, window, criterion: float = 0.5,
                          polarity: int = 1) -> jnp.ndarray:
    """Onset latency as the last pre-peak sample below ``criterion`` x
    peak amplitude (the 50%-of-peak onset of Miller, Patterson & Ulrich
    1998).  Absolute samples; clamps to the window start when the
    waveform never dips below criterion."""
    x = jnp.asarray(x, jnp.float32)
    lo, hi = _window(x, window, x.shape[-1])
    if not 0.0 < float(criterion) < 1.0:
        raise ValueError("criterion must be in (0, 1)")
    return _frac_peak_onset_jit(x, lo=lo, hi=hi,
                                criterion=float(criterion),
                                polarity=int(polarity))


@partial(jax.jit, static_argnames=("lo", "hi", "criterion", "polarity"))
def _jackknife_jit(x, *, lo, hi, criterion, polarity):
    e = x.shape[0]
    tot = jnp.sum(x, axis=0, keepdims=True)           # (1, ..., N)
    loo = (tot - x) / (e - 1.0)                       # (E, ..., N)
    return _frac_peak_onset_jit(loo, lo=lo, hi=hi, criterion=criterion,
                                polarity=polarity)


def jackknife_onsets(x, window, criterion: float = 0.5,
                     polarity: int = 1):
    """Leave-one-trial-out onset latencies of the EVOKED waveform
    (Miller-Ulrich jackknife): measuring onsets on subsample averages
    instead of single noisy trials, with the known variance correction.

    Returns ``(onsets, mean, se)``: the (E, ...) leave-one-out onset
    latencies (samples), their mean, and the Miller-Ulrich corrected
    standard error ``sqrt((E-1)/E * sum (o_i - mean)^2)`` — the naive
    SE of jackknife values UNDERSTATES by (E-1), this is the right one
    for t-tests on onset differences."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim < 2 or x.shape[0] < 2:
        raise ValueError("need (E >= 2, ..., N) epochs")
    lo, hi = _window(x, window, x.shape[-1])
    ons = _jackknife_jit(x, lo=lo, hi=hi, criterion=float(criterion),
                         polarity=int(polarity)).astype(jnp.float32)
    mean = jnp.mean(ons, axis=0)
    e = x.shape[0]
    se = jnp.sqrt((e - 1.0) / e * jnp.sum((ons - mean) ** 2, axis=0))
    return ons, mean, se
