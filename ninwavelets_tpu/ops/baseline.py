"""Baseline correction — the reference's six methods as fused device ops.

Reference: ``Baseline`` class (``/root/reference/ninwavelets/base.py:23-68``).
Semantics preserved exactly, including the documented quirks:

* the baseline window slices the FIRST axis (``wave[int(start*sfreq) :
  int(stop*sfreq)]``, ``base.py:49``) and its mean/std are scalars over the
  whole window;
* ``zlog`` is ``log10(ratio) / std(baseline)`` — log-then-divide, not
  zscore-then-log, despite the reference docstring (``base.py:67-68``);
* ``std`` is the population std of the raw baseline window (``base.py:65``).

On top of the parity API, ``baseline_tf`` applies the same corrections along
the TIME axis of a (..., F, N) time-frequency plane with per-row statistics —
the correction EEG users actually want on a TFR, fused into the power
epilogue on device.
"""
from __future__ import annotations

import jax.numpy as jnp

METHODS = ("mean", "ratio", "percent", "log", "zscore", "zlog")


def _std(x, axis=None, keepdims=False):
    """Two-pass population std (like numpy's): ``sqrt(mean((x - mean)^2))``.
    jnp.std can return NaN on near-constant float32 data (one-pass
    cancellation yields a slightly negative variance under sqrt).
    """
    mean = x.mean(axis=axis, keepdims=True)
    var = jnp.square(x - mean).mean(axis=axis, keepdims=keepdims)
    return jnp.sqrt(var)


def _correct(wave, basemean, basestd, method: str):
    if method == "mean":
        return wave - basemean
    if method == "ratio":
        return wave / basemean
    if method == "percent":
        return (wave - basemean) / basemean
    if method == "log":
        return jnp.log10(wave / basemean)
    if method == "zscore":
        return (wave - basemean) / basestd
    if method == "zlog":
        # Reference quirk (base.py:67-68): log10(ratio) / std — NOT the
        # zscore-then-log the docstring claims.
        return jnp.log10(wave / basemean) / basestd
    raise ValueError(f"unknown baseline method {method!r}; one of {METHODS}")


class Baseline:
    """Drop-in equivalent of the reference ``Baseline`` (``base.py:23-68``).

    The window ``[start, stop)`` is in seconds and slices the first axis;
    statistics are scalars over the entire window, exactly as the reference
    computes them.  All methods are traceable (usable inside jit).
    """

    def __init__(self, wave: jnp.ndarray, sfreq: float, start: float,
                 stop: float) -> None:
        self.wave = jnp.asarray(wave)
        self.baseline = self.wave[int(start * sfreq): int(stop * sfreq)]
        self.basemean = self.baseline.mean()
        self._basestd = _std(self.baseline)

    def mean(self):
        return _correct(self.wave, self.basemean, self._basestd, "mean")

    def ratio(self):
        return _correct(self.wave, self.basemean, self._basestd, "ratio")

    def percent(self):
        return _correct(self.wave, self.basemean, self._basestd, "percent")

    def log(self):
        return _correct(self.wave, self.basemean, self._basestd, "log")

    def zscore(self):
        return _correct(self.wave, self.basemean, self._basestd, "zscore")

    def zlog(self):
        return _correct(self.wave, self.basemean, self._basestd, "zlog")


def baseline_of(wave: jnp.ndarray, sfreq: float, start: float,
                stop: float) -> jnp.ndarray:
    """Reference free function (``base.py:18-20``): slice the window."""
    return jnp.asarray(wave)[int(start * sfreq): int(stop * sfreq)]


def baseline_correct(wave: jnp.ndarray, sfreq: float, start: float,
                     stop: float, method: str = "zscore") -> jnp.ndarray:
    """Functional one-shot form of ``Baseline`` (first-axis window, scalar
    statistics — reference semantics).
    """
    base = jnp.asarray(wave)[int(start * sfreq): int(stop * sfreq)]
    return _correct(jnp.asarray(wave), base.mean(), _std(base), method)


def baseline_tf(tf: jnp.ndarray, sfreq: float, start: float, stop: float,
                method: str = "zscore",
                degenerate: str = "unit") -> jnp.ndarray:
    """Extension: per-frequency-row baseline correction of a
    (..., F, N) time-frequency plane along the TIME axis.

    The reference has no TFR-aware baseline (its class only handles the
    global-scalar case above); this is the fused epilogue the EEG pipeline
    needs — statistics are computed per row over the time window and
    broadcast, all inside the same jitted program as the power reduction.

    ``degenerate`` controls rows whose baseline std is zero (constant in
    float32): ``"unit"`` (default) substitutes std=1 so zscore/zlog degrade
    to mean-correction instead of poisoning the row with inf/NaN;
    ``"strict"`` keeps the exact reference division semantics (inf/NaN),
    matching the scalar ``Baseline`` class.
    """
    if degenerate not in ("unit", "strict"):
        raise ValueError("degenerate must be 'unit' or 'strict'")
    tf = jnp.asarray(tf)
    lo, hi = int(start * sfreq), int(stop * sfreq)
    window = tf[..., lo:hi]
    mean = window.mean(axis=-1, keepdims=True)
    std = _std(window, axis=-1, keepdims=True)
    if degenerate == "unit":
        std = jnp.where(std > 0, std, 1.0)
    return _correct(tf, mean, std, method)
