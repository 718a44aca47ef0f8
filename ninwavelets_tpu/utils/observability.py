"""Observability: structured logging, timers, FLOP/byte estimates, profiling.

The reference has none of this (SURVEY §5: its only "metrics" are anecdotal
wall-clock numbers in the README, and its one error type *prints* instead of
raising, ``base.py:71-72``).  This module provides the production-side
subsystems this build commits to:

* a namespaced ``logging`` logger (no prints anywhere in the library),
* ``Timer`` — wall-clock context manager that blocks on device results, so
  timings measure compute rather than dispatch,
* ``cwt_cost`` — closed-form FLOP / device-memory-byte estimates for a CWT
  workload,
* ``trace`` — a ``jax.profiler`` wrapper producing TensorBoard traces,
* ``debug_nans`` — toggles JAX NaN-checking for numerical debugging.
"""
from __future__ import annotations

import contextlib
import logging
import math
import time
from dataclasses import dataclass
from typing import Optional

import jax

log = logging.getLogger("ninwavelets_tpu")
log.addHandler(logging.NullHandler())


class Timer:
    """Wall-clock timer that blocks until device work is done.

    >>> with Timer("bank") as t:        # doctest: +SKIP
    ...     out = engine.power(sig)
    ...     t.block(out)
    >>> t.elapsed                       # doctest: +SKIP
    0.0123
    """

    def __init__(self, name: str = "", logger: Optional[logging.Logger] = None
                 ) -> None:
        self.name = name
        self.logger = logger or log
        self.elapsed: float = float("nan")

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def block(self, *arrays) -> None:
        """Block on device arrays so __exit__ captures their compute time."""
        jax.block_until_ready(arrays)

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        self.logger.debug("timer %s: %.6f s", self.name or "<anon>",
                          self.elapsed)


def timed_median(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median wall-clock seconds per call of ``fn`` over ``reps``
    repetitions, each synchronized with ``jax.block_until_ready``.

    The measurement discipline the repo's scaling figures use:
    per-repetition sync (back-to-back dispatch can overlap and hide real
    cost), ``warmup`` steady-state calls after the compile call (the
    FIRST timing loop in a process is inflated), and a median so one congestion spike cannot produce a superlinear
    "efficiency" figure."""
    jax.block_until_ready(fn())            # compile + first run
    for _ in range(warmup):
        jax.block_until_ready(fn())
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


@dataclass(frozen=True)
class CwtCost:
    """Estimated cost of one batched CWT power call."""
    flops: float          # floating-point operations
    hbm_bytes: float      # bytes to/from device memory (spectra in, power out)
    coeff_bytes: float    # size of the (B, F, N) complex coefficient tensor

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def cwt_cost(batch: int, n_freqs: int, n: int,
             analytic: bool = True) -> CwtCost:
    """FLOP / byte model for ``batch`` signals x ``n_freqs`` wavelets x ``n``
    samples.

    FFT flops use the 5 N log2 N convention; the bank multiply and power
    epilogue are elementwise.  ``hbm_bytes`` is the least traffic the call
    needs — spectra in, the bank once, f32 power out — which is what the
    Triton epoch-mean kernel (``ops.power_kernel``) moves; the XLA path
    moves about four passes over ``coeff_bytes`` on top.
    """
    fft = 5.0 * n * math.log2(max(n, 2))
    signal_ffts = batch * fft * (0.5 if analytic else 1.0)
    inverse_ffts = batch * n_freqs * fft
    multiply = batch * n_freqs * n * 6.0
    power = batch * n_freqs * n * 3.0
    coeff = batch * n_freqs * n * 8.0
    spec_bytes = batch * n * 8.0 * (0.5 if analytic else 1.0)
    out_bytes = batch * n_freqs * n * 4.0
    return CwtCost(flops=signal_ffts + inverse_ffts + multiply + power,
                   hbm_bytes=spec_bytes + out_bytes + n_freqs * n * 4.0,
                   coeff_bytes=coeff)


@contextlib.contextmanager
def trace(logdir: str):
    """``jax.profiler`` trace context: view with TensorBoard.

    >>> with trace("/tmp/tb"):          # doctest: +SKIP
    ...     engine.power(sig).block_until_ready()
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Temporarily toggle JAX NaN checking (SURVEY §5: the debug mode this
    build provides instead of sanitizers)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
