"""Neural-signal simulation: 1/f noise, (bursty / asymmetric)
oscillations, AR(1) — the standard generators for validating every
analysis in this framework on signals with KNOWN ground truth.

No reference counterpart (the reference's only test signal is a plain
sine, ``test.py:17-27``); this mirrors what neurodsp's ``sim`` module
gives its users, rebuilt as shape-static jitted programs keyed
on ``jax.random`` keys, spectral shaping as one rfft/irfft pair, burst
gates as a cycle-level Markov ``lax.scan``.

All outputs are float32, unit variance (except where noted) — scale and
mix with :func:`combine` for a target SNR.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "powerlaw_noise", "ar1_noise", "oscillation", "asym_oscillation",
    "bursty_oscillation", "combine", "iaaft_surrogates",
]


def _key(seed):
    if isinstance(seed, (int, np.integer)):
        return jax.random.PRNGKey(int(seed))
    return seed


@partial(jax.jit, static_argnames=("shape", "exponent", "n_out"))
def _powerlaw_jit(key, *, shape: tuple, exponent: float, n_out: int):
    n = shape[-1]
    white = jax.random.normal(key, shape, jnp.float32)
    spec = jnp.fft.rfft(white)
    f = jnp.arange(n // 2 + 1, dtype=jnp.float32)
    # power ~ f^exponent  ->  amplitude ~ f^(exponent/2); DC stays 0 so
    # the output is exactly mean-free
    gain = jnp.where(f > 0, jnp.power(jnp.maximum(f, 1.0),
                                      exponent / 2.0), 0.0)
    x = jnp.fft.irfft(spec * gain, n=n)[..., :n_out]
    x = x - jnp.mean(x, axis=-1, keepdims=True)
    sd = jnp.std(x, axis=-1, keepdims=True)
    return x / jnp.maximum(sd, 1e-20)


def powerlaw_noise(seed, shape, exponent: float = -2.0) -> jnp.ndarray:
    """Unit-variance noise with power spectrum ``P(f) ~ f**exponent``
    (``exponent=-2`` is brown/1/f^2, ``-1`` pink, ``0`` white).
    ``shape`` is (..., N); ``seed`` an int or a PRNG key.

    Shaping runs on a next-power-of-two grid and crops (the FFT's
    fastest length — see ``parallel.pow2_halo``); mean/variance are re-normalized on the
    cropped window so the output is exactly mean-free, unit-variance
    for any N."""
    shape = tuple(int(s) for s in np.atleast_1d(shape)) \
        if not isinstance(shape, tuple) else shape
    n = int(shape[-1])
    npad = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    return _powerlaw_jit(_key(seed), shape=shape[:-1] + (npad,),
                         exponent=float(exponent), n_out=n)


@partial(jax.jit, static_argnames=("shape", "r"))
def _ar1_jit(key, *, shape: tuple, r: float):
    e = jax.random.normal(key, shape, jnp.float32)

    def step(prev, eps):
        cur = r * prev + eps
        return cur, cur

    _, x = lax.scan(step, jnp.zeros(shape[:-1], jnp.float32),
                    jnp.moveaxis(e, -1, 0))
    x = jnp.moveaxis(x, 0, -1)
    return x * np.sqrt(1.0 - r * r)  # stationary unit variance


def ar1_noise(seed, shape, r: float = 0.7) -> jnp.ndarray:
    """Unit-variance AR(1) (red) noise with lag-1 autocorrelation ``r``
    — the Torrence-Compo null model (``ops.tc_stats``)."""
    if not (-1.0 < r < 1.0):
        raise ValueError("need |r| < 1")
    shape = tuple(int(s) for s in np.atleast_1d(shape)) \
        if not isinstance(shape, tuple) else shape
    return _ar1_jit(_key(seed), shape=shape, r=float(r))


def oscillation(n: int, sfreq: float, freq: float,
                phase: float = 0.0) -> jnp.ndarray:
    """Unit-variance sinusoid: ``sqrt(2) * sin(2 pi f t + phase)``."""
    t = jnp.arange(n, dtype=jnp.float32) / sfreq
    return np.float32(np.sqrt(2.0)) * jnp.sin(
        2.0 * jnp.pi * freq * t + phase)


def asym_oscillation(n: int, sfreq: float, freq: float,
                     rdsym: float = 0.5) -> jnp.ndarray:
    """Nonsinusoidal oscillation with rise-decay asymmetry ``rdsym``
    (fraction of each period spent rising trough->peak; 0.5 is a pure
    sinusoid) — sawtooth-warped phase through a sine, the waveform shape
    ``ops.cycles`` measures as peak-trough/rise-decay symmetry."""
    if not (0.0 < rdsym < 1.0):
        raise ValueError("rdsym must be in (0, 1)")
    t = jnp.arange(n, dtype=jnp.float32) / sfreq
    p = jnp.mod(t * freq, 1.0)          # cycle position, trough at 0
    warped = jnp.where(p < rdsym, 0.5 * p / rdsym,
                       0.5 + 0.5 * (p - rdsym) / (1.0 - rdsym))
    x = jnp.sin(2.0 * jnp.pi * warped - 0.5 * jnp.pi)
    return x / jnp.maximum(jnp.std(x), 1e-20)


@partial(jax.jit, static_argnames=("n", "sfreq", "freq", "enter_prob",
                                   "leave_prob"))
def _bursty_jit(key, *, n: int, sfreq: float, freq: float,
                enter_prob: float, leave_prob: float):
    n_cycles = int(np.ceil(n * freq / sfreq)) + 1
    u = jax.random.uniform(key, (n_cycles,), jnp.float32)

    def step(state, uu):
        nxt = jnp.where(state > 0, (uu > leave_prob).astype(jnp.float32),
                        (uu < enter_prob).astype(jnp.float32))
        return nxt, nxt

    _, gate = lax.scan(step, jnp.float32(0.0), u)
    t = jnp.arange(n, dtype=jnp.float32) / sfreq
    cyc = jnp.minimum((t * freq).astype(jnp.int32), n_cycles - 1)
    x = jnp.sin(2.0 * jnp.pi * freq * t) * gate[cyc]
    return x, gate[cyc]


def bursty_oscillation(seed, n: int, sfreq: float, freq: float,
                       enter_prob: float = 0.2,
                       leave_prob: float = 0.2):
    """Oscillation gated by a CYCLE-level two-state Markov chain
    (probability ``enter_prob`` of starting a burst each silent cycle,
    ``leave_prob`` of ending it each bursting cycle).  Returns
    ``(signal, is_burst)`` — the per-sample ground-truth burst mask for
    validating ``ops.bursts``.  Not variance-normalized (silence is
    real zeros)."""
    if not (0.0 <= enter_prob <= 1.0 and 0.0 <= leave_prob <= 1.0):
        raise ValueError("probabilities must be in [0, 1]")
    return _bursty_jit(_key(seed), n=int(n), sfreq=float(sfreq),
                       freq=float(freq), enter_prob=float(enter_prob),
                       leave_prob=float(leave_prob))


def combine(signal, noise, snr_db: float = 0.0) -> jnp.ndarray:
    """Mix a (unit-variance) signal and noise at ``snr_db`` decibels of
    variance ratio, renormalized to unit variance."""
    a = np.float32(10.0 ** (snr_db / 20.0))
    x = a * jnp.asarray(signal, jnp.float32) \
        + jnp.asarray(noise, jnp.float32)
    return x / jnp.maximum(jnp.std(x, axis=-1, keepdims=True), 1e-20)


@partial(jax.jit, static_argnames=("n_surrogates", "n_iter"))
def _iaaft_jit(key, x, *, n_surrogates, n_iter):
    target_sorted = jnp.sort(x, axis=-1)              # (..., N)
    amp = jnp.abs(jnp.fft.rfft(x))                    # (..., N/2+1)
    n = x.shape[-1]

    def one(k):
        # start from a random shuffle of the original values
        noise = jax.random.normal(k, x.shape)
        order = jnp.argsort(noise, axis=-1)
        s = jnp.take_along_axis(target_sorted, order, axis=-1)

        def step(s, _):
            spec = jnp.fft.rfft(s)
            mag = jnp.maximum(jnp.abs(spec), 1e-30)
            y = jnp.fft.irfft(spec / mag * amp, n=n)  # amplitude step
            ranks = jnp.argsort(jnp.argsort(y, axis=-1), axis=-1)
            return jnp.take_along_axis(target_sorted, ranks,
                                       axis=-1), None  # rank step

        s, _ = lax.scan(step, s, None, length=n_iter)
        return s

    return jax.vmap(one)(jax.random.split(key, n_surrogates))


def iaaft_surrogates(seed, x, n_surrogates: int = 19,
                     n_iter: int = 100) -> jnp.ndarray:
    """IAAFT surrogates (Schreiber & Schmitz 1996): (..., N) ->
    (S, ..., N) series with EXACTLY the original amplitude distribution
    (every iteration ends on a rank remap onto the sorted original
    values) and approximately the original power spectrum — the null
    for nonlinearity tests: linear statistics survive, nonlinear
    structure (waveform asymmetry, phase coupling) is destroyed.

    The default ``n_surrogates=19`` gives a one-sided p = 0.05 rank
    test.  N must be a power of two (the repo-wide FFT-length rule).

    CAVEAT (Schreiber-Schmitz): for strictly PERIODIC signals the
    harmonic amplitude structure is so constraining that the iteration
    can re-lock the phases to a time shift of the original, silently
    PRESERVING nonlinear statistics — the null is meant for stochastic
    (aperiodic) processes; detrend/jitter periodic content first.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"N = {n} must be a power of two (FFT "
                         "length rule); pad or crop first")
    if n_surrogates < 1 or n_iter < 1:
        raise ValueError("n_surrogates and n_iter must be >= 1")
    return _iaaft_jit(_key(seed), x, n_surrogates=int(n_surrogates),
                      n_iter=int(n_iter))
