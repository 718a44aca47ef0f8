"""Gradient-based fitting of wavelet analyses (beyond-reference extension).

The whole pipeline is differentiable — bank synthesis w.r.t. the analysis
frequencies, and the epoch-mean power w.r.t. the BANK itself (the analytic
adjoint, ``ops.cwt.mean_power_adjoint_from_bank``).  This
module packages the two optimizations those gradients enable:

* ``fit_frequencies`` — move a frequency grid to maximize the power it
  captures from data (adaptive/pruned filterbanks, peak tracking).
* ``learn_bank`` — learn a free-form (F, N) frequency-domain filterbank
  against any scalar loss on the epoch-mean power TFR (a learnable
  front-end: wavelets as the initialization, gradients from the task).

Both run optax optimizers inside one jitted ``lax.scan`` over steps —
no per-step host round trips.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .bank import WaveletDef, make_fft_bank
from .cwt import mean_power_adjoint_from_bank, mean_power_from_bank

__all__ = ["fit_frequencies", "learn_bank"]


@partial(jax.jit, static_argnames=("wdef", "sfreq", "interpolate", "steps",
                                   "lr", "n"))
def _fit_freqs_jit(signals, freqs0, *, wdef, sfreq, interpolate, steps,
                   lr, n):
    import optax   # lazy: optional dependency, like mne elsewhere
    opt = optax.adam(lr)

    def loss_fn(log_f):
        freqs = jnp.exp(log_f)
        bank = make_fft_bank(wdef, freqs, n, sfreq, interpolate)
        p = mean_power_from_bank(signals, bank, interpolate)
        return -jnp.mean(p)

    def step(carry, _):
        log_f, state = carry
        loss, g = jax.value_and_grad(loss_fn)(log_f)
        updates, state = opt.update(g, state, log_f)
        return (optax.apply_updates(log_f, updates), state), loss

    log_f0 = jnp.log(freqs0)
    (log_f, _), losses = lax.scan(step, (log_f0, opt.init(log_f0)), None,
                                  length=steps)
    return jnp.exp(log_f), losses


def fit_frequencies(signals, wdef: WaveletDef, freqs0, sfreq: float,
                    interpolate: bool = True, steps: int = 100,
                    lr: float = 0.02):
    """Gradient-ascend a frequency grid onto the data's spectral mass.

    Maximizes the mean epoch-mean power captured by a bank synthesized at
    the (strictly positive) frequencies — optimized in LOG space so rows
    move multiplicatively and can never cross zero.  Returns
    ``(fitted_freqs (F,), losses (steps,))``; the whole optimization is
    one compiled program (``lax.scan`` over optax.adam steps).

    Args:
      signals: (E, C, N) or (B, N) float32 epochs/signals.
      wdef: the wavelet definition (``WaveletBase._wdef()``).
      freqs0: (F,) initial frequencies (Hz) — e.g. a coarse uniform grid.
    """
    signals = jnp.asarray(signals)
    freqs0 = jnp.asarray(freqs0, jnp.float32)
    return _fit_freqs_jit(signals, freqs0, wdef=wdef, sfreq=float(sfreq),
                          interpolate=bool(interpolate), steps=int(steps),
                          lr=float(lr), n=int(signals.shape[-1]))


@partial(jax.jit, static_argnames=("loss", "interpolate", "steps", "lr"))
def _learn_bank_jit(signals, bank0_r, bank0_i, target, *, loss,
                    interpolate, steps, lr):
    import optax   # lazy: optional dependency, like mne elsewhere
    opt = optax.adam(lr)

    def power_of(params):
        # Optimization variables are float pairs (the package's program
        # boundary convention); the complex bank is assembled here.
        br, bi = params
        bank = br if bi is None else lax.complex(br, bi)
        return mean_power_adjoint_from_bank(signals, bank, interpolate)

    def loss_fn(params):
        p = power_of(params)
        if loss == "mse":
            return jnp.mean(jnp.square(p - target))
        return -jnp.mean(p)                       # "power"

    def step(carry, _):
        params, state = carry
        val, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state, params)
        return (optax.apply_updates(params, updates), state), val

    params0 = (bank0_r, bank0_i)
    (params, _), losses = lax.scan(step, (params0, opt.init(params0)),
                                   None, length=steps)
    return params, losses


def learn_bank(signals, bank0, target=None, loss: str = "mse",
               interpolate: bool = True, steps: int = 200,
               lr: float = 1e-3, bank0_i=None):
    """Learn a free-form (F, N) frequency-domain filterbank by gradient
    descent on a loss over the epoch-mean power TFR.

    ``loss="mse"`` matches a ``target`` (C, F, N) power plane (distill a
    reference analysis, denoise-by-fitting); ``loss="power"`` maximizes
    captured power (an adaptive front-end).  Each step's gradient comes
    from the analytic adjoint, so memory stays O(C*F*N) whatever the
    epoch count.  A wavelet bank (``make_fft_bank``) is the natural
    ``bank0``.

    A complex (Normal/Twice-mode) initialization is passed as the
    (``bank0``, ``bank0_i``) float pair — complex64 never crosses the
    program boundary — and the learned bank returns as the same pair.

    Returns ``(bank (F, N), losses (steps,))`` for real banks,
    ``((bank_r, bank_i), losses)`` when ``bank0_i`` is given.
    """
    signals = jnp.asarray(signals)
    bank0 = jnp.asarray(bank0)
    if bank0_i is not None:
        bank0_i = jnp.asarray(bank0_i)
    if loss == "mse":
        if target is None:
            raise ValueError('loss="mse" needs a target power plane')
        target = jnp.asarray(target)
    elif loss == "power":
        target = jnp.zeros((), jnp.float32)       # unused placeholder
    else:
        raise ValueError('loss must be "mse" or "power"')
    (br, bi), losses = _learn_bank_jit(
        signals, bank0, bank0_i, target, loss=str(loss),
        interpolate=bool(interpolate), steps=int(steps), lr=float(lr))
    return ((br, bi) if bank0_i is not None else br), losses
