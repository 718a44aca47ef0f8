"""The CWT hot path: batched FFT x bank x iFFT, fused post-ops.

Reference hot loop: ``/root/reference/ninwavelets/base.py:378-407`` — one
signal FFT, a broadcast multiply against the (F, N) bank, one batched iFFT.
The reference runs this per signal with host<->GPU copies on every call
(``base.py:398-404``); here the whole thing is a single jitted XLA program
that stays in device memory, batches over arbitrary leading axes, and fuses
the power / ITC / baseline epilogues so the complex coefficient tensor for
a whole epochs batch is never materialized (the reference computes
``np.abs(...)**2`` on host afterwards, ``base.py:409-443``).

Epoch reductions (mean power, inter-trial coherence — the reference's
``EpochsWavelet`` loops, ``mneutils.py:26-71``) stream over the epoch axis
with ``lax.scan`` so peak memory is O(C*F*N), independent of the number of
epochs.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .grids import analytic_mask


def analytic_spectrum(signal: jnp.ndarray, interpolate: bool) -> jnp.ndarray:
    """FFT of the signal, optionally with the negative-frequency half zeroed
    (the reference's ``interpolate_alias`` applied to the signal spectrum,
    ``base.py:399-401``).

    For real signals on the analytic path the masked spectrum is just the
    rFFT's lower bins zero-padded — half the FFT work.
    """
    n = signal.shape[-1]
    if interpolate and not jnp.iscomplexobj(signal):
        half = jnp.fft.rfft(signal)[..., :n // 2]
        pad = [(0, 0)] * (signal.ndim - 1) + [(0, n - n // 2)]
        return jnp.pad(half, pad)
    spec = jnp.fft.fft(signal.astype(jnp.complex64))
    if interpolate:
        spec = spec * analytic_mask(n, jnp.float32)
    return spec


def cwt_from_bank(signal: jnp.ndarray, bank: jnp.ndarray,
                  interpolate: bool = False) -> jnp.ndarray:
    """Continuous wavelet transform of ``signal`` against a prebuilt bank.

    Args:
      signal: (..., N) real or complex.
      bank: (F, N) frequency-domain wavelet bank (real or complex).
      interpolate: zero the signal spectrum above Nyquist (analytic trick).

    Returns:
      (..., F, N) complex64 CWT coefficients — ``ifft(bank * fft(signal))``
      exactly as ``base.py:399-406``.
    """
    if bank.shape[-1] != signal.shape[-1]:
        # A bank synthesized for another length samples the wavelet at
        # the wrong frequency resolution.
        raise ValueError(f"bank length {bank.shape[-1]} != signal length "
                         f"{signal.shape[-1]}")
    spec = analytic_spectrum(signal, interpolate)
    return jnp.fft.ifft(spec[..., None, :] * bank)


def power_from_bank(signal: jnp.ndarray, bank: jnp.ndarray,
                    interpolate: bool = False) -> jnp.ndarray:
    """``|cwt|**2`` fused on device (reference: ``base.py:409-425``)."""
    c = cwt_from_bank(signal, bank, interpolate)
    return jnp.square(c.real) + jnp.square(c.imag)


def abs_from_bank(signal: jnp.ndarray, bank: jnp.ndarray,
                  interpolate: bool = False) -> jnp.ndarray:
    """``|cwt|`` fused on device (reference: ``base.py:427-443``)."""
    return jnp.abs(cwt_from_bank(signal, bank, interpolate))


# ----------------------------------------------------------------------------
# Streaming epoch reductions (EpochsWavelet equivalents, mneutils.py:42-71)
# ----------------------------------------------------------------------------

def _scan_mean(signals: jnp.ndarray, bank: jnp.ndarray, interpolate: bool,
               per_epoch, vma_axes=()):
    """Mean of ``per_epoch(cwt)`` over the leading (epoch) axis via scan —
    O(1) memory in the number of epochs.

    ``vma_axes``: when called inside ``shard_map``, the mesh axis names the
    scan body output varies over — the zero init must be cast to the same
    varying-manual-axes type or the scan carry types mismatch.
    """
    n_epochs = signals.shape[0]

    def step(acc, sig):
        c = cwt_from_bank(sig, bank, interpolate)
        return acc + per_epoch(c), None

    shape = signals.shape[1:-1] + (bank.shape[0], signals.shape[-1])
    init = jnp.zeros(shape, dtype=per_epoch(jnp.zeros((), jnp.complex64)).dtype)
    if vma_axes:
        init = lax.pcast(init, tuple(vma_axes), to="varying")
    total, _ = lax.scan(step, init, signals)
    return total / n_epochs


def _abs2(c):
    return jnp.square(c.real) + jnp.square(c.imag)


def mean_power_from_bank(signals: jnp.ndarray, bank: jnp.ndarray,
                         interpolate: bool = False) -> jnp.ndarray:
    """Epoch-mean power TFR: ``mean_E |cwt|**2``.

    Equivalent of ``EpochsWavelet.power`` (``mneutils.py:42-55``) with the
    Python epoch loop replaced by an on-device scan.

    Args:
      signals: (E, ..., N) — epochs leading, time trailing.
    Returns:
      (..., F, N) float32.
    """
    return _scan_mean(signals, bank, interpolate, _abs2)


def itc_from_bank(signals: jnp.ndarray, bank: jnp.ndarray,
                  interpolate: bool = False,
                  eps: float = 0.0) -> jnp.ndarray:
    """Inter-trial coherence: ``| mean_E (cwt / |cwt|) |``.

    Equivalent of ``EpochsWavelet.itc`` (``mneutils.py:57-71``).  ``eps``
    guards the division for exactly-zero coefficients (the reference would
    emit NaN there; default 0.0 preserves that behavior).
    """
    def unit_phase(c):
        mag = jnp.abs(c)
        if eps:
            mag = jnp.maximum(mag, eps)
        return c / mag

    return jnp.abs(_scan_mean(signals, bank, interpolate, unit_phase))


def power_itc_from_bank(signals: jnp.ndarray, bank: jnp.ndarray,
                        interpolate: bool = False, eps: float = 0.0):
    """Epoch-mean power AND inter-trial coherence in one scan over the
    epochs: each epoch's coefficients are computed once and feed both
    accumulators.  Returns ``(mean_power_from_bank, itc_from_bank)``."""
    n_epochs = signals.shape[0]

    def step(acc, sig):
        c = cwt_from_bank(sig, bank, interpolate)
        mag = jnp.abs(c)
        if eps:
            mag = jnp.maximum(mag, eps)
        return (acc[0] + jnp.square(c.real) + jnp.square(c.imag),
                acc[1] + c / mag), None

    shape = signals.shape[1:-1] + (bank.shape[0], signals.shape[-1])
    init = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.complex64))
    (p, u), _ = lax.scan(step, init, signals)
    return p / n_epochs, jnp.abs(u / n_epochs)


# ----------------------------------------------------------------------------
# Analytic adjoint of the epoch-mean power (the gradient path)
# ----------------------------------------------------------------------------

def _mean_power_adjoint(signals, bank, interpolate: bool, g, conj_bank):
    """Shared body of the real- and complex-bank adjoints below."""
    e = signals.shape[0]
    n = signals.shape[-1]
    scale = 2.0 / e
    mask = analytic_mask(n, jnp.float32) if interpolate else None
    bank_t = jnp.conj(bank) if conj_bank else bank

    def per_epoch(dbank_acc, sig):
        spec = analytic_spectrum(sig, interpolate)           # (C, N)
        x = jnp.fft.ifft(spec[..., None, :] * bank)          # (C, F, N)
        u = jnp.fft.fft(scale * g * x)                       # fft(omega)
        t = jnp.sum(bank_t * u, axis=-2)                     # (C, N)
        if mask is not None:
            t = t * mask
        ds = jnp.real(jnp.fft.ifft(t)).astype(signals.dtype)
        if conj_bank:
            dbank = jnp.sum(jnp.conj(u) * spec[..., None, :], axis=0) / n
        else:
            dbank = jnp.sum(jnp.real(u * jnp.conj(spec[..., None, :])),
                            axis=0) / n                      # sum over C
        return dbank_acc + dbank, ds

    dbank, ds = lax.scan(per_epoch, jnp.zeros_like(bank), signals)
    return ds, dbank


def _mean_power_bwd(signals, bank, interpolate: bool, g):
    """Analytic adjoint of ``mean_power_from_bank`` for a REAL bank.

    Forward per epoch: S = mask*fft(s); x_f = ifft(bank_f * S);
    P += |x|^2 / E.  With cotangent g = dL/dP (real, (C, F, N)):

      omega = (2/E) * g * x                  (adjoint of |.|^2 / E)
      zeta  = fft(omega) / N                 (adjoint of ifft)
      dS    = sum_f bank_f * zeta_f          (bank is real)
      ds    = N * Re(ifft(mask * dS))        (adjoint of masked fft, s real)
      dbank_f = sum_{e,c} Re(zeta_f * conj(S))

    Recomputes x per epoch under a scan, so memory is O(C*F*N) whatever
    E is; autodiff of the forward scan stores per-epoch residuals,
    O(E*C*F*N).  The reference has no gradients at all.
    """
    return _mean_power_adjoint(signals, bank, interpolate, g, False)


def _mean_power_bwd_complex(signals, bank, interpolate: bool, g):
    """Analytic adjoint of ``mean_power_from_bank`` for a COMPLEX
    (Normal/Twice-mode) bank: the real-bank pipeline above with the two
    conjugations the complex case adds:

      dS    = sum_f conj(bank_f) * zeta_f     (adjoint of bank * S)
      dbank_f = sum_{e,c} conj(zeta_f) * S    (JAX complex-cotangent
                convention: the conjugate of the naive Wirtinger product,
                checked term for term against jax.vjp in the tests)
    """
    return _mean_power_adjoint(signals, bank, interpolate, g, True)


def _kernel_or_xla_mean_power(signals, bank, interpolate: bool,
                              vma_axes=()):
    """``mean_power_from_bank``, computed by the Triton kernel
    (``ops.power_kernel``) when the program is compiled for a CUDA device
    and the workload fits the kernel; by the XLA scan otherwise.  The
    kernel has no autodiff rule: differentiate through
    ``mean_power_adjoint_from_bank``.  ``vma_axes`` as in ``_scan_mean``."""
    from . import power_kernel

    def xla(s, b):
        return _scan_mean(s, b, interpolate, _abs2, vma_axes)

    def kernel(s, b):
        return power_kernel.mean_power(s, b, vma_axes=vma_axes)

    if not power_kernel.supports(signals.shape, signals.dtype, bank,
                                 interpolate):
        return xla(signals, bank)
    return lax.platform_dependent(signals, bank, cuda=kernel, default=xla)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _mean_power_with_adjoint(signals, bank, interpolate):
    return _kernel_or_xla_mean_power(signals, bank, interpolate)


def _mean_power_adjoint_fwd(signals, bank, interpolate):
    return (_kernel_or_xla_mean_power(signals, bank, interpolate),
            (signals, bank))


def _mean_power_adjoint_bwd(interpolate, res, g):
    signals, bank = res
    if jnp.iscomplexobj(bank):
        return _mean_power_bwd_complex(signals, bank, interpolate, g)
    return _mean_power_bwd(signals, bank, interpolate, g)


_mean_power_with_adjoint.defvjp(_mean_power_adjoint_fwd,
                                _mean_power_adjoint_bwd)


def mean_power_adjoint_from_bank(signals: jnp.ndarray, bank: jnp.ndarray,
                                 interpolate: bool = False) -> jnp.ndarray:
    """``mean_power_from_bank`` whose reverse-mode gradient is the analytic
    adjoint (``_mean_power_bwd`` / ``_mean_power_bwd_complex``) instead of
    autodiff through the epoch scan: the backward recomputes the
    coefficients per epoch and keeps no per-epoch residuals.  The forward
    runs the Triton kernel where it applies (``_kernel_or_xla_mean_power``).
    Use it for training loops over the TFR (``ops.fit``, ``bench.py`` grad
    mode).  The adjoint is derived for real signals, so complex signals
    take plain autodiff; like any custom VJP it has no forward mode
    (``jax.jvp``) — use ``mean_power_from_bank`` for that."""
    if jnp.iscomplexobj(signals):
        return mean_power_from_bank(signals, bank, interpolate)
    return _mean_power_with_adjoint(signals, bank, interpolate)


# ----------------------------------------------------------------------------
# Float-pair program boundaries
#
# Every jitted entry point below takes the bank as a (real, imag-or-None)
# float pair and returns floats; complex exists only inside the XLA
# program.  The analytic families (Morse, Morlet, Shannon) have real banks,
# so they pass no imaginary plane at all, and one signature serves both
# bank kinds.  ``_as_bank`` / ``_as_signal`` rebuild the complex view on the
# traced side.
# ----------------------------------------------------------------------------


def _as_bank(bank_r: jnp.ndarray, bank_i: Optional[jnp.ndarray]):
    if bank_i is None:
        return bank_r
    return lax.complex(bank_r, bank_i)


def _as_signal(sig_r: jnp.ndarray, sig_i: Optional[jnp.ndarray]):
    if sig_i is None:
        return sig_r
    return lax.complex(sig_r, sig_i)


@partial(jax.jit, static_argnames=("interpolate",))
def cwt_ri(signal_r, bank_r, bank_i=None, signal_i=None,
           interpolate: bool = False):
    """CWT with float-only boundaries: returns ``(real, imag)`` float32."""
    c = cwt_from_bank(_as_signal(signal_r, signal_i),
                      _as_bank(bank_r, bank_i), interpolate)
    return c.real, c.imag


@partial(jax.jit, static_argnames=("interpolate",))
def power(signal_r, bank_r, bank_i=None, signal_i=None,
          interpolate: bool = False):
    return power_from_bank(_as_signal(signal_r, signal_i),
                           _as_bank(bank_r, bank_i), interpolate)


@partial(jax.jit, static_argnames=("interpolate",))
def cwt_abs(signal_r, bank_r, bank_i=None, signal_i=None,
            interpolate: bool = False):
    return abs_from_bank(_as_signal(signal_r, signal_i),
                         _as_bank(bank_r, bank_i), interpolate)


@partial(jax.jit, static_argnames=("interpolate",))
def mean_power(signal_r, bank_r, bank_i=None, signal_i=None,
               interpolate: bool = False):
    """Epoch-mean power.  Where the Triton kernel applies
    (``ops.power_kernel.supports``) the program offers it to CUDA devices
    and differentiates through the analytic adjoint (reverse mode only);
    every other workload is the XLA scan under plain autodiff."""
    from . import power_kernel
    signals = _as_signal(signal_r, signal_i)
    bank = _as_bank(bank_r, bank_i)
    if power_kernel.supports(signals.shape, signals.dtype, bank,
                             interpolate):
        return _mean_power_with_adjoint(signals, bank, interpolate)
    return mean_power_from_bank(signals, bank, interpolate)


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def itc(signal_r, bank_r, bank_i=None, signal_i=None,
        interpolate: bool = False, eps: float = 0.0):
    return itc_from_bank(_as_signal(signal_r, signal_i),
                         _as_bank(bank_r, bank_i), interpolate, eps)


@partial(jax.jit, static_argnames=("interpolate", "eps"))
def power_itc(signal_r, bank_r, bank_i=None, signal_i=None,
              interpolate: bool = False, eps: float = 0.0):
    return power_itc_from_bank(_as_signal(signal_r, signal_i),
                               _as_bank(bank_r, bank_i), interpolate, eps)


def split_complex(x):
    """Host helper: (real, imag-or-None) float arrays from any array."""
    import numpy as np
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return (jnp.asarray(np.ascontiguousarray(x.real)),
                jnp.asarray(np.ascontiguousarray(x.imag)))
    return jnp.asarray(x), None
