"""High-level distributed transforms: wavelet object in, sharded TFR out.

The lower-level ``sharded_*`` functions take a prebuilt (F, N) bank; these
wrappers accept a ``WaveletBase`` (or ``WaveletDef``) plus frequencies,
build the bank on device, choose the mesh, shard the batch, and dispatch.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.bank import WaveletDef, make_fft_bank_ri
from .mesh import DATA_AXIS, auto_mesh, shard_batch
from .sharded import sharded_itc, sharded_mean_power


def _as_f32(signals):
    """float32 array without forcing a host round trip: an already
    device-resident ``jax.Array`` is cast (or passed through) on device;
    only host inputs go through numpy."""
    if isinstance(signals, jax.Array):
        return signals if signals.dtype == jnp.float32 \
            else signals.astype(jnp.float32)
    return jnp.asarray(signals, jnp.float32)


def _resolve(wavelet):
    """(wdef, interpolate) from a WaveletBase instance or a raw WaveletDef."""
    if isinstance(wavelet, WaveletDef):
        return wavelet, False
    return wavelet._wdef(), bool(getattr(wavelet, "interpolate", False))


def _build(wavelet, freqs, n, sfreq, interpolate):
    """(real, imag-or-None) bank via the jitted float-pair builder."""
    wdef, _ = _resolve(wavelet)
    rwl = float(getattr(wavelet, "real_wave_length", 1.0))
    return make_fft_bank_ri(wdef,
                            jnp.asarray(freqs, jnp.float32),
                            n, float(sfreq), interpolate, rwl)


def distributed_mean_power(signals, wavelet, freqs, sfreq: float,
                           mesh=None, interpolate: Optional[bool] = None
                           ) -> jnp.ndarray:
    """Epoch-mean power TFR of an (E, C, N) batch over a device mesh.

    Epochs are sharded over the mesh ``data`` axis (zero-padded to
    divisibility; the mean is rescaled to the true count), bank rows over
    ``freq``.

    Args:
      signals: (E, C, N) host or device array.
      wavelet: a ``WaveletBase`` instance (its ``interpolate`` is used
        unless overridden) or a raw ``WaveletDef``.
      freqs: analysis frequencies (Hz).
      sfreq: sampling frequency (Hz).
      mesh: a mesh from ``make_mesh``/``auto_mesh`` (default: all devices).
    Returns:
      (C, F, N) float32, sharded over ``freq``.
    """
    _, w_interp = _resolve(wavelet)
    interpolate = w_interp if interpolate is None else interpolate
    if mesh is None:
        mesh = auto_mesh()
    signals = _as_f32(signals)
    e, _, n = signals.shape
    d = mesh.shape[DATA_AXIS]
    pad_e = (-e) % d
    if pad_e:
        signals = jnp.pad(signals, ((0, pad_e), (0, 0), (0, 0)))
    bank_r, bank_i = _build(wavelet, freqs, n, sfreq, interpolate)
    dev = shard_batch(signals, mesh, P(DATA_AXIS))
    out = sharded_mean_power(dev, bank_r, bank_i, mesh=mesh,
                             interpolate=interpolate)
    if pad_e:
        out = out * ((e + pad_e) / e)   # zero epochs add zero power
    return out


def distributed_itc(signals, wavelet, freqs, sfreq: float, mesh=None,
                    interpolate: Optional[bool] = None) -> jnp.ndarray:
    """Inter-trial coherence of an (E, C, N) batch over a device mesh.

    E must be divisible by the mesh ``data`` axis (the unit-phase mean
    cannot be zero-padded — zero coefficients have no phase).
    """
    _, w_interp = _resolve(wavelet)
    interpolate = w_interp if interpolate is None else interpolate
    if mesh is None:
        mesh = auto_mesh()
    signals = _as_f32(signals)
    e, _, n = signals.shape
    d = mesh.shape[DATA_AXIS]
    if e % d:
        raise ValueError(f"epochs ({e}) must divide the data axis ({d}) "
                         "for itc — zero-padding would inject NaN phases")
    bank_r, bank_i = _build(wavelet, freqs, n, sfreq, interpolate)
    dev = shard_batch(signals, mesh, P(DATA_AXIS))
    return sharded_itc(dev, bank_r, bank_i, mesh=mesh,
                       interpolate=interpolate)
