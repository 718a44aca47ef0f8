"""On-device synthesis of the (F, N) frequency-domain wavelet bank.

The reference builds its bank one frequency at a time in a Python ``map``
(``/root/reference/ninwavelets/base.py:258-279``), padding each entry on the
host.  Here the whole bank is one ``jax.vmap`` over the analysis-frequency
axis — a single fused XLA computation producing the (F, N) array directly in
device memory, which is also what makes sharding the F axis across devices
trivial (each device synthesizes its own slice; recompute beats transfer).

Mode semantics preserved from the reference (``base.py:126-142, 221-256``):

* ``Reverse`` / ``Both``  — evaluate the frequency-domain formula directly on
  the FFT bin grid.  With ``interpolate=True`` only bins below Nyquist are
  evaluated and the top half is zero (``base.py:239-243``).
* ``Normal`` / ``Twice``  — build the time-domain wavelet, center-zero-pad to
  ``sfreq * real_wave_length`` samples, FFT, then take ``abs`` of the real
  and imaginary parts separately (``base.py:250-256`` — a deliberate
  reference quirk that defines coefficient parity for MexicanHat/Haar).
* every bank row is then length-matched to the signal with center-pad /
  head-truncate semantics (``pad_to``, ``base.py:75-82``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .grids import (analytic_mask, fft_bin_freqs, reverse_timeline,
                    wavelet_timeline)
from .signal_utils import pad_last_axis_to


class WaveletMode(enum.Enum):
    """Synthesis-path selector, mirroring the reference enum
    (``base.py:126-142``).
    """
    Normal = 0            # time-domain formula only
    Both = 1              # both formulas (freq-domain used for the bank)
    Reverse = 2           # frequency-domain formula only
    Indifferentiable = 3  # declared by the reference, never used by any class
    Twice = 4             # iFFT'd wavelet re-FFT'd ("ugly and not accurate")


@dataclass(frozen=True, eq=False)
class WaveletDef:
    """A wavelet family = a mode plus up to two pure formulas.

    This is the functional core behind the class-based zoo: the OO layer
    (``ninwavelets_tpu.models``) only assembles one of these and hands it to
    the jitted engine.

    trans_formula(freq_grid, freq) -> spectrum values on the grid
    time_formula(timeline, freq)   -> wavelet samples on the phase timeline
    peak_freq(freq)                -> peak frequency used to scale the
                                      time-domain grid (``base.py:212-218``)
    params: hashable tuple of the hyper-parameters the formulas close over
        (e.g. Morse's (b, r)).  WaveletDef is used as a STATIC jit-cache
        key, and bound methods hash by (function, instance) — without the
        params in the key, mutating ``morse.b`` after the first call would
        silently reuse the compiled program traced with the old value.
        Conversely, the key uses the *underlying* functions (not the bound
        methods), so two instances with identical parameters share one
        compilation.
    """
    mode: WaveletMode
    trans_formula: Optional[Callable] = None
    time_formula: Optional[Callable] = None
    peak_freq: Callable = field(default=lambda freq: 1.0)
    params: tuple = ()

    def _key(self):
        unbind = lambda fn: getattr(fn, "__func__", fn)
        return (self.mode, unbind(self.trans_formula),
                unbind(self.time_formula), unbind(self.peak_freq),
                self.params)

    def __eq__(self, other):
        return (isinstance(other, WaveletDef)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())


def pad_spectrum_to(spec: jnp.ndarray, n: int) -> jnp.ndarray:
    """Reference ``pad_to`` semantics on a spectrum's last axis
    (``base.py:75-82``) — canonical implementation in
    ``ops.signal_utils.pad_last_axis_to``."""
    return pad_last_axis_to(spec, n)


def _freq_domain_row(wdef: WaveletDef, grid: jnp.ndarray, freq,
                     interpolate: bool, n: int) -> jnp.ndarray:
    """One Reverse/Both bank row: formula on the bin grid, upper half zeroed
    when interpolating (``base.py:238-247``).
    """
    row = wdef.trans_formula(grid, freq)
    if interpolate:
        row = row * analytic_mask(n, row.real.dtype)
    return row


def _time_domain_wavelet(wdef: WaveletDef, freq, sfreq: float,
                         real_wave_length: float) -> jnp.ndarray:
    """The reference ``make_wavelet`` (``base.py:346-359``) as a pure fn."""
    if wdef.mode in (WaveletMode.Reverse, WaveletMode.Twice):
        # iFFT the frequency-domain formula on the i/freq grid, then build
        # the two-sided analytic wavelet and slice the central half
        # (base.py:350-355).  NB the reference calls trans_formula with its
        # default freq=1 here — the grid values i/freq already carry freq.
        t = reverse_timeline(sfreq, freq, real_wave_length)
        w = jnp.fft.ifft(wdef.trans_formula(t, 1.0).astype(jnp.complex64))
        length = w.shape[0]
        total = jnp.concatenate([jnp.conj(jnp.flip(w)), w])
        start, stop = length // 2, (length // 2) * 3
        return total[start:stop]
    timeline = wavelet_timeline(sfreq, freq, wdef.peak_freq(freq),
                                real_length=1.0, zero_mean=True)
    return wdef.time_formula(timeline, freq)


def _twice_spectrum(wdef: WaveletDef, freq, sfreq: float,
                    real_wave_length_cfg: float) -> jnp.ndarray:
    """Normal/Twice-mode spectrum: time wavelet -> center pad to
    ``sfreq * real_wave_length`` -> FFT -> abs of real & imag parts
    (``base.py:249-256``).
    """
    w = _time_domain_wavelet(wdef, freq, sfreq, real_wave_length_cfg)
    n0 = int(round(sfreq * real_wave_length_cfg))
    half = int((n0 - w.shape[0]) / 2)
    if half > 0:
        w = jnp.pad(w, [(half, half)])
    elif half < 0:
        w = w[-half:w.shape[0] + half]
    spec = jnp.fft.fft(w.astype(jnp.complex64))
    return jnp.abs(spec.real) + 1j * jnp.abs(spec.imag)


def _twice_mode_row(wdef: WaveletDef, freq, sfreq: float,
                    real_wave_length_cfg: float, interpolate: bool,
                    n: int) -> jnp.ndarray:
    """One Normal/Twice bank row: the Twice spectrum, then the interpolate
    alias mask the reference applies per entry in ``make_fft_wavelets``
    (``base.py:274-276``), then signal-length ``pad_to`` (``base.py:396``).
    """
    spec = _twice_spectrum(wdef, freq, sfreq, real_wave_length_cfg)
    if interpolate:
        spec = spec * analytic_mask(spec.shape[-1], spec.real.dtype)
    return pad_spectrum_to(spec, n)


def make_fft_wavelet(wdef: WaveletDef, freq, sfreq: float,
                     real_length: float = 1.0, interpolate: bool = False,
                     real_wave_length_cfg: float = 1.0) -> jnp.ndarray:
    """One FFT-domain wavelet, exactly as the reference's singular
    ``make_fft_wavelet`` (``base.py:221-256``) returns it — i.e. WITHOUT the
    per-entry alias mask and signal-length ``pad_to`` that only happen later
    in ``make_fft_wavelets`` / ``cwt``.

    Reverse/Both: length ``sfreq * real_length`` (the signal length the bank
    is built for); Normal/Twice: length ``sfreq * real_wave_length_cfg``.
    """
    if wdef.mode in (WaveletMode.Reverse, WaveletMode.Both):
        n = int(round(sfreq * real_length))
        grid = fft_bin_freqs(n, sfreq)
        return _freq_domain_row(wdef, grid, freq, interpolate, n)
    return _twice_spectrum(wdef, freq, sfreq, real_wave_length_cfg)


def make_time_wavelet(wdef: WaveletDef, freq, sfreq: float,
                      real_wave_length: float = 1.0) -> jnp.ndarray:
    """Time-domain wavelet (the reference ``make_wavelet``,
    ``base.py:346-359``) — used for plotting and MNE interop.
    """
    return _time_domain_wavelet(wdef, freq, sfreq, real_wave_length)


def make_fft_bank(wdef: WaveletDef, freqs: jnp.ndarray, n: int, sfreq: float,
                  interpolate: bool = False,
                  real_wave_length_cfg: float = 1.0) -> jnp.ndarray:
    """Synthesize the full (F, n) FFT-domain wavelet bank on device.

    Equivalent of ``make_fft_wavelets`` + the per-call ``pad_to`` loop in
    ``cwt`` (``base.py:258-279, 394-398``) collapsed into one vmapped
    computation.

    Args:
      wdef: the wavelet family definition.
      freqs: (F,) analysis frequencies (device array; traced OK).
      n: signal length in samples (static).
      sfreq: sampling frequency (static).
      interpolate: the reference's analytic / Nyquist-alias trick.
      real_wave_length_cfg: the *constructor* ``real_wave_length`` — the
        Normal/Twice path sizes its FFT by this, NOT by the signal length
        (reference quirk: ``base.py:250-251`` uses ``self.real_wave_length``
        while Reverse/Both use the per-call ``real_length``).

    Returns:
      (F, n) bank.  Real float32 for Reverse/Both families whose formulas are
      real (Morse/Morlet/Shannon) — the CWT multiply then runs real x complex,
      halving bank HBM traffic; complex64 for Normal/Twice families.
    """
    freqs = jnp.asarray(freqs)
    if wdef.mode in (WaveletMode.Reverse, WaveletMode.Both):
        grid = fft_bin_freqs(n, sfreq)
        row = lambda f: _freq_domain_row(wdef, grid, f, interpolate, n)
    else:
        row = lambda f: _twice_mode_row(wdef, f, sfreq, real_wave_length_cfg,
                                        interpolate, n)
    return jax.vmap(row)(freqs)


# ----------------------------------------------------------------------------
# Complex-free jitted boundaries (the package's float-pair convention, see
# ops.cwt; complex math stays inside jit).
# ``WaveletDef`` is a frozen dataclass of bound methods, so it hashes stably
# per wavelet instance and works as a static jit argument without recompiling
# on every call.
# ----------------------------------------------------------------------------


def _ri(x: jnp.ndarray):
    if jnp.iscomplexobj(x):
        return x.real, x.imag
    return x, None


@partial(jax.jit, static_argnames=("wdef", "n", "sfreq", "interpolate",
                                   "real_wave_length_cfg"))
def make_fft_bank_ri(wdef: WaveletDef, freqs, n: int, sfreq: float,
                     interpolate: bool = False,
                     real_wave_length_cfg: float = 1.0):
    """(bank_real, bank_imag-or-None) float32 pair — one compiled program
    synthesizing the whole bank on device."""
    return _ri(make_fft_bank(wdef, freqs, n, sfreq, interpolate,
                             real_wave_length_cfg))


@partial(jax.jit, static_argnames=("wdef", "sfreq", "real_length",
                                   "interpolate", "real_wave_length_cfg"))
def make_fft_wavelet_ri(wdef: WaveletDef, freq, sfreq: float,
                        real_length: float = 1.0, interpolate: bool = False,
                        real_wave_length_cfg: float = 1.0):
    return _ri(make_fft_wavelet(wdef, freq, sfreq, real_length, interpolate,
                                real_wave_length_cfg))


@partial(jax.jit, static_argnames=("wdef", "sfreq", "real_wave_length"))
def make_time_wavelet_ri(wdef: WaveletDef, freq, sfreq: float,
                         real_wave_length: float = 1.0):
    return _ri(make_time_wavelet(wdef, freq, sfreq, real_wave_length))
