"""``WaveletBase`` — the template-method extension contract, on device.

This mirrors the reference's central extensibility pattern
(``/root/reference/ninwavelets/base.py:145-446``, documented at
``README.md:342-434``): a wavelet subclass supplies only *formulas*
(``formula``, ``trans_formula``, ``peak_freq``) plus a ``WaveletMode``; the
base class owns grids, bank synthesis, caching, and the CWT loop.

Differences from the reference, all deliberate:

* formulas are pure jnp functions; the engine vmaps them over the analysis
  frequencies and jits the whole bank+CWT pipeline — there is no per-call
  host<->device copy and no numpy/cupy dual path (the ``cuda`` constructor
  flag is accepted for source compatibility and ignored: XLA owns placement);
* the bank cache (``self.fft_wavelets``) is a single (F, N) device array,
  not a Python list — but the *semantics* match ``base.py:394-397``: with
  ``reuse=True`` a stale bank is length-matched to a new signal by
  center-pad / head-truncate instead of being rebuilt;
* ``cp_trans_formula`` does not exist; there is exactly one formula per
  domain.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import jax.numpy as jnp
import numpy as np

from ..ops import bank as _bank
from ..ops.cwt import cwt_abs as _abs_jit
from ..ops.cwt import cwt_ri as _cwt_jit
from ..ops.cwt import power as _power_jit
from ..ops.cwt import split_complex
from ..ops.bank import WaveletDef, WaveletMode
from ..ops.signal_utils import pad_to


def _assemble(r, i):
    """Host-side complex assembly from a float (real, imag-or-None) pair —
    the only place complex arrays exist outside a compiled program."""
    if i is None:
        return np.asarray(r)
    return np.asarray(r) + 1j * np.asarray(i)

Numbers = Union[Sequence[float], np.ndarray, range, jnp.ndarray]


class WaveletBase:
    """Base class of wavelets.  Subclasses override ``formula`` (time
    domain), ``trans_formula`` (frequency domain) and ``peak_freq`` as pure
    jnp functions, and set ``self.mode``.

    Constructor signature matches the reference (``base.py:153-171``),
    including the ``interpolate=True`` default that the zoo classes override
    to ``False``.
    """

    def __init__(self, sfreq: float = 1000, real_wave_length: float = 1.,
                 interpolate: bool = True, cuda: bool = False) -> None:
        self.mode: WaveletMode = WaveletMode.Normal
        self.sfreq: float = sfreq
        self.help: str = ''
        self.real_wave_length: float = real_wave_length
        self.freq_dist: float = 0.0  # distance between analysis freqs (cwt)
        self.interpolate = interpolate
        # Accepted for reference API compatibility; placement is XLA's job.
        self.cuda = cuda

    # -- subclass hooks ------------------------------------------------------

    def peak_freq(self, freq):
        """Peak frequency used to scale the time-domain grid
        (``base.py:218-219``)."""
        return 1.0

    def formula(self, timeline: jnp.ndarray, freq) -> jnp.ndarray:
        """Time-domain wavelet formula (``base.py:281-301``)."""
        return timeline

    def trans_formula(self, freqs: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        """Frequency-domain wavelet formula (``base.py:303-322``)."""
        return freqs

    # -- engine --------------------------------------------------------------

    def _params(self) -> tuple:
        """Hashable snapshot of the hyper-parameters the formulas read from
        ``self`` — part of the jit-cache key, so runtime mutation
        (``morse.b = 5``) retraces instead of silently reusing the program
        compiled with the old value.  Engine-level knobs that are passed to
        the engine explicitly are excluded.  Array-valued attributes (a
        custom family with, say, a taps vector) are keyed by value bytes so
        mutation cannot silently miss the cache key.
        """
        # 'wavelets' is the reference-parity DERIVED cache of time-domain
        # wavelets (make_wavelets), not a hyper-parameter: keying on it
        # would invalidate every compiled program the moment a user plots
        # (and hash MB-scale arrays on every static-key lookup).
        skip = {"sfreq", "real_wave_length", "freq_dist", "interpolate",
                "cuda", "help", "mode", "wavelets"}
        out = []
        for k, v in sorted(vars(self).items()):
            if k in skip or k.startswith("_"):
                continue
            if isinstance(v, (int, float, bool, str)):
                out.append((k, v))
            elif isinstance(v, (np.ndarray, jnp.ndarray, list, tuple)):
                try:
                    a = np.asarray(v)
                    out.append((k, (a.shape, str(a.dtype), a.tobytes())))
                except (ValueError, TypeError):
                    pass   # ragged/non-numeric container: not a formula knob
        return tuple(out)

    def _wdef(self) -> WaveletDef:
        """Assemble the functional wavelet definition from the bound hooks.
        Read lazily so runtime mode/parameter switches (as the reference
        demo does with ``nin_morlet.mode = WaveletMode.Both``) take effect.
        """
        return WaveletDef(mode=self.mode,
                          trans_formula=self.trans_formula,
                          time_formula=self.formula,
                          peak_freq=self.peak_freq,
                          params=self._params())

    @staticmethod
    def _check_freqs(freqs: Numbers) -> jnp.ndarray:
        arr = jnp.asarray(freqs, jnp.float32)
        if arr.ndim != 1 or arr.shape[0] == 0:
            raise ValueError("freqs must be a non-empty 1-D sequence")
        if np.any(np.asarray(arr) == 0.0):
            # Reference behavior: freq == 0 raises (base.py:234-235).
            raise ZeroDivisionError("analysis frequency 0 is not allowed")
        return arr

    def make_fft_wavelet(self, freq: float,
                         real_length: float = 1.) -> np.ndarray:
        """Single FFT-domain wavelet (``base.py:221-256``).  Returns host
        numpy (real for Reverse/Both families with real formulas, complex
        for the Normal/Twice path), matching the reference's return."""
        if freq == 0:
            raise ZeroDivisionError
        r, i = _bank.make_fft_wavelet_ri(
            self._wdef(), float(freq), self.sfreq, real_length,
            self.interpolate, self.real_wave_length)
        return _assemble(r, i)

    def _build_bank(self, freqs: Numbers, real_wave_length: float) -> None:
        """Build and cache the (F, N) device bank (``base.py:258-279``) as a
        float (real, imag-or-None) pair.  No host transfer happens here —
        the hot paths (cwt/power/abs) keep everything on device."""
        freqs = self._check_freqs(freqs)
        if freqs.shape[0] > 1:
            # Documented deviation: the reference indexes freqs[1]
            # unconditionally (base.py:272) and would IndexError on a
            # single-frequency list; here freq_dist simply keeps its
            # previous value (0.0 initially) for one-element grids.
            self.freq_dist = float(freqs[1] - freqs[0])
        n = int(round(self.sfreq * real_wave_length))
        self._bank_freqs = np.asarray(freqs, np.float32)
        self._bank_r, self._bank_i = _bank.make_fft_bank_ri(
            self._wdef(), freqs, n, self.sfreq, self.interpolate,
            self.real_wave_length)

    @property
    def fft_wavelets(self) -> np.ndarray:
        """Host-numpy view of the cached bank, kept for reference-API parity
        (``self.fft_wavelets``, ``base.py:276-279``).  Assembled lazily on
        first access so the device hot paths never pay the D2H transfer."""
        if not hasattr(self, '_bank_r'):
            raise AttributeError("no bank cached yet — call "
                                 "make_fft_wavelets or cwt first")
        return _assemble(self._bank_r, self._bank_i)

    def make_fft_wavelets(self, freqs: Numbers,
                          real_wave_length: float = 1.) -> np.ndarray:
        """Build + cache the bank and return its host-numpy view
        (``base.py:258-279``; the reference returns a list of arrays — rows
        index the same way)."""
        self._build_bank(freqs, real_wave_length)
        return self.fft_wavelets

    def make_wavelet(self, freq: float) -> np.ndarray:
        """Single time-domain wavelet (``base.py:346-359``), host numpy."""
        if freq == 0:
            raise ZeroDivisionError
        r, i = _bank.make_time_wavelet_ri(self._wdef(), float(freq),
                                          self.sfreq, self.real_wave_length)
        return _assemble(r, i)

    def make_wavelets(self, freqs: Numbers) -> List[np.ndarray]:
        """Time-domain wavelets, one per frequency — list form kept for
        mne-python interop (``base.py:361-376``).
        """
        self.wavelets = [self.make_wavelet(float(f)) for f in np.asarray(freqs)]
        return self.wavelets

    def _bank_for(self, wave_r):
        """The cached device bank, length-matched to the signal by
        center-pad / head-truncate — the reference's stale-bank contract
        (``base.py:394-397``)."""
        bank_r = pad_to(self._bank_r, wave_r)
        bank_i = None if self._bank_i is None else pad_to(self._bank_i, wave_r)
        return bank_r, bank_i

    def _prepare(self, wave, freqs, reuse):
        wave_r, wave_i = split_complex(wave)
        if (not reuse) or (not hasattr(self, '_bank_r')):
            if freqs is None:
                raise ValueError("freqs is required when no bank is cached")
            self._build_bank(freqs, wave_r.shape[-1] / self.sfreq)
        bank_r, bank_i = self._bank_for(wave_r)
        return wave_r, wave_i, bank_r, bank_i

    def cwt(self, wave, freqs: Optional[Numbers] = None,
            reuse: bool = True) -> np.ndarray:
        """Continuous wavelet transform (``base.py:378-407``).

        Accepts (N,) or any (..., N) batch; returns host-numpy complex
        coefficients (as the reference does).  ``reuse=True`` keeps the
        cached bank even if freqs or the signal length changed — the stale
        bank is center-padded / truncated to the new length, exactly the
        reference's (quirky) contract (``base.py:394-397``).  For an
        on-device / inside-jit CWT use ``ninwavelets_tpu.ops.cwt_from_bank``.
        """
        wave_r, wave_i, bank_r, bank_i = self._prepare(wave, freqs, reuse)
        r, i = _cwt_jit(wave_r, bank_r, bank_i, wave_i,
                        interpolate=self.interpolate)
        return _assemble(r, i)

    def power(self, wave, freqs: Optional[Numbers] = None,
              reuse: bool = True) -> jnp.ndarray:
        """``|cwt|**2``, fused on device (``base.py:409-425``).  Returns a
        float32 device array (stays on device for chaining)."""
        wave_r, wave_i, bank_r, bank_i = self._prepare(wave, freqs, reuse)
        return _power_jit(wave_r, bank_r, bank_i, wave_i,
                          interpolate=self.interpolate)

    def abs(self, wave, freqs: Optional[Numbers] = None,
            reuse: bool = True) -> jnp.ndarray:
        """``|cwt|``, fused on device (``base.py:427-443``)."""
        wave_r, wave_i, bank_r, bank_i = self._prepare(wave, freqs, reuse)
        return _abs_jit(wave_r, bank_r, bank_i, wave_i,
                        interpolate=self.interpolate)

    def phase(self, wave, freqs: Optional[Numbers] = None,
              reuse: bool = True) -> np.ndarray:
        """Instantaneous phase ``angle(cwt)`` in radians (extension — the
        reference computes phases only implicitly inside ITC)."""
        c = self.cwt(wave, freqs, reuse)
        return np.angle(c)

    def denoise(self, wave, freqs: Optional[Numbers] = None,
                reuse: bool = True, method: str = "soft",
                threshold_scale: float = 1.0) -> jnp.ndarray:
        """Wavelet-domain denoising (extension — see ``ops.denoise``):
        CWT -> soft/hard shrinkage -> band-limited least-squares inverse.
        The bank should cover the signal band (``ops.coverage``); same
        bank-reuse contract as ``cwt``.  Returns the real (..., N) estimate
        as a float32 device array.
        """
        from ..ops.denoise import denoise as _denoise
        wave_r, wave_i, bank_r, bank_i = self._prepare(wave, freqs, reuse)
        if wave_i is not None:
            raise ValueError("denoise expects a real signal")
        return _denoise(wave_r, bank_r, bank_i,
                        interpolate=self.interpolate, method=method,
                        threshold_scale=threshold_scale)

    def ssq_power(self, wave, freqs: Optional[Numbers] = None,
                  reuse: bool = True,
                  rel_threshold: float = 1e-6) -> jnp.ndarray:
        """Synchrosqueezed power (extension — see ``ops.sst``): scalogram
        energy reassigned to the analysis row nearest each cell's
        instantaneous frequency.  Same bank-reuse contract as ``cwt``;
        requires a real (analytic-family) bank and a monotone freqs grid.
        Returns a float32 device array.
        """
        from ..ops.sst import ssq_power as _ssq
        wave_r, wave_i, bank_r, bank_i = self._prepare(wave, freqs, reuse)
        if bank_i is not None:
            raise ValueError(
                "synchrosqueezing needs an analytic (real-bank) family — "
                "Normal/Twice-mode banks carry no usable phase")
        if wave_i is not None:
            raise ValueError("synchrosqueezing expects a real signal")
        return _ssq(wave_r, bank_r, self._bank_freqs, self.sfreq,
                    interpolate=self.interpolate,
                    rel_threshold=rel_threshold)

    def extract_modes(self, wave, freqs: Optional[Numbers] = None,
                      reuse: bool = True, n_modes: int = 2,
                      penalty: float = 0.5, bw_rows: float = 2.0):
        """Iterative multi-component retrieval (extension — see
        ``ops.ridge.extract_modes``): DP-ridge the dominant component,
        reconstruct it band-limited around the track, subtract, repeat
        ``n_modes`` times.  Same bank-reuse contract as ``cwt``; expects
        a real 1-D signal.  Returns ``(modes (K, N), tracks (K, N) row
        positions, residual (N,))`` float32 device arrays; convert tracks
        to Hz with ``np.interp(track, np.arange(F), freqs)``.
        """
        from ..ops.ridge import extract_modes_ri
        wave_r, wave_i, bank_r, bank_i = self._prepare(wave, freqs, reuse)
        if wave_i is not None:
            raise ValueError("extract_modes expects a real signal")
        if wave_r.ndim != 1:
            raise ValueError("extract_modes takes one (N,) signal — vmap "
                             "for batches")
        return extract_modes_ri(wave_r, bank_r, bank_i, n_modes=n_modes,
                                penalty=penalty, bw_rows=bw_rows,
                                interpolate=self.interpolate)

    def scattering(self, wave, freqs1: Numbers, freqs2: Numbers,
                   stride: int = 32, lowpass: str = "auto"):
        """Order-2 time scattering (extension — see ``ops.scattering``):
        CWT -> modulus -> CWT -> lowpass, returning (S1, S2) translation-
        stable features.  ``freqs1`` are analysis frequencies, ``freqs2``
        MODULATION rates (typically 1-64 Hz).  Banks are built at the
        signal length directly (two banks — the cwt/power cache is not
        touched); requires a real-bank (analytic) family.
        """
        from ..ops import bank as _bank
        from ..ops.scattering import scattering as _scat
        wave_r = jnp.asarray(wave, jnp.float32)
        n = wave_r.shape[-1]

        def build(freqs, analytic):
            br, bi = _bank.make_fft_bank_ri(
                self._wdef(), self._check_freqs(freqs), n, self.sfreq,
                analytic, self.real_wave_length)
            if bi is not None:
                raise ValueError(
                    "scattering needs an analytic (real-bank) family — "
                    "Normal/Twice-mode banks are not meaningful here")
            return br

        # Layer 2 sees the (real, nonnegative) modulus — its spectrum is
        # genuinely two-sided, so no analytic trick there.
        b1 = build(freqs1, self.interpolate)
        b2 = build(freqs2, False)
        return _scat(wave_r, b1, b2, self.sfreq, stride=stride,
                     interpolate=self.interpolate, lowpass=lowpass)

    def plot(self, freq: float, show: bool = True):
        from ..utils.plotting import plot_wavelet
        return plot_wavelet(self, freq, show)
