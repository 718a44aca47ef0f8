"""The wavelet zoo: Morse, Morlet/Gabor, MorseMNE, MexicanHat, Shannon, Haar.

Mirrors ``/root/reference/ninwavelets/wavelets.py`` class-for-class — same
constructors, same defaults, same modes — with every formula delegated to the
pure functions in ``ninwavelets_tpu.ops.spectra`` so the engine can vmap and
jit them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import spectra
from ..ops.bank import WaveletMode
from .base import Numbers, WaveletBase


class Morse(WaveletBase):
    """Generalized Morse wavelets (reference ``wavelets.py:7-74``).

    Peak-normalized GMW evaluated directly in the frequency domain
    (mode=Reverse): ``2 * H(w) * w**b * exp((b/r) * (1 - w**r))``.

    Parameters
    ----------
    sfreq: sampling frequency (Hz).
    b: beta — time-bandwidth-ish parameter (default 17.5).
    r: gamma — symmetry parameter (default 3, the Airy family).
    """

    def __init__(self, sfreq: float = 1000, b: float = 17.5, r: float = 3,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.r = float(r)
        self.b = float(b)
        self.mode = WaveletMode.Reverse
        self.help = ('Generalized Morse wavelets are defined in the '
                     'frequency domain; the time-domain form shown here is '
                     'their inverse FFT.')

    def trans_formula(self, freqs: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        return spectra.morse_spectrum(freqs, freq, self.b, self.r)


class Morlet(WaveletBase):
    """Morlet (or Gabor, with ``gabor=True``) wavelets (reference
    ``wavelets.py:77-144``), mode=Both: the frequency-domain formula drives
    the CWT bank; the time-domain formula is used for plotting / MNE interop.
    """

    def __init__(self, sfreq: float = 1000, sigma: float = 7.,
                 real_wave_length: float = 1.,
                 gabor: bool = False, interpolate: bool = False,
                 cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.mode = WaveletMode.Both
        self.sigma = float(sigma)
        self.gabor = bool(gabor)
        # Reference-parity constants (wavelets.py:118-122), incl. the
        # exp(-sigma**2) quirk in c — see ops.spectra.morlet_norm_constants.
        self.c, self.k = spectra.morlet_norm_constants(self.sigma, self.gabor)

    def trans_formula(self, freqs: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        return spectra.morlet_spectrum(freqs, freq, self.sigma, self.gabor)

    def formula(self, timeline: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        return spectra.morlet_time(timeline, self.sigma, self.gabor)

    def peak_freq(self, freq):
        return spectra.morlet_peak_freq(freq, self.sigma)


class MorseMNE(Morse):
    """Morse CWT delegated to mne-python's ``tfr.cwt`` using time-domain
    wavelets (reference ``wavelets.py:147-191``).  Deprecated upstream and
    kept only for API parity; requires ``mne`` to be installed.

    Deviation (documented): the reference hardcodes ``range(1, 100)`` and
    ignores its ``freqs`` argument (``wavelets.py:189``) — a bug we fix by
    honoring ``freqs``.
    """

    def cwt(self, wave, freqs: Numbers, use_fft: bool = True,
            mode: str = 'same', decim: float = 1):  # type: ignore[override]
        try:
            from mne.time_frequency import tfr
        except ImportError as e:  # pragma: no cover - mne optional
            raise ImportError(
                "MorseMNE.cwt requires mne-python; install mne or use "
                "Morse.cwt for the native device path") from e
        wavelets = [np.asarray(w) for w in self.make_wavelets(freqs)]
        wave = np.atleast_2d(np.asarray(wave))
        return tfr.cwt(wave, wavelets, use_fft=use_fft, mode=mode,
                       decim=decim).mean(axis=0)


class MexicanHat(WaveletBase):
    """Mexican-hat (Ricker) wavelets (reference ``wavelets.py:194-228``),
    mode=Normal: time-domain only; the bank is its FFT with the reference's
    abs-of-parts quirk.
    """

    def __init__(self, sfreq: float = 1000, sigma: float = 7,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.sigma = float(sigma)
        self.mode = WaveletMode.Normal
        self.help = ''

    def formula(self, tc: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        return spectra.mexican_hat_time(tc, self.sigma)

    def peak_freq(self, freq):
        return spectra.MEXICAN_HAT_PEAK_FREQ


class Shannon(WaveletBase):
    """Shannon wavelets (reference ``wavelets.py:231-262``), mode=Reverse.

    The reference's brick-wall passes *grid values* <= 1 (not physical Hz)
    and ignores the analysis frequency — preserved verbatim for coefficient
    parity (see ``ops.spectra.shannon_spectrum``).
    """

    def __init__(self, sfreq: float = 1000, sigma: float = 7,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.sigma = float(sigma)
        self.mode = WaveletMode.Reverse
        self.help = ''

    def trans_formula(self, tc: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        return spectra.shannon_spectrum(tc, freq)


class Haar(WaveletBase):
    """Haar wavelets (reference ``wavelets.py:265-280``), mode=Normal.
    The reference class has no ``cuda`` parameter; kept that way.
    """

    def __init__(self, sfreq: float = 1000,
                 real_wave_length: float = 1.,
                 interpolate: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate)
        self.mode = WaveletMode.Normal

    def formula(self, timeline: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        return spectra.haar_time(timeline)


class Paul(WaveletBase):
    """Paul wavelet of order m (extension — no reference counterpart).

    Strong time resolution, broad in frequency; mode=Reverse with the
    engine's peak-normalized analytic convention
    (``ops.extensions.paul_spectrum``).
    """

    def __init__(self, sfreq: float = 1000, m: float = 4.0,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.m = float(m)
        self.mode = WaveletMode.Reverse

    def trans_formula(self, freqs: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        from ..ops.extensions import paul_spectrum
        return paul_spectrum(freqs, freq, self.m)


class DOG(WaveletBase):
    """Analytic derivative-of-Gaussian wavelet of order m (extension).

    ``m = 2`` is the analytic counterpart of :class:`MexicanHat` — same
    envelope, but computed on the Reverse path (no Twice-mode quirks).
    """

    def __init__(self, sfreq: float = 1000, m: float = 2.0,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.m = float(m)
        self.mode = WaveletMode.Reverse

    def trans_formula(self, freqs: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        from ..ops.extensions import dog_spectrum
        return dog_spectrum(freqs, freq, self.m)


class Bump(WaveletBase):
    """Bump wavelet (extension): compact frequency support — the sharpest
    frequency resolution in the zoo, at the cost of time resolution.
    """

    def __init__(self, sfreq: float = 1000, sigma: float = 0.6,
                 real_wave_length: float = 1.,
                 interpolate: bool = False, cuda: bool = False) -> None:
        super().__init__(sfreq, real_wave_length, interpolate, cuda)
        self.sigma = float(sigma)
        self.mode = WaveletMode.Reverse

    def trans_formula(self, freqs: jnp.ndarray, freq=1.0) -> jnp.ndarray:
        from ..ops.extensions import bump_spectrum
        return bump_spectrum(freqs, freq, self.sigma)


class Superlet:
    """Fractional adaptive superlet transform (extension — Moca et al.,
    Nat. Commun. 2021): superresolution power estimation by the weighted
    geometric mean of Morlets with growing cycle counts
    (``ops.superlets``).  Not a :class:`WaveletBase` — a superlet is a
    FAMILY of banks fused multiplicatively, so it composes the engine
    rather than subclassing one wavelet.

    Parameters
    ----------
    sfreq: sampling frequency (Hz).
    sigma: base Morlet sigma (the cycle-count role in this engine's
        Morlet convention); order k uses ``k * sigma``.
    order_min / order_max: the adaptive order range — low analysis
        frequencies use ~``order_min`` members, the top frequency the full
        ``order_max`` (fractional in between).  ``adaptive=False`` uses
        ``order_max`` everywhere.
    """

    def __init__(self, sfreq: float = 1000, sigma: float = 3.0,
                 order_min: int = 1, order_max: int = 8,
                 adaptive: bool = True, interpolate: bool = False) -> None:
        self.sfreq = float(sfreq)
        self.sigma = float(sigma)
        self.order_min = int(order_min)
        self.order_max = int(order_max)
        self.adaptive = bool(adaptive)
        self.interpolate = bool(interpolate)

    def _kw(self):
        return dict(base_sigma=self.sigma, order_min=self.order_min,
                    order_max=self.order_max, adaptive=self.adaptive,
                    interpolate=self.interpolate)

    def power(self, wave, freqs: Numbers) -> jnp.ndarray:
        """(..., F, N) superlet power of ``wave`` at ``freqs``."""
        from ..ops.superlets import superlet_power
        freqs = WaveletBase._check_freqs(freqs)
        return superlet_power(jnp.asarray(wave, jnp.float32),
                              freqs, self.sfreq, **self._kw())

    def mean_power(self, waves, freqs: Numbers) -> jnp.ndarray:
        """(..., F, N) epoch-mean superlet power of (E, ..., N) epochs."""
        from ..ops.superlets import superlet_mean_power
        freqs = WaveletBase._check_freqs(freqs)
        return superlet_mean_power(
            jnp.asarray(waves, jnp.float32), freqs, self.sfreq,
            **self._kw())


class MorseMultitaper:
    """Multitaper Morse spectrogram (extension — Olhede & Walden 2002):
    the mean of the scalograms of the first ``n_tapers`` ORTHOGONAL
    generalized Morse wavelets (``ops.multitaper``), cutting single-trial
    estimator variance ~1/K at near-identical TF concentration.  Not a
    :class:`WaveletBase` — like :class:`Superlet` it composes a FAMILY of
    banks, riding the same fused engine with K·F bank rows.

    Parameters
    ----------
    sfreq: sampling frequency (Hz).
    b, r: the engine's Morse beta/gamma (defaults match ``Morse``; taper
        0 IS the reference Morse, so ``n_tapers=1`` reproduces
        ``Morse(...).power`` exactly).
    n_tapers: how many orthogonal orders to average (3-5 typical).
    """

    def __init__(self, sfreq: float = 1000, b: float = 17.5, r: float = 3,
                 n_tapers: int = 3, interpolate: bool = False) -> None:
        self.sfreq = float(sfreq)
        self.b = float(b)
        self.r = float(r)
        self.n_tapers = int(n_tapers)
        self.interpolate = bool(interpolate)

    def _kw(self):
        return dict(b=self.b, r=self.r, n_tapers=self.n_tapers,
                    interpolate=self.interpolate)

    def power(self, wave, freqs: Numbers) -> jnp.ndarray:
        """(..., F, N) multitaper power of ``wave`` at ``freqs``."""
        from ..ops.multitaper import multitaper_power
        freqs = WaveletBase._check_freqs(freqs)
        return multitaper_power(wave, freqs, self.sfreq, **self._kw())

    def mean_power(self, waves, freqs: Numbers) -> jnp.ndarray:
        """(..., F, N) epoch-mean multitaper power of (E, ..., N) epochs
        (one fused (K·F, N)-bank pass)."""
        from ..ops.multitaper import multitaper_mean_power
        freqs = WaveletBase._check_freqs(freqs)
        return multitaper_mean_power(waves, freqs, self.sfreq, **self._kw())
