"""Float64 numpy oracle reproducing the reference algorithm end-to-end.

This is an *independent transcription of the reference's semantics* (not of
its code): per-frequency Python loop, numpy/scipy FFTs, float64 throughout —
the opposite implementation style from the vectorized float32 jnp engine
under test.  Reference behavior sources are cited per step so parity
failures can be traced back.

The real reference package cannot be imported here (it hard-imports cupy at
module level, ``/root/reference/ninwavelets/base.py:2``), so this oracle is
the executable ground truth for coefficient-parity tests.
"""
from __future__ import annotations

import numpy as np
from scipy.fft import fft, ifft

# ---------------------------------------------------------------------------
# Formula oracles (float64), one per family — wavelets.py:65-74, 132-144,
# 219-228, 256-262, 272-280
# ---------------------------------------------------------------------------


def morse_trans(grid: np.ndarray, freq: float, b: float, r: float) -> np.ndarray:
    w = grid / freq
    step = np.heaviside(w, w)
    return 2.0 * step * np.float_power(w, b) * np.exp((b / r) * (1.0 - np.float_power(w, r)))


def morlet_constants(sigma: float, gabor: bool):
    c = np.float_power(1 + np.exp(-sigma ** 2) - 2 * np.exp(-0.75 * sigma ** 2), -0.5)
    k = 0.0 if gabor else np.exp(-(sigma ** 2) / 2)
    return c, k


def morlet_peak(freq: float, sigma: float) -> float:
    return sigma / (1.0 - np.exp(-sigma * freq))


def morlet_trans(grid: np.ndarray, freq: float, sigma: float, gabor: bool) -> np.ndarray:
    c, k = morlet_constants(sigma, gabor)
    s = grid / freq * morlet_peak(freq, sigma)
    return c * np.pi ** -0.25 * (np.exp(-((sigma - s) ** 2) / 2)
                                 - k * np.exp(-(s ** 2) / 2))


def morlet_time(t: np.ndarray, sigma: float, gabor: bool) -> np.ndarray:
    c, k = morlet_constants(sigma, gabor)
    return c * np.pi ** -0.25 * np.exp(-(t ** 2) / 2) * (np.exp(1j * sigma * t) - k)


def mexican_hat_time(t: np.ndarray, sigma: float) -> np.ndarray:
    return (1 - (t / sigma) ** 2) * np.exp(-(t ** 2) / (sigma ** 2) / 2)


def shannon_trans(grid: np.ndarray) -> np.ndarray:
    return np.where(grid <= 1.0, 1.0, 0.0)


def haar_time(t: np.ndarray) -> np.ndarray:
    out = np.zeros_like(t)
    out[(t > 0) & (t <= 1)] = 1.0
    out[(t > -1) & (t <= 0)] = -1.0
    return out


# ---------------------------------------------------------------------------
# Grid oracles — base.py:173-216
# ---------------------------------------------------------------------------


def trans_grid(sfreq: float, signal_duration: float, halved: bool) -> np.ndarray:
    """``_setup_trans_shape(T, T or T/2)`` as called by ``make_fft_wavelet``
    (base.py:239-246): step 1/T, extent sfreq (or sfreq/2)."""
    extent = sfreq / 2 if halved else sfreq
    return np.arange(0, extent, 1.0 / signal_duration)


def normal_timeline(sfreq: float, freq: float, peak: float) -> np.ndarray:
    """``_setup_waveletshape(freq, 1, zero_mean=True)`` (base.py:212-216).

    In exact arithmetic this is always ``sfreq`` samples; the reference's
    ``np.arange(-total/2, total/2, one)`` occasionally emits one extra sample
    when float64 rounding lands the last step exactly on ``total/2`` (e.g.
    MexicanHat at freq=85, sfreq=1000 -> 1001 samples), which then changes
    the FFT length.  That is a rounding accident, not semantics — both this
    oracle and the engine normalize to exactly ``sfreq`` samples
    (documented deviation).
    """
    total = 1.0 / peak * freq * 2 * np.pi
    one = 1.0 / sfreq * 2 * np.pi * freq / peak
    return np.arange(-total / 2, total / 2, one)[:int(sfreq)]


def reverse_grid(sfreq: float, freq: float, rwl: float) -> np.ndarray:
    """``_setup_trans_shape(freq, rwl)`` as called by ``make_wavelet``
    (base.py:350): step 1/freq, extent sfreq/freq*rwl.

    Exact count is ``sfreq * rwl`` independent of freq; the reference's
    arange occasionally emits one extra sample from float rounding (e.g.
    freq=15 -> 1001).  Normalized here exactly as in ``normal_timeline``
    (documented deviation shared by oracle and engine).
    """
    return np.arange(0, sfreq / freq * rwl, 1.0 / freq)[:int(round(sfreq * rwl))]


# ---------------------------------------------------------------------------
# Engine oracles — base.py:75-123, 221-279, 346-359, 378-407
# ---------------------------------------------------------------------------


def pad_to(w: np.ndarray, n: int) -> np.ndarray:
    if w.shape[0] > n:
        return w[:n]
    a = (n - w.shape[0]) // 2
    return np.pad(w, [a, n - w.shape[0] - a])


def alias(w: np.ndarray) -> np.ndarray:
    half = int(w.shape[0] / 2)
    return np.pad(w[:half], [0, w.shape[0] - half])


FAMILIES = {
    # name -> (mode, trans fn or None, time fn or None, peak fn)
    "morse": ("reverse",
              lambda g, f, p: morse_trans(g, f, p.get("b", 17.5), p.get("r", 3.0)),
              None, lambda f, p: 1.0),
    "morlet": ("both",
               lambda g, f, p: morlet_trans(g, f, p.get("sigma", 7.0), p.get("gabor", False)),
               lambda t, f, p: morlet_time(t, p.get("sigma", 7.0), p.get("gabor", False)),
               lambda f, p: morlet_peak(f, p.get("sigma", 7.0))),
    "shannon": ("reverse", lambda g, f, p: shannon_trans(g), None,
                lambda f, p: 1.0),
    "mexican_hat": ("normal", None,
                    lambda t, f, p: mexican_hat_time(t, p.get("sigma", 7.0)),
                    lambda f, p: np.sqrt(6) / np.pi / np.pi),
    "haar": ("normal", None, lambda t, f, p: haar_time(t),
             lambda f, p: 1.0),
}


def make_time_wavelet(family: str, freq: float, sfreq: float,
                      rwl: float = 1.0, params=None) -> np.ndarray:
    """Oracle for ``make_wavelet`` (base.py:346-359)."""
    params = params or {}
    mode, trans, timefn, peak = FAMILIES[family]
    if mode == "reverse":
        g = reverse_grid(sfreq, freq, rwl)
        w = ifft(trans(g, 1.0, params))
        L = w.shape[0]
        two_sided = np.hstack((np.conj(np.flip(w)), w))
        return two_sided[L // 2: (L // 2) * 3]
    t = normal_timeline(sfreq, freq, peak(freq, params))
    return timefn(t, freq, params)


def make_fft_wavelet(family: str, freq: float, sfreq: float,
                     signal_duration: float, interpolate: bool,
                     rwl_cfg: float = 1.0, params=None) -> np.ndarray:
    """Oracle for ``make_fft_wavelet`` (base.py:221-256)."""
    params = params or {}
    mode, trans, timefn, peak = FAMILIES[family]
    if mode in ("reverse", "both"):
        if interpolate:
            g = trans_grid(sfreq, signal_duration, halved=True)
            return np.hstack((trans(g, freq, params), np.zeros(len(g))))
        g = trans_grid(sfreq, signal_duration, halved=False)
        return trans(g, freq, params)
    # Normal/Twice path: time wavelet, center pad to sfreq*rwl_cfg, FFT,
    # abs of parts (base.py:249-256)
    w = make_time_wavelet(family, freq, sfreq, rwl_cfg, params)
    half = int((sfreq * rwl_cfg - w.shape[0]) / 2)
    w = np.hstack((np.zeros(half), w, np.zeros(half)))
    spec = fft(w)
    return np.abs(spec.real) + 1j * np.abs(spec.imag)


def make_bank(family: str, freqs, n: int, sfreq: float, interpolate: bool,
              rwl_cfg: float = 1.0, params=None):
    """Oracle for ``make_fft_wavelets`` + the cwt-time pad loop
    (base.py:258-279, 396-397): returns the (F, n) bank the multiply sees.
    """
    rows = []
    for f in freqs:
        w = make_fft_wavelet(family, float(f), sfreq, n / sfreq, interpolate,
                             rwl_cfg, params)
        if interpolate:
            w = alias(w)
        rows.append(pad_to(w, n))
    return np.array(rows)


def cwt(wave: np.ndarray, family: str, freqs, sfreq: float,
        interpolate: bool, rwl_cfg: float = 1.0, params=None) -> np.ndarray:
    """Oracle for the full CWT path (base.py:378-407), float64."""
    wave = np.asarray(wave, dtype=np.float64)
    n = wave.shape[0]
    bank = make_bank(family, freqs, n, sfreq, interpolate, rwl_cfg, params)
    spec = fft(wave)
    if interpolate:
        spec = alias(spec)
    return ifft(bank * spec)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB between oracle and candidate."""
    ref = np.asarray(ref)
    err = np.asarray(test).astype(ref.dtype) - ref
    p_sig = np.mean(np.abs(ref) ** 2)
    p_err = np.mean(np.abs(err) ** 2)
    if p_err == 0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_err)


# ---------------------------------------------------------------------------
# Epoch reductions — EpochsWavelet (mneutils.py:42-71) and the pairwise
# statistics built from the same per-epoch coefficients, float64.  Each
# takes the (F, N) bank the multiply sees (``make_bank``, or an engine bank
# cast up) so a test can isolate the reduction from the synthesis.
# ---------------------------------------------------------------------------


def epoch_coefficients(signal: np.ndarray, bank: np.ndarray,
                       interpolate: bool) -> np.ndarray:
    """(..., N) signal(s) x (F, N) bank -> (..., F, N) complex128 CWT
    coefficients (base.py:398-406, vectorized over leading axes)."""
    spec = fft(np.asarray(signal, np.float64), axis=-1)
    if interpolate:
        spec[..., int(spec.shape[-1] / 2):] = 0.0        # ``alias``
    return ifft(np.asarray(bank, np.complex128) * spec[..., None, :],
                axis=-1)


def _epoch_mean(signals, bank, interpolate, per_epoch):
    """Mean over the leading (epoch) axis of ``per_epoch(coefficients)``,
    one epoch at a time so memory stays one epoch's coefficients."""
    total = 0.0
    for sig in np.asarray(signals):
        total = total + per_epoch(epoch_coefficients(sig, bank, interpolate))
    return total / len(signals)


def mean_power(signals, bank, interpolate: bool) -> np.ndarray:
    """``EpochsWavelet.power``: mean over epochs of |cwt|^2."""
    return _epoch_mean(signals, bank, interpolate, lambda c: np.abs(c) ** 2)


def itc(signals, bank, interpolate: bool) -> np.ndarray:
    """``EpochsWavelet.itc``: |mean over epochs of cwt / |cwt||."""
    return np.abs(_epoch_mean(signals, bank, interpolate,
                              lambda c: c / np.abs(c)))


def _pair_mean(sigs_a, sigs_b, bank, interpolate, per_epoch):
    total = 0.0
    for sa, sb in zip(np.asarray(sigs_a), np.asarray(sigs_b)):
        total = total + per_epoch(epoch_coefficients(sa, bank, interpolate),
                                  epoch_coefficients(sb, bank, interpolate))
    return total / len(sigs_a)


def coherence(sigs_a, sigs_b, bank, interpolate: bool) -> np.ndarray:
    """|mean Wa conj(Wb)|^2 / (mean |Wa|^2 mean |Wb|^2)."""
    x = _pair_mean(sigs_a, sigs_b, bank, interpolate,
                   lambda a, b: a * np.conj(b))
    pa = mean_power(sigs_a, bank, interpolate)
    pb = mean_power(sigs_b, bank, interpolate)
    return np.abs(x) ** 2 / (pa * pb)


def imcoh(sigs_a, sigs_b, bank, interpolate: bool) -> np.ndarray:
    """Im(mean Wa conj(Wb)) / sqrt(mean |Wa|^2 mean |Wb|^2)."""
    x = _pair_mean(sigs_a, sigs_b, bank, interpolate,
                   lambda a, b: a * np.conj(b))
    pa = mean_power(sigs_a, bank, interpolate)
    pb = mean_power(sigs_b, bank, interpolate)
    return x.imag / np.sqrt(pa * pb)


def _unit_cross(a, b):
    x = a * np.conj(b)
    return x / np.abs(x)


def plv(sigs_a, sigs_b, bank, interpolate: bool) -> np.ndarray:
    """|mean over epochs of exp(i (phi_a - phi_b))|."""
    return np.abs(_pair_mean(sigs_a, sigs_b, bank, interpolate,
                             _unit_cross))


def ppc(sigs_a, sigs_b, bank, interpolate: bool) -> np.ndarray:
    """Pairwise phase consistency: mean cosine of the phase difference
    over all distinct epoch pairs, (|sum u|^2 - E) / (E (E - 1))."""
    e = len(sigs_a)
    s = e * _pair_mean(sigs_a, sigs_b, bank, interpolate, _unit_cross)
    return (np.abs(s) ** 2 - e) / (e * (e - 1.0))


def phase_lag(sigs_a, sigs_b, bank, interpolate: bool,
              method: str) -> np.ndarray:
    """PLI, wPLI or debiased wPLI^2 of Im(Wa conj(Wb)) over epochs."""
    ims = [(epoch_coefficients(sa, bank, interpolate)
            * np.conj(epoch_coefficients(sb, bank, interpolate))).imag
           for sa, sb in zip(np.asarray(sigs_a), np.asarray(sigs_b))]
    ims = np.stack(ims)
    if method == "pli":
        return np.abs(np.mean(np.sign(ims), axis=0))
    s_im, s_abs = ims.sum(0), np.abs(ims).sum(0)
    if method == "wpli":
        return np.abs(s_im) / s_abs
    s_sq = (ims ** 2).sum(0)
    return (s_im ** 2 - s_sq) / (s_abs ** 2 - s_sq)
