"""Coefficient-parity tests: the float32 engine vs the float64 oracle
that transcribes the reference algorithm (see ``reference_oracle.py``).

Gate: SNR >= 90 dB on CWT coefficients (float32 round-off through two FFTs
of a ~1000-sample signal lands well above 100 dB; 90 leaves margin), which
is far beyond any physical EEG SNR and corresponds to ~5 significant digits.
"""
import numpy as np
import pytest

import reference_oracle as oracle
from conftest import make_example

import ninwavelets_tpu as nw

SFREQ = 1000.0


def _factory(family, **params):
    if family == "morse":
        return nw.Morse(SFREQ, params.get("b", 17.5), params.get("r", 3.0),
                        interpolate=params.get("interpolate", False))
    if family == "morlet":
        return nw.Morlet(SFREQ, params.get("sigma", 7.0),
                         gabor=params.get("gabor", False),
                         interpolate=params.get("interpolate", False))
    if family == "shannon":
        return nw.Shannon(SFREQ, interpolate=params.get("interpolate", False))
    if family == "mexican_hat":
        return nw.MexicanHat(SFREQ, params.get("sigma", 7.0),
                             interpolate=params.get("interpolate", False))
    if family == "haar":
        return nw.Haar(SFREQ, interpolate=params.get("interpolate", False))
    raise KeyError(family)


@pytest.mark.parametrize("family", ["morse", "morlet", "shannon",
                                    "mexican_hat", "haar"])
@pytest.mark.parametrize("interpolate", [False, True])
def test_cwt_parity_composite_signal(family, interpolate):
    """Full-path CWT coefficients match the reference algorithm on the
    golden composite signal for every family, both alias modes."""
    sin = make_example(1.0)
    freqs = np.arange(1.0, 100.0, 7.0)  # spread across the band, F=15
    w = _factory(family, interpolate=interpolate)
    got = np.asarray(w.cwt(sin, freqs))
    want = oracle.cwt(sin, family, freqs, SFREQ, interpolate)
    assert got.shape == want.shape
    assert oracle.snr_db(want, got) > 90.0, (
        f"{family} interpolate={interpolate}: "
        f"SNR {oracle.snr_db(want, got):.1f} dB")


@pytest.mark.parametrize("gabor", [False, True])
def test_morlet_gabor_parity(gabor):
    sin = make_example(1.0)
    freqs = np.arange(5.0, 95.0, 10.0)
    w = nw.Morlet(SFREQ, 7.0, gabor=gabor)
    got = np.asarray(w.cwt(sin, freqs))
    want = oracle.cwt(sin, "morlet", freqs, SFREQ, False,
                      params={"gabor": gabor})
    assert oracle.snr_db(want, got) > 90.0


def test_power_is_squared_abs():
    sin = make_example(1.0)
    freqs = np.arange(10.0, 60.0, 10.0)
    m = nw.Morse(SFREQ)
    p = np.asarray(m.power(sin, freqs))
    c = np.asarray(m.cwt(sin, freqs))
    np.testing.assert_allclose(p, np.abs(c) ** 2, rtol=2e-5, atol=1e-8)


def test_fft_wavelet_parity_single():
    """The singular ``make_fft_wavelet`` (no alias mask, no pad) matches."""
    for family in ["morse", "morlet"]:
        w = _factory(family)
        got = np.asarray(w.make_fft_wavelet(10.0, real_length=1.0))
        want = oracle.make_fft_wavelet(family, 10.0, SFREQ, 1.0, False)
        assert oracle.snr_db(want, got) > 100.0


def test_time_wavelet_parity():
    """``make_wavelet`` (time-domain synthesis) matches for both the
    Reverse-mode iFFT path and the Normal-mode formula path."""
    for family in ["morse", "morlet", "mexican_hat", "haar", "shannon"]:
        w = _factory(family)
        got = np.asarray(w.make_wavelet(15.0))
        want = oracle.make_time_wavelet(family, 15.0, SFREQ)
        assert got.shape == want.shape, family
        assert oracle.snr_db(want, got) > 80.0, family


def test_stale_bank_reuse_contract():
    """reuse=True keeps a stale bank; the bank is length-matched by
    center-pad/truncate, never rebuilt (reference base.py:394-397)."""
    m = nw.Morse(SFREQ)
    freqs = np.arange(1.0, 50.0, 5.0)
    sin1 = make_example(1.0)
    _ = m.cwt(sin1, freqs)
    bank1 = m.fft_wavelets
    sin2 = make_example(2.0)  # different length
    _ = m.cwt(sin2, freqs)    # freqs ignored, stale bank padded
    # The cached bank is untouched (still the sin1-length bank) —
    # fft_wavelets is a lazily assembled view, so compare by value.
    assert np.array_equal(m.fft_wavelets, bank1)
    # reuse=False rebuilds at the new length
    _ = m.cwt(sin2, freqs, reuse=False)
    assert m.fft_wavelets.shape[-1] == sin2.shape[0]


def test_zero_freq_raises():
    m = nw.Morse(SFREQ)
    with pytest.raises(ZeroDivisionError):
        m.cwt(make_example(1.0), [0.0, 10.0])
    with pytest.raises(ZeroDivisionError):
        m.make_fft_wavelet(0.0)
