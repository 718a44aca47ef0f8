"""Time-scattering transform (beyond-reference extension)."""
import jax.numpy as jnp
import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu.ops.scattering import scattering

SFREQ = 1000.0
N = 4096
STRIDE = 64


def _banks():
    morse = nw.Morse(SFREQ)
    f1 = np.geomspace(20.0, 400.0, 24).astype(np.float32)
    f2 = np.geomspace(2.0, 32.0, 8).astype(np.float32)
    b1 = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(f1), N, SFREQ, True), np.float32))
    b2 = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(f2), N, SFREQ, False), np.float32))
    return f1, f2, b1, b2


def test_shapes_and_nonnegativity():
    f1, f2, b1, b2 = _banks()
    sig = jnp.asarray(np.random.default_rng(0)
                      .standard_normal(N).astype(np.float32))
    s1, s2 = scattering(sig, b1, b2, SFREQ, stride=STRIDE)
    assert s1.shape == (24, N // STRIDE)
    assert s2.shape == (8, 24, N // STRIDE)
    # Smoothed moduli: nonnegative up to lowpass ringing.
    assert float(jnp.min(s1)) > -1e-3 * float(jnp.max(s1))


def test_s1_translation_stability():
    """S1 must be stable to shifts well below the averaging scale: the
    invariance scattering exists to provide."""
    f1, f2, b1, b2 = _banks()
    t = np.arange(N) / SFREQ
    sig = (np.sin(2 * np.pi * 80 * t)
           * np.exp(-0.5 * ((t - 2.0) / 0.4) ** 2)).astype(np.float32)
    shifted = np.roll(sig, 8)                       # 8 samples << stride=64
    s1a, _ = scattering(jnp.asarray(sig), b1, b2, SFREQ, stride=STRIDE)
    s1b, _ = scattering(jnp.asarray(shifted), b1, b2, SFREQ, stride=STRIDE)
    a, b = np.asarray(s1a), np.asarray(s1b)
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel < 0.05, rel
    # ... while the raw modulus of the CWT moves by the full shift.


def test_s2_separates_tone_from_tremolo():
    """A pure 100 Hz tone and the same tone amplitude-modulated at 8 Hz
    have (nearly) the same S1 row but very different S2 energy at the
    8 Hz modulation row — scattering's textbook discrimination."""
    f1, f2, b1, b2 = _banks()
    t = np.arange(N) / SFREQ
    tone = np.sin(2 * np.pi * 100 * t).astype(np.float32)
    trem = (np.sin(2 * np.pi * 100 * t)
            * (1.0 + 0.9 * np.sin(2 * np.pi * 8 * t))).astype(np.float32)
    _, s2_tone = scattering(jnp.asarray(tone), b1, b2, SFREQ, stride=STRIDE)
    _, s2_trem = scattering(jnp.asarray(trem), b1, b2, SFREQ, stride=STRIDE)
    row_f1 = int(np.argmin(np.abs(f1 - 100.0)))
    row_f2 = int(np.argmin(np.abs(f2 - 8.0)))
    m = 8                                           # interior columns
    e_tone = float(np.asarray(s2_tone)[row_f2, row_f1, m:-m].mean())
    e_trem = float(np.asarray(s2_trem)[row_f2, row_f1, m:-m].mean())
    assert e_trem > 5.0 * max(e_tone, 1e-12), (e_tone, e_trem)


def test_batched_signals():
    f1, f2, b1, b2 = _banks()
    sig = jnp.asarray(np.random.default_rng(1)
                      .standard_normal((3, N)).astype(np.float32))
    s1, s2 = scattering(sig, b1, b2, SFREQ, stride=STRIDE)
    assert s1.shape == (3, 24, N // STRIDE)
    assert s2.shape == (3, 8, 24, N // STRIDE)


def test_scattering_matches_oracle():
    """Both scattering orders against a float64 numpy transcription: two
    modulus layers of oracle coefficients, then the FFT-domain Gaussian
    lowpass and stride decimation."""
    import reference_oracle as ro
    f1, f2, b1, b2 = _banks()
    sig = np.random.default_rng(3).standard_normal((2, N)).astype(
        np.float32)
    s1, s2 = scattering(jnp.asarray(sig), b1, b2, SFREQ, stride=STRIDE)

    k = np.arange(N)
    nu = np.where(k < (N + 1) // 2, k, k - N) * (SFREQ / N)
    c = SFREQ / (2.0 * STRIDE) / np.sqrt(2.0 * np.log(2.0))
    phi = np.exp(-0.5 * np.square(nu / c))

    def smooth(u):
        return np.fft.ifft(np.fft.fft(u) * phi).real[..., ::STRIDE]

    u1 = np.abs(ro.epoch_coefficients(sig, np.asarray(b1), True))
    u2 = np.abs(ro.epoch_coefficients(u1, np.asarray(b2), False))
    want1, want2 = smooth(u1), smooth(np.moveaxis(u2, -2, -3))
    assert ro.snr_db(want1, np.asarray(s1)) >= 90.0
    assert ro.snr_db(want2, np.asarray(s2)) >= 90.0


def test_matmul_lowpass_matches_fft_path():
    """The one-matmul smooth+decimate operator is the exact circulant of
    the FFT lowpass: both paths must agree to float32 on S1 and S2
    (the default "auto" resolves to matmul when stride | N)."""
    f1, f2, b1, b2 = _banks()
    sig = jnp.asarray(np.random.default_rng(5)
                      .standard_normal((2, N)).astype(np.float32))
    s1_m, s2_m = scattering(sig, b1, b2, SFREQ, stride=STRIDE,
                            lowpass="matmul")
    s1_f, s2_f = scattering(sig, b1, b2, SFREQ, stride=STRIDE,
                            lowpass="fft")
    for want, got in ((s1_f, s1_m), (s2_f, s2_m)):
        w, g = np.asarray(want), np.asarray(got)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_waveletbase_scattering_convenience():
    """Morse.scattering == ops.scattering with directly built banks; the
    complex-bank families are rejected."""
    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops.bank import make_fft_bank

    morse = nw.Morse(SFREQ)
    f1 = np.geomspace(20.0, 200.0, 12)
    f2 = np.geomspace(2.0, 32.0, 6)
    sig = np.random.default_rng(7).standard_normal(N).astype(np.float32)
    s1, s2 = morse.scattering(sig, f1, f2, stride=STRIDE)
    assert np.asarray(s1).shape == (12, N // STRIDE)
    assert np.asarray(s2).shape == (6, 12, N // STRIDE)
    b1 = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(f1, jnp.float32), N, SFREQ,
        morse.interpolate), np.float32))
    b2 = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(f2, jnp.float32), N, SFREQ, False),
        np.float32))
    w1, w2 = scattering(jnp.asarray(sig), b1, b2, SFREQ, stride=STRIDE,
                        interpolate=morse.interpolate)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(w1), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(w1)).max())
    np.testing.assert_allclose(np.asarray(s2), np.asarray(w2), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(w2)).max())

    with pytest.raises(ValueError, match="analytic"):
        nw.MexicanHat(SFREQ).scattering(sig, f1, f2)
