"""2-D wavelet transforms (ops/dwt2d.py, ops/cwt2d.py) — the reference
roadmap's one unbuilt item (`/root/reference/README.md:524`).

Oracles: the discrete side is cross-checked against the ALREADY-TESTED
1-D ``wavedec`` through separability (on a rank-one image every subband
is an outer product of 1-D coefficient vectors), plus perfect
reconstruction and orthonormal energy conservation.  The continuous
side is checked against a float64 numpy transcription and against
closed-form plane-wave responses.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from ninwavelets_tpu.ops import cwt2d, dwt2d
from ninwavelets_tpu.ops.dwt import wavedec


def _img(h=64, w=64, seed=0):
    return np.random.default_rng(seed).standard_normal((h, w)).astype(
        np.float32)


class TestDWT2:
    def test_perfect_reconstruction(self):
        img = _img()
        coeffs = dwt2d.wavedec2(img, "db4", level=3)
        rec = np.asarray(dwt2d.waverec2(coeffs, "db4"))
        np.testing.assert_allclose(rec, img, atol=2e-5)

    def test_energy_conservation(self):
        img = _img()
        coeffs = dwt2d.wavedec2(img, "db6", level=2)
        e = float((np.asarray(coeffs[0]) ** 2).sum())
        for lh, hl, hh in coeffs[1:]:
            for c in (lh, hl, hh):
                e += float((np.asarray(c) ** 2).sum())
        np.testing.assert_allclose(e, float((img ** 2).sum()), rtol=1e-5)

    def test_separable_oracle_vs_1d(self):
        """On a rank-one image a(y) b(x), LL_J = cA_J(a) (x) cA_J(b) and
        LH_j = cD_j(a) (x) cA_j(b) — the 2-D transform is fully pinned by
        the tested 1-D wavedec."""
        rng = np.random.default_rng(1)
        a = rng.standard_normal(64).astype(np.float32)   # y profile
        b = rng.standard_normal(128).astype(np.float32)  # x profile
        img = np.outer(a, b)
        level = 3
        coeffs = dwt2d.wavedec2(img, "db4", level=level)
        ca = wavedec(a, "db4", level=level)   # (cA_3, cD_3, cD_2, cD_1)
        cb = wavedec(b, "db4", level=level)
        np.testing.assert_allclose(
            np.asarray(coeffs[0]), np.outer(np.asarray(ca[0]),
                                            np.asarray(cb[0])),
            atol=1e-4)
        for i, (lh, hl, hh) in enumerate(coeffs[1:]):
            j = level - i                       # this block's level
            aj = np.asarray(wavedec(a, "db4", level=j)[0])   # cA_j(a)
            bj = np.asarray(wavedec(b, "db4", level=j)[0])   # cA_j(b)
            da = np.asarray(wavedec(a, "db4", level=j)[1])   # cD_j(a)
            db = np.asarray(wavedec(b, "db4", level=j)[1])   # cD_j(b)
            np.testing.assert_allclose(np.asarray(lh), np.outer(da, bj),
                                       atol=1e-4)
            np.testing.assert_allclose(np.asarray(hl), np.outer(aj, db),
                                       atol=1e-4)
            np.testing.assert_allclose(np.asarray(hh), np.outer(da, db),
                                       atol=1e-4)

    def test_batched(self):
        imgs = np.stack([_img(seed=s) for s in range(3)])
        coeffs = dwt2d.wavedec2(imgs, "db2", level=2)
        assert np.asarray(coeffs[0]).shape == (3, 16, 16)
        rec = np.asarray(dwt2d.waverec2(coeffs, "db2"))
        np.testing.assert_allclose(rec, imgs, atol=2e-5)

    def test_single_level_roundtrip(self):
        img = _img(32, 32)
        ll, details = dwt2d.dwt2(img, "db4")
        assert np.asarray(ll).shape == (16, 16)
        rec = np.asarray(dwt2d.idwt2(ll, details, "db4"))
        np.testing.assert_allclose(rec, img, atol=2e-5)

    def test_validation(self):
        with pytest.raises(ValueError):
            dwt2d.wavedec2(_img(48, 64), "db4", level=5)  # 2^5 !| 48
        ll, det = dwt2d.dwt2(_img(32, 32))
        with pytest.raises(ValueError):
            dwt2d.waverec2([ll, (det[0][:4], det[1], det[2])])

    def test_max_level2(self):
        assert dwt2d.max_level2(64, 64, "db4") >= 2
        assert dwt2d.max_level2(64, 8, "db1") <= 3


def _oracle_cwt2(img, freqs, thetas, sigma=1.0, omega0=5.5):
    """Float64 numpy transcription of the directional-Morlet transform."""
    h, w = img.shape
    ky = 2.0 * np.pi * np.fft.fftfreq(h)[:, None]
    kx = 2.0 * np.pi * np.fft.fftfreq(w)[None, :]
    spec = np.fft.fft2(img.astype(np.float64))
    out = np.empty((len(freqs), len(thetas), h, w), np.complex128)
    for i, f in enumerate(freqs):
        s = omega0 / (2.0 * np.pi * f)
        for j, th in enumerate(thetas):
            g = np.exp(-0.5 * sigma ** 2 * (
                (s * kx - omega0 * np.cos(th)) ** 2
                + (s * ky - omega0 * np.sin(th)) ** 2))
            out[i, j] = np.fft.ifft2(spec * g)
    return out


class TestCWT2:
    FREQS = (0.03, 0.06, 0.12, 0.24)
    THETAS = tuple(np.arange(4) * np.pi / 4.0)

    def test_oracle_parity_90db(self):
        img = _img(64, 64, seed=2)
        wr, wi = cwt2d.cwt2(img, self.FREQS, self.THETAS)
        got = np.asarray(wr) + 1j * np.asarray(wi)
        want = _oracle_cwt2(img, self.FREQS, self.THETAS)
        snr = 10 * np.log10(
            (np.abs(want) ** 2).sum()
            / max(float((np.abs(got - want) ** 2).sum()), 1e-300))
        assert snr > 90.0, snr

    def test_plane_wave_localizes(self):
        """A plane wave at (f0, theta0) peaks in the matching
        (frequency, orientation) channel."""
        h = w = 64
        y, x = np.mgrid[0:h, 0:w]
        f0, th0 = 0.12, np.pi / 4.0
        img = np.cos(2 * np.pi * f0 * (x * np.cos(th0)
                                       + y * np.sin(th0))).astype(
            np.float32)
        p = np.asarray(cwt2d.power2d(img, self.FREQS, self.THETAS))
        mean = p.mean(axis=(-2, -1))
        fi, ti = np.unravel_index(mean.argmax(), mean.shape)
        assert self.FREQS[fi] == pytest.approx(f0)
        assert self.THETAS[ti] == pytest.approx(th0)

    def test_batched_and_power_matches_pair(self):
        imgs = np.stack([_img(32, 32, seed=s) for s in range(2)])
        wr, wi = cwt2d.cwt2(imgs, self.FREQS[:2], self.THETAS[:2])
        p = np.asarray(cwt2d.power2d(imgs, self.FREQS[:2],
                                     self.THETAS[:2]))
        assert p.shape == (2, 2, 2, 32, 32)
        np.testing.assert_allclose(
            p, np.asarray(wr) ** 2 + np.asarray(wi) ** 2, atol=1e-6)

    def test_pow2_guard_and_pad(self):
        img = _img(48, 100)
        # the fft oracle path still needs pow2 sizes ...
        with pytest.raises(ValueError):
            cwt2d.cwt2(img, self.FREQS, use_fft=True)
        padded, (h, w) = cwt2d.pow2_pad2(img)
        assert padded.shape == (64, 128) and (h, w) == (48, 100)
        p = np.asarray(cwt2d.power2d(padded, self.FREQS[:1],
                                     self.THETAS[:1]))[..., :h, :w]
        assert p.shape[-2:] == (48, 100)
        # ... the default matmul path takes any size and agrees with the
        # float64 oracle directly on the unpadded image
        got_r, got_i = cwt2d.cwt2(img, self.FREQS[:1], self.THETAS[:1])
        got = np.asarray(got_r) + 1j * np.asarray(got_i)
        want = _oracle_cwt2(img, self.FREQS[:1], self.THETAS[:1])
        snr = 10 * np.log10((np.abs(want) ** 2).sum()
                            / float((np.abs(got - want) ** 2).sum()))
        assert snr > 90.0, snr

    def test_separable_factors_are_device_cached(self):
        """Repeat calls must NOT re-upload the bank factors: the
        device-resident cache is keyed on (config, backend) — a
        per-call ``jnp.asarray(host_cache)`` would re-upload them every
        call."""
        img = _img(32, 32, seed=1)
        cwt2d._SEP_DEV.clear()
        cwt2d.power2d(img, self.FREQS[:2], self.THETAS[:2])
        assert len(cwt2d._SEP_DEV) == 1
        key, val = next(iter(cwt2d._SEP_DEV.items()))
        cwt2d.power2d(img, self.FREQS[:2], self.THETAS[:2])
        assert len(cwt2d._SEP_DEV) == 1
        assert cwt2d._SEP_DEV[key][0] is val[0]   # same device buffer

    def test_fft_and_matmul_paths_agree(self):
        img = _img(64, 64, seed=9)
        a = np.asarray(cwt2d.power2d(img, self.FREQS, self.THETAS))
        b = np.asarray(cwt2d.power2d(img, self.FREQS, self.THETAS,
                                     use_fft=True))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-7)

    def test_freq_validation(self):
        with pytest.raises(ValueError):
            cwt2d.morlet2d_bank([0.7], [0.0], 32, 32)  # beyond Nyquist


def test_adapter_tfr_power2d():
    from ninwavelets_tpu import Morse
    from ninwavelets_tpu.utils.mne_adapter import ArrayEpochs, \
        EpochsWavelet
    sfreq = 250.0
    rng = np.random.default_rng(5)
    t = np.arange(256) / sfreq
    data = (np.sin(2 * np.pi * 20 * t)[None, None, :]
            + 0.1 * rng.standard_normal((3, 1, 256)))
    ew = EpochsWavelet(ArrayEpochs(data, sfreq, ["A"]), Morse(sfreq))
    (p, (fh, fw)) = ew.tfr_power2d("A", np.arange(5.0, 37.0))
    assert np.asarray(p).shape[-2:][0] >= fh
    assert np.isfinite(np.asarray(p)).all()
    # the sustained 20 Hz rhythm is a HORIZONTAL ridge in the TFR: the
    # theta = 0 channel (oscillation along x/time... orientation of the
    # WAVE VECTOR) vs the vertical one must differ strongly
    pm = np.asarray(p).mean(axis=(0, 2, 3))
    assert pm.std() / pm.mean() > 0.05
