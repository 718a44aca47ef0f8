"""Extension families (Paul, DOG, Bump) and cross-signal ops."""
import jax.numpy as jnp
import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops import extensions as ext
from ninwavelets_tpu.ops.bank import make_fft_bank


SFREQ = 1000.0


@pytest.mark.parametrize("cls,kw", [(nw.Paul, {"m": 4.0}),
                                    (nw.DOG, {"m": 2.0}),
                                    (nw.Bump, {"sigma": 0.6})])
class TestExtensionFamilies:
    def test_spectrum_peaks_at_analysis_freq(self, cls, kw):
        w = cls(SFREQ, **kw)
        grid = jnp.linspace(0.0, 500.0, 4001)
        spec = np.asarray(w.trans_formula(grid, 60.0))
        peak = float(grid[int(np.argmax(spec))])
        assert abs(peak - 60.0) < 1.0
        assert spec.max() == pytest.approx(2.0, rel=1e-3)
        assert spec[0] == 0.0          # analytic: nothing at DC

    def test_cwt_finds_sine(self, cls, kw):
        w = cls(SFREQ, **kw)
        sig = np.sin(2 * np.pi * 60 * np.arange(2000) / SFREQ)
        p = np.asarray(w.power(sig, np.arange(20.0, 101.0, 2.0)))
        found = 20.0 + 2.0 * int(np.argmax(p.mean(-1)))
        assert abs(found - 60.0) <= 2.0

    def test_float32_stability_far_from_peak(self, cls, kw):
        """High grid values (w >> 1) must underflow to 0, not NaN/inf."""
        w = cls(SFREQ, **kw)
        spec = np.asarray(w.trans_formula(jnp.asarray([0.0, 1e4, 5e4]), 1.0))
        assert np.isfinite(spec).all()


class TestCrossOps:
    def _bank(self, n):
        m = nw.Morse(SFREQ)
        return make_fft_bank(m._wdef(), jnp.arange(20.0, 80.0, 5.0), n,
                             SFREQ)

    def test_cross_power_self_is_power(self):
        sig = np.sin(2 * np.pi * 40 * np.arange(1000) / SFREQ).astype(
            np.float32)
        bank = self._bank(1000)
        xr, xi = ext.cross_power_from_bank(jnp.asarray(sig),
                                           jnp.asarray(sig), bank)
        from ninwavelets_tpu.ops.cwt import power_from_bank
        want = np.asarray(power_from_bank(jnp.asarray(sig), bank))
        np.testing.assert_allclose(np.asarray(xr), want, rtol=1e-4,
                                   atol=1e-6)
        assert np.abs(np.asarray(xi)).max() < 1e-5 * want.max()

    def test_coherence_identical_signals_is_one(self):
        rng = np.random.default_rng(0)
        sigs = rng.standard_normal((6, 1000)).astype(np.float32)
        bank = self._bank(1000)
        coh = np.asarray(ext.epoch_coherence_from_bank(
            jnp.asarray(sigs), jnp.asarray(sigs), bank))
        np.testing.assert_allclose(coh, 1.0, atol=1e-3)

    def test_coherence_independent_noise_is_low(self):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((40, 1000)).astype(np.float32)
        b = rng.standard_normal((40, 1000)).astype(np.float32)
        bank = self._bank(1000)
        coh = np.asarray(ext.epoch_coherence_from_bank(
            jnp.asarray(a), jnp.asarray(b), bank))
        # E[coherence] ~ 1/E for independent signals.
        assert np.median(coh) < 0.15
        assert coh.min() >= 0.0 and coh.max() <= 1.0 + 1e-4

    def test_coherent_signal_with_phase_lag(self):
        """A common 40 Hz component with fixed lag -> coherence ~1 at 40 Hz
        with the lag visible in the cross-spectrum phase."""
        rng = np.random.default_rng(1)
        t = np.arange(1000) / SFREQ
        common = np.sin(2 * np.pi * 40 * t)
        lagged = np.sin(2 * np.pi * 40 * (t - 0.005))   # 5 ms lag
        a = (common[None] + 0.5 * rng.standard_normal((12, 1000))).astype(
            np.float32)
        b = (lagged[None] + 0.5 * rng.standard_normal((12, 1000))).astype(
            np.float32)
        bank = self._bank(1000)
        coh = np.asarray(ext.epoch_coherence_from_bank(
            jnp.asarray(a), jnp.asarray(b), bank))
        row_40 = 4  # freqs 20,25,...: 40 Hz is index 4
        assert coh[row_40, 200:800].mean() > 0.8
        xr, xi = ext.cross_power_from_bank(jnp.asarray(a[0]),
                                           jnp.asarray(b[0]), bank)
        phase = np.angle(np.asarray(xr)[row_40, 500]
                         + 1j * np.asarray(xi)[row_40, 500])
        # 5 ms at 40 Hz = 0.2 cycles = 1.257 rad lead of a over b.
        assert abs(phase - 2 * np.pi * 40 * 0.005) < 0.35


class TestWaveletCoherence:
    """Single-trial smoothed wavelet coherence (Torrence–Webster)."""

    FREQS = np.arange(20.0, 80.0, 5.0)

    def _bank(self, n):
        m = nw.Morse(SFREQ)
        return make_fft_bank(m._wdef(), jnp.asarray(self.FREQS), n, SFREQ)

    def test_self_coherence_is_one(self):
        rng = np.random.default_rng(0)
        sig = rng.standard_normal(2000).astype(np.float32)
        coh = np.asarray(ext.wavelet_coherence_from_bank(
            jnp.asarray(sig), jnp.asarray(sig), self._bank(2000),
            jnp.asarray(self.FREQS, jnp.float32), SFREQ))
        np.testing.assert_allclose(coh, 1.0, atol=1e-3)

    def test_range_and_independent_noise_is_lower(self):
        rng = np.random.default_rng(1)
        a = rng.standard_normal(4000).astype(np.float32)
        b = rng.standard_normal(4000).astype(np.float32)
        c = (a + 0.3 * rng.standard_normal(4000)).astype(np.float32)
        bank = self._bank(4000)
        fg = jnp.asarray(self.FREQS, jnp.float32)
        ind = np.asarray(ext.wavelet_coherence_from_bank(
            jnp.asarray(a), jnp.asarray(b), bank, fg, SFREQ))
        dep = np.asarray(ext.wavelet_coherence_from_bank(
            jnp.asarray(a), jnp.asarray(c), bank, fg, SFREQ))
        assert ind.min() >= 0.0 and ind.max() <= 1.0 + 1e-4
        m = 500
        assert np.median(dep[:, m:-m]) > 0.9
        assert np.median(ind[:, m:-m]) < 0.6
        assert np.median(dep[:, m:-m]) > np.median(ind[:, m:-m]) + 0.3

    def test_band_limited_coupling_and_phase(self):
        """Signals sharing ONLY a 40 Hz component cohere at 40 Hz, not at
        distant rows; the smoothed phase reads the 5 ms lag."""
        rng = np.random.default_rng(2)
        t = np.arange(4000) / SFREQ
        common = np.sin(2 * np.pi * 40 * t)
        a = (common + 0.7 * rng.standard_normal(4000)).astype(np.float32)
        b = (np.sin(2 * np.pi * 40 * (t - 0.005))
             + 0.7 * rng.standard_normal(4000)).astype(np.float32)
        bank = self._bank(4000)
        fg = jnp.asarray(self.FREQS, jnp.float32)
        coh, phase = ext.wavelet_coherence_from_bank(
            jnp.asarray(a), jnp.asarray(b), bank, fg, SFREQ,
            return_phase=True)
        coh, phase = np.asarray(coh), np.asarray(phase)
        row40 = int(np.argmin(np.abs(self.FREQS - 40.0)))
        row75 = int(np.argmin(np.abs(self.FREQS - 75.0)))
        m = 500
        assert coh[row40, m:-m].mean() > 0.8
        assert coh[row75, m:-m].mean() < coh[row40, m:-m].mean() - 0.25
        want = 2 * np.pi * 40 * 0.005      # a leads b
        got = np.angle(np.exp(1j * phase[row40, m:-m])).mean()
        assert abs(got - want) < 0.35

    def test_jitted_wrapper_and_raw_adapter(self):
        rng = np.random.default_rng(3)
        data = rng.standard_normal((2, 3000)).astype(np.float32)
        data[1] = 0.8 * data[0] + 0.2 * data[1]

        class FakeRaw:
            info = {"sfreq": SFREQ}
            ch_names = ["A", "B"]

            def get_data(self):
                return data

        rw = nw.RawWavelet(FakeRaw(), nw.Morse(SFREQ))
        coh = np.asarray(rw.coherence("A", "B", self.FREQS))
        assert coh.shape == (self.FREQS.size, 3000)
        m = 400
        assert np.median(coh[:, m:-m]) > 0.8
        # jitted wrapper == from_bank path
        bank = self._bank(3000)
        want = np.asarray(ext.wavelet_coherence_from_bank(
            jnp.asarray(data[0]), jnp.asarray(data[1]), bank,
            jnp.asarray(self.FREQS, jnp.float32), SFREQ))
        got = np.asarray(ext.wavelet_coherence(
            jnp.asarray(data[0]), jnp.asarray(data[1]),
            jnp.asarray(np.asarray(bank, np.float32)), self.FREQS, SFREQ))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_complex_bank_family_works(self):
        """Normal-mode (complex-bank) families route through the float-pair
        boundary: MexicanHat coherence of a shared signal stays high."""
        rng = np.random.default_rng(4)
        a = rng.standard_normal(2000).astype(np.float32)
        b = (a + 0.3 * rng.standard_normal(2000)).astype(np.float32)
        w = nw.MexicanHat(SFREQ)
        from ninwavelets_tpu.ops.bank import make_fft_bank_ri
        freqs = np.arange(25.0, 60.0, 5.0, dtype=np.float32)
        br, bi = make_fft_bank_ri(w._wdef(), freqs, 2000, SFREQ,
                                  w.interpolate, w.real_wave_length)
        coh = np.asarray(ext.wavelet_coherence(
            jnp.asarray(a), jnp.asarray(b), br, freqs, SFREQ, bank_i=bi))
        m = 300
        assert np.median(coh[:, m:-m]) > 0.7
        assert coh.max() <= 1.0 + 1e-4


class TestBicoherence:
    """Quadratic phase coupling: only the phase-SUM relation lights up."""

    SFREQ = 1000.0

    def _epochs(self, coupled: bool, e=12, n=2048, seed=0):
        """20 + 35 Hz with random per-epoch phases, plus a 55 Hz component
        whose phase is their SUM (coupled) or independent (uncoupled)."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / self.SFREQ
        out = np.empty((e, n), np.float32)
        for i in range(e):
            p1, p2 = rng.uniform(0, 2 * np.pi, 2)
            p3 = (p1 + p2) if coupled else rng.uniform(0, 2 * np.pi)
            out[i] = (np.cos(2 * np.pi * 20 * t + p1)
                      + np.cos(2 * np.pi * 35 * t + p2)
                      + 0.7 * np.cos(2 * np.pi * 55 * t + p3)
                      + 0.1 * rng.standard_normal(n))
        return out

    def test_coupled_high_uncoupled_low(self):
        from ninwavelets_tpu.ops.bank import make_fft_bank
        from ninwavelets_tpu.ops.extensions import bicoherence
        morse = nw.Morse(self.SFREQ)
        f1 = np.array([15.0, 20.0, 25.0], np.float32)
        f2 = np.array([30.0, 35.0, 40.0], np.float32)
        sums = (f1[:, None] + f2[None, :]).ravel()
        n = 2048

        def bank(fr):
            return jnp.asarray(np.asarray(make_fft_bank(
                morse._wdef(), jnp.asarray(fr, jnp.float32), n, self.SFREQ,
                True), np.float32))

        b1, b2, b12 = bank(f1), bank(f2), bank(sums)
        bc = np.asarray(bicoherence(
            jnp.asarray(self._epochs(True)[:, None, :]), b1, b2, b12,
            interpolate=True))[0]
        assert bc.shape == (3, 3)
        assert bc.min() >= 0.0 and bc.max() <= 1.0 + 1e-4
        assert bc[1, 1] > 0.8                  # (20, 35) -> 55 coupled
        bc0 = np.asarray(bicoherence(
            jnp.asarray(self._epochs(False, seed=4)[:, None, :]), b1, b2,
            b12, interpolate=True))[0]
        assert bc0[1, 1] < 0.3
        assert bc[1, 1] > bc0[1, 1] + 0.5

    def test_adapter_and_nyquist_guard(self):
        from tests.test_epochs import FakeEpochs
        data = self._epochs(True, e=8)[:, None, :]
        ew = nw.EpochsWavelet(FakeEpochs(data, self.SFREQ),
                              nw.Morse(self.SFREQ))
        bc = np.asarray(ew.bicoherence("EEG 000", [15.0, 20.0, 25.0],
                                       [30.0, 35.0, 40.0]))
        assert bc.shape == (3, 3)
        assert bc[1, 1] > 0.8
        # auto-bicoherence default (freqs2 = freqs1)
        auto = np.asarray(ew.bicoherence("EEG 000", [20.0, 35.0]))
        assert auto.shape == (2, 2)
        with pytest.raises(ValueError):
            ew.bicoherence("EEG 000", [300.0], [300.0])


class TestImCoh:
    """Imaginary coherency (Nolte 2004) — the signed volume-conduction-
    robust companion of epoch coherence, off the same four sums."""
    SFREQ = 1000.0
    FREQS = np.arange(20.0, 80.0, 6.0)

    def _bank(self, n):
        import ninwavelets_tpu as nw
        from ninwavelets_tpu.ops.bank import make_fft_bank
        return jnp.asarray(np.asarray(make_fft_bank(
            nw.Morse(self.SFREQ)._wdef(), jnp.asarray(self.FREQS), n,
            self.SFREQ, True), np.float32))

    def _epochs(self, lag_rad, e=20, n=1024, seed=0, noise=0.3):
        rng = np.random.default_rng(seed)
        t = np.arange(n) / self.SFREQ
        pa = rng.uniform(0, 2 * np.pi, e)
        a = (np.sin(2 * np.pi * 40 * t + pa[:, None])
             + noise * rng.standard_normal((e, n))).astype(np.float32)
        b = (np.sin(2 * np.pi * 40 * t + pa[:, None] + lag_rad)
             + noise * rng.standard_normal((e, n))).astype(np.float32)
        return jnp.asarray(a[:, None]), jnp.asarray(b[:, None])

    def test_oracle_parity_and_bounds(self):
        import jax
        from ninwavelets_tpu.ops.cwt import cwt_from_bank
        from ninwavelets_tpu.ops.extensions import imcoh
        bank = self._bank(1024)
        sa, sb = self._epochs(1.0, e=7)
        w = jax.jit(lambda x: cwt_from_bank(x, bank, True))
        wa = np.asarray(w(sa)).astype(np.complex128)
        wb = np.asarray(w(sb)).astype(np.complex128)
        num = (wa * np.conj(wb)).mean(0).imag
        den = np.sqrt((np.abs(wa) ** 2).mean(0) * (np.abs(wb) ** 2).mean(0))
        want = num / np.maximum(den, 1e-12 * den.max())
        got = np.asarray(imcoh(sa, sb, bank, interpolate=True))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert np.all(np.abs(got) <= 1 + 1e-5)

    def test_zero_lag_blind_lag_signed(self):
        from ninwavelets_tpu.ops.extensions import epoch_coherence, imcoh
        bank = self._bank(1024)
        row = int(np.argmin(np.abs(self.FREQS - 40.0)))
        m = 200
        sa, sb = self._epochs(0.0, e=24)            # common source
        coh = np.asarray(epoch_coherence(sa, sb, bank,
                                         interpolate=True))[0]
        ic = np.asarray(imcoh(sa, sb, bank, interpolate=True))[0]
        assert coh[row, m:-m].mean() > 0.8          # coherence fooled
        assert np.abs(ic[row, m:-m]).mean() < 0.3   # imcoh is not
        # +lag and -lag flip the sign
        sa, sb = self._epochs(+1.0, e=24, seed=1)
        up = np.asarray(imcoh(sa, sb, bank, interpolate=True))[0]
        sa, sb = self._epochs(-1.0, e=24, seed=1)
        dn = np.asarray(imcoh(sa, sb, bank, interpolate=True))[0]
        assert up[row, m:-m].mean() < -0.5 or up[row, m:-m].mean() > 0.5
        assert np.sign(up[row, m:-m].mean()) == -np.sign(dn[row,
                                                            m:-m].mean())

    def test_self_is_zero(self):
        from ninwavelets_tpu.ops.extensions import imcoh
        bank = self._bank(1024)
        sa, _ = self._epochs(0.0, e=4)
        got = np.asarray(imcoh(sa, sa, bank, interpolate=True))
        assert np.abs(got).max() < 1e-5

    def test_oracle_and_sharded_match(self):
        """Single-device imcoh against the float64 oracle, and the sharded
        imcoh against the single-device one."""
        import reference_oracle as ro
        from ninwavelets_tpu import parallel as par
        from ninwavelets_tpu.ops.extensions import imcoh
        bank = self._bank(1024)
        sa, sb = self._epochs(0.7, e=8)
        sa = jnp.concatenate([sa, sa * 0.5], axis=1)   # c=2
        sb = jnp.concatenate([sb, jnp.roll(sb, 3, -1)], axis=1)
        want = np.asarray(imcoh(sa, sb, bank, interpolate=True))
        oracle = ro.imcoh(np.asarray(sa), np.asarray(sb), np.asarray(bank),
                          True)
        assert ro.snr_db(oracle, want) >= 90.0
        mesh = par.make_mesh(data=4, freq=2)
        got = np.asarray(par.sharded_imcoh(sa, sb, bank, mesh=mesh,
                                           interpolate=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=5e-6)

    def test_adapter_convenience(self):
        import ninwavelets_tpu as nw
        from tests.test_epochs import FakeEpochs
        sa, sb = self._epochs(np.pi / 3, e=12)
        data = np.concatenate([np.asarray(sa), np.asarray(sb)], axis=1)
        ew = nw.EpochsWavelet(FakeEpochs(data, self.SFREQ),
                              nw.Morse(self.SFREQ))
        row = int(np.argmin(np.abs(self.FREQS - 40.0)))
        ic = np.asarray(ew.imcoh("EEG 000", "EEG 001", self.FREQS))
        assert ic.shape == (self.FREQS.size, 1024)
        assert np.abs(ic[row, 200:-200]).mean() > 0.5


class TestPSI:
    """Phase slope index (Nolte 2008) — directed coupling from the slope
    of the cross-spectral phase across bank rows."""
    SFREQ = 1000.0
    FREQS = np.arange(20.0, 80.0, 4.0)

    def _bank(self, n):
        import ninwavelets_tpu as nw
        from ninwavelets_tpu.ops.bank import make_fft_bank
        return jnp.asarray(np.asarray(make_fft_bank(
            nw.Morse(self.SFREQ)._wdef(), jnp.asarray(self.FREQS), n,
            self.SFREQ, True), np.float32))

    def _pair(self, delay, e=24, n=2048, seed=0):
        """b is a delayed copy of a's band-limited source: a LEADS b."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / self.SFREQ
        a = np.empty((e, 1, n), np.float32)
        b = np.empty((e, 1, n), np.float32)
        for i in range(e):
            src = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
                      for f in (32.0, 40.0, 48.0, 56.0))
            a[i, 0] = src + 0.5 * rng.standard_normal(n)
            b[i, 0] = np.roll(src, delay) + 0.5 * rng.standard_normal(n)
        return jnp.asarray(a), jnp.asarray(b)

    def test_direction_antisymmetry_and_null(self):
        from ninwavelets_tpu.ops.extensions import psi
        bank = self._bank(2048)
        m = 300
        sa, sb = self._pair(8)
        fwd = np.asarray(psi(sa, sb, bank, interpolate=True))[0]
        rev = np.asarray(psi(sb, sa, bank, interpolate=True))[0]
        assert fwd[m:-m].mean() > 0.05                 # a -> b positive
        np.testing.assert_allclose(rev, -fwd, atol=1e-6)   # antisymmetric
        sa, sb = self._pair(0, seed=1)                 # zero lag
        nul = np.asarray(psi(sa, sb, bank, interpolate=True))[0]
        assert abs(nul[m:-m].mean()) < 0.02
        assert np.all(np.abs(fwd) <= 1 + 1e-5)         # normalized form

    def test_band_slice_and_raw(self):
        from ninwavelets_tpu.ops.extensions import psi
        bank = self._bank(2048)
        sa, sb = self._pair(8, seed=2)
        m = 300
        # the sources live in rows ~3..9 (32-56 Hz); a band slice around
        # them keeps the direction, and raw (unnormalized) keeps the sign
        v = np.asarray(psi(sa, sb, bank, band=(2, 11),
                           interpolate=True))[0]
        assert v[m:-m].mean() > 0.05
        raw = np.asarray(psi(sa, sb, bank, band=(2, 11), interpolate=True,
                             normalize=False))[0]
        assert raw[m:-m].mean() > 0.0

    def test_adapter_validates_grid(self):
        import ninwavelets_tpu as nw
        from tests.test_epochs import FakeEpochs
        sa, sb = self._pair(8, e=6)
        data = np.concatenate([np.asarray(sa), np.asarray(sb)], axis=1)
        ew = nw.EpochsWavelet(FakeEpochs(data, self.SFREQ),
                              nw.Morse(self.SFREQ))
        v = np.asarray(ew.psi("EEG 000", "EEG 001", self.FREQS))
        assert v.shape == (2048,)
        assert v[300:-300].mean() > 0.03
        with pytest.raises(ValueError, match="ascending"):
            ew.psi("EEG 000", "EEG 001", [40.0])
        with pytest.raises(ValueError, match="ascending"):
            ew.psi("EEG 000", "EEG 001", [40.0, 30.0])
