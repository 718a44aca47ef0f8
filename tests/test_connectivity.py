"""Phase-locking value and phase-amplitude coupling (beyond-reference
extensions; the reference stops at single-channel TFRs + ITC)."""
import jax.numpy as jnp
import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu import parallel as par
from ninwavelets_tpu.ops.bank import make_fft_bank
import reference_oracle as ro
from ninwavelets_tpu.ops.connectivity import (coherence_matrix, pac, plv,
                                              plv_from_bank, plv_matrix)
from ninwavelets_tpu.ops.extensions import epoch_coherence_from_bank

SFREQ = 1000.0


def _bank(freqs, n, interpolate=True):
    morse = nw.Morse(SFREQ)
    return jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(np.asarray(freqs, np.float32)), n, SFREQ,
        interpolate), np.float32))


class TestPLV:
    FREQS = np.arange(20.0, 80.0, 4.0)

    def _epochs(self, locked: bool, e=24, n=2048, seed=0):
        """Two channels sharing a 40 Hz tone; 'locked' keeps a fixed 60-deg
        lag across epochs, unlocked draws an independent phase per epoch."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SFREQ
        a = np.empty((e, n), np.float32)
        b = np.empty((e, n), np.float32)
        for i in range(e):
            pa = rng.uniform(0, 2 * np.pi)
            pb = pa + (np.pi / 3 if locked else rng.uniform(0, 2 * np.pi))
            a[i] = np.sin(2 * np.pi * 40 * t + pa) + \
                0.3 * rng.standard_normal(n)
            b[i] = np.sin(2 * np.pi * 40 * t + pb) + \
                0.3 * rng.standard_normal(n)
        return jnp.asarray(a[:, None, :]), jnp.asarray(b[:, None, :])

    def test_locked_high_unlocked_low(self):
        bank = _bank(self.FREQS, 2048)
        row = int(np.argmin(np.abs(self.FREQS - 40.0)))
        sa, sb = self._epochs(True)
        v = np.asarray(plv(sa, sb, bank, interpolate=True))[0]
        assert v.shape == (self.FREQS.size, 2048)
        assert v[row, 500:-500].mean() > 0.9
        sa, sb = self._epochs(False, seed=1)
        v = np.asarray(plv(sa, sb, bank, interpolate=True))[0]
        assert v[row, 500:-500].mean() < 0.45   # ~1/sqrt(E) + noise

    def test_self_plv_is_one(self):
        bank = _bank(self.FREQS, 2048)
        sa, _ = self._epochs(True, e=4)
        v = np.asarray(plv(sa, sa, bank, interpolate=True))
        np.testing.assert_allclose(v, 1.0, atol=1e-5)

    def test_sharded_matches_single_device(self):
        mesh = par.make_mesh(data=2, freq=4)
        bank = _bank(self.FREQS[:8], 1024)
        sa, sb = self._epochs(True, e=4, n=1024, seed=2)
        want = np.asarray(plv_from_bank(sa, sb, bank, interpolate=True))
        got = np.asarray(par.sharded_plv(sa, sb, bank, mesh=mesh,
                                         interpolate=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


class TestPAC:
    F_PHASE = np.arange(4.0, 13.0, 1.0)     # 9 low rows
    F_AMP = np.arange(40.0, 100.0, 5.0)     # 12 high rows

    def _coupled(self, coupled: bool, n=8192, seed=0):
        """60 Hz carrier whose envelope follows the 8 Hz phase (coupled) or
        an independent envelope (uncoupled)."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SFREQ
        slow = np.sin(2 * np.pi * 8 * t)
        # Control: same slow + carrier content but a CONSTANT envelope —
        # the amplitude carries no phase information at all.
        env = (1 + slow) if coupled else np.ones_like(t)
        sig = slow + env * np.sin(2 * np.pi * 60 * t) \
            + 0.2 * rng.standard_normal(n)
        return jnp.asarray(sig.astype(np.float32))

    @pytest.mark.parametrize("method", ["mvl", "tort"])
    def test_comodulogram_peaks_at_coupled_pair(self, method):
        bp = _bank(self.F_PHASE, 8192)
        ba = _bank(self.F_AMP, 8192)
        mi = np.asarray(pac(self._coupled(True), bp, ba, interpolate=True,
                            method=method))
        assert mi.shape == (self.F_PHASE.size, self.F_AMP.size)
        assert np.all(mi >= -1e-6) and np.all(mi <= 1 + 1e-6)
        ip, ia = np.unravel_index(np.argmax(mi), mi.shape)
        assert self.F_PHASE[ip] == 8.0
        assert abs(self.F_AMP[ia] - 60.0) <= 10.0

    def test_sharded_matches_single_device(self):
        """Epoch-mean comodulogram: epochs over data, phase rows over
        freq (amp bank replicated) == single-device scan-mean."""
        mesh = par.make_mesh(data=2, freq=4)
        fp = np.arange(4.0, 12.0, 1.0)          # 8 phase rows / freq=4
        n = 2048
        bp = _bank(fp, n)
        ba = _bank(self.F_AMP, n)
        rng = np.random.default_rng(3)
        t = np.arange(n) / SFREQ
        sig = np.empty((4, n), np.float32)
        for i in range(4):
            slow = np.sin(2 * np.pi * 8 * t + rng.uniform(0, 2 * np.pi))
            sig[i] = slow + (1 + slow) * np.sin(2 * np.pi * 60 * t) \
                + 0.2 * rng.standard_normal(n)
        sig = jnp.asarray(sig)
        for method in ("mvl", "tort"):
            want = np.asarray(pac(sig, bp, ba, interpolate=True,
                                  method=method, mean_epochs=True))
            got = np.asarray(par.sharded_pac(sig, bp, ba, mesh=mesh,
                                             interpolate=True,
                                             method=method))
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)

    def test_coupled_beats_shuffled(self):
        bp = _bank(self.F_PHASE, 8192)
        ba = _bank(self.F_AMP, 8192)
        row = int(np.argmin(np.abs(self.F_PHASE - 8.0)))
        col = int(np.argmin(np.abs(self.F_AMP - 60.0)))
        hi = np.asarray(pac(self._coupled(True), bp, ba, interpolate=True,
                            method="tort"))[row, col]
        lo = np.asarray(pac(self._coupled(False, seed=3), bp, ba,
                            interpolate=True, method="tort"))[row, col]
        assert hi > 5 * lo, (hi, lo)

    def test_epoch_mean_matches_loop(self):
        bp = _bank(self.F_PHASE, 2048)
        ba = _bank(self.F_AMP, 2048)
        rng = np.random.default_rng(5)
        sig = jnp.asarray(rng.standard_normal((3, 2, 2048))
                          .astype(np.float32))
        got = np.asarray(pac(sig, bp, ba, method="mvl", mean_epochs=True))
        want = np.mean([np.asarray(pac(sig[i], bp, ba, method="mvl"))
                        for i in range(3)], axis=0)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


class TestPairMatrix:
    """All-pairs (F, C, C) connectivity matrices vs the pairwise
    primitives they batch."""
    FREQS = np.arange(20.0, 60.0, 5.0)      # 8 rows

    def _epochs(self, e=6, c=3, n=1024, seed=0):
        """Channels 0/1 keep a fixed 45-deg lag across epochs; channel 2
        draws an independent phase per epoch (unlocked)."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SFREQ
        sig = np.empty((e, c, n), np.float32)
        for i in range(e):
            base = rng.uniform(0, 2 * np.pi)
            for ch in range(c):
                lag = ch * np.pi / 4 if ch < 2 else rng.uniform(0, 2 * np.pi)
                sig[i, ch] = np.sin(2 * np.pi * 40 * t + base + lag) + \
                    0.3 * rng.standard_normal(n)
        return jnp.asarray(sig)

    def test_plv_matrix_matches_pairwise(self):
        bank = _bank(self.FREQS, 1024)
        sigs = self._epochs()
        m = np.asarray(plv_matrix(sigs, bank, interpolate=True))
        assert m.shape == (self.FREQS.size, 3, 3)
        np.testing.assert_allclose(m, np.swapaxes(m, 1, 2),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m[:, np.arange(3), np.arange(3)], 1.0,
                                   atol=1e-5)
        for a in range(3):
            for b in range(3):
                full = np.asarray(plv_from_bank(
                    sigs[:, a], sigs[:, b], bank, interpolate=True))
                np.testing.assert_allclose(m[:, a, b], full.mean(-1),
                                           rtol=2e-4, atol=1e-5)

    def test_plv_matrix_separates_locked_pair(self):
        bank = _bank(self.FREQS, 1024)
        row = int(np.argmin(np.abs(self.FREQS - 40.0)))
        m = np.asarray(plv_matrix(self._epochs(e=24), bank,
                                  interpolate=True))
        assert m[row, 0, 1] > 0.85
        assert m[row, 0, 2] < 0.5

    def test_coherence_matrix_matches_pairwise(self):
        bank = _bank(self.FREQS, 1024)
        sigs = self._epochs(seed=1)
        m = np.asarray(coherence_matrix(sigs, bank, interpolate=True,
                                        eps=0.0))
        assert m.shape == (self.FREQS.size, 3, 3)
        np.testing.assert_allclose(m[:, np.arange(3), np.arange(3)], 1.0,
                                   rtol=1e-4)
        for a in range(3):
            for b in range(3):
                full = np.asarray(epoch_coherence_from_bank(
                    sigs[:, a], sigs[:, b], bank, True, eps=0.0))
                np.testing.assert_allclose(m[:, a, b], full.mean(-1),
                                           rtol=5e-4, atol=1e-5)

    def test_time_range_windows_the_average(self):
        bank = _bank(self.FREQS, 1024)
        sigs = self._epochs(seed=2)
        m = np.asarray(plv_matrix(sigs, bank, interpolate=True,
                                  time_range=(256, 768)))
        full = np.asarray(plv_from_bank(sigs[:, 0], sigs[:, 1], bank,
                                        interpolate=True))
        np.testing.assert_allclose(m[:, 0, 1], full[:, 256:768].mean(-1),
                                   rtol=2e-4, atol=1e-5)

    def test_sharded_matrices_match_single_device(self):
        mesh = par.make_mesh(data=2, freq=4)
        bank = _bank(self.FREQS, 1024)
        sigs = self._epochs(e=4, seed=3)
        want = np.asarray(plv_matrix(sigs, bank, interpolate=True))
        got = np.asarray(par.sharded_plv_matrix(sigs, bank, mesh=mesh,
                                                interpolate=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
        want = np.asarray(coherence_matrix(sigs, bank, interpolate=True))
        got = np.asarray(par.sharded_coherence_matrix(
            sigs, bank, mesh=mesh, interpolate=True))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


class TestNMPLV:
    """n:m cross-frequency phase locking (Tass-style)."""

    def _harmonic_epochs(self, locked: bool, e=20, n=2048, seed=0):
        """ch a carries 10 Hz with a random phase per epoch; ch b carries
        20 Hz at exactly TWICE that phase (locked) or an independent phase
        (unlocked).  1:1 PLV is ~0 either way — only 2:1 sees the lock."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SFREQ
        a = np.empty((e, n), np.float32)
        b = np.empty((e, n), np.float32)
        for i in range(e):
            pa = rng.uniform(0, 2 * np.pi)
            pb = 2 * pa + 0.7 if locked else rng.uniform(0, 2 * np.pi)
            a[i] = np.sin(2 * np.pi * 10 * t + pa) + \
                0.2 * rng.standard_normal(n)
            b[i] = np.sin(2 * np.pi * 20 * t + pb) + \
                0.2 * rng.standard_normal(n)
        return jnp.asarray(a[:, None, :]), jnp.asarray(b[:, None, :])

    def test_harmonic_lock_needs_the_right_ratio(self):
        from ninwavelets_tpu.ops.connectivity import nm_plv
        freqs_a = np.array([8.0, 10.0, 12.0], np.float32)
        bank_a = _bank(freqs_a, 2048)
        bank_b = _bank(freqs_a * 2.0, 2048)    # n/m = 2/1
        row = 1
        m = 400
        sa, sb = self._harmonic_epochs(True)
        v21 = np.asarray(nm_plv(sa, sb, bank_a, bank_b, n=2, m=1,
                                interpolate=True))[0]
        assert v21[row, m:-m].mean() > 0.85
        # 1:1 at either frequency sees nothing (phases are n:m related,
        # not equal)
        bank_b1 = _bank(freqs_a, 2048)
        v11 = np.asarray(nm_plv(sa, sb, bank_a, bank_b1, n=1, m=1,
                                interpolate=True))[0]
        assert v11[row, m:-m].mean() < 0.4
        # unlocked 2:1 is low
        sa, sb = self._harmonic_epochs(False, seed=3)
        v0 = np.asarray(nm_plv(sa, sb, bank_a, bank_b, n=2, m=1,
                               interpolate=True))[0]
        assert v0[row, m:-m].mean() < 0.45

    def test_reduces_to_plv_at_1_1(self):
        from ninwavelets_tpu.ops.connectivity import nm_plv
        bank = _bank(np.arange(20.0, 60.0, 8.0), 1024)
        rng = np.random.default_rng(5)
        sa = jnp.asarray(rng.standard_normal((6, 1, 1024)).astype(
            np.float32))
        sb = jnp.asarray(rng.standard_normal((6, 1, 1024)).astype(
            np.float32))
        want = np.asarray(plv(sa, sb, bank, interpolate=True))
        got = np.asarray(nm_plv(sa, sb, bank, bank, n=1, m=1,
                                interpolate=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_adapter_convenience(self):
        from tests.test_epochs import FakeEpochs  # reuse duck type
        sa, sb = self._harmonic_epochs(True, e=8)
        data = np.concatenate([np.asarray(sa), np.asarray(sb)], axis=1)
        ew = nw.EpochsWavelet(FakeEpochs(data, SFREQ), nw.Morse(SFREQ))
        v = np.asarray(ew.nm_plv("EEG 000", "EEG 001", [10.0], n=2, m=1))
        assert v.shape == (1, 2048)
        assert v[0, 400:-400].mean() > 0.8


class TestSurrogateSignificance:
    def test_coupled_small_p_independent_uniform(self):
        from ninwavelets_tpu.ops.connectivity import plv_significance
        freqs = np.arange(30.0, 55.0, 8.0)
        bank = _bank(freqs, 1024)
        rng = np.random.default_rng(7)
        t = np.arange(1024) / SFREQ
        e = 16
        # coupled at 40 Hz with fixed lag
        pa = rng.uniform(0, 2 * np.pi, e)
        a = (np.sin(2 * np.pi * 40 * t + pa[:, None])
             + 0.4 * rng.standard_normal((e, 1024))).astype(np.float32)
        b = (np.sin(2 * np.pi * 40 * t + pa[:, None] + 1.0)
             + 0.4 * rng.standard_normal((e, 1024))).astype(np.float32)
        obs, p = plv_significance(jnp.asarray(a[:, None]),
                                  jnp.asarray(b[:, None]), bank,
                                  interpolate=True, n_surrogates=99,
                                  seed=1)
        obs, p = np.asarray(obs)[0], np.asarray(p)[0]
        row = int(np.argmin(np.abs(freqs - 40.0)))
        m = 300
        assert obs[row, m:-m].mean() > 0.85
        # coupled cells hit the permutation floor 1/(n+1)
        assert np.median(p[row, m:-m]) <= 0.02 + 1e-9
        # independent channels: p roughly uniform (median near 0.5)
        b2 = rng.standard_normal((e, 1024)).astype(np.float32)
        _, p0 = plv_significance(jnp.asarray(a[:, None]),
                                 jnp.asarray(b2[:, None]), bank,
                                 interpolate=True, n_surrogates=99,
                                 seed=2)
        p0 = np.asarray(p0)[0]
        assert 0.2 < np.median(p0[:, m:-m]) < 0.8

    def test_min_shift_validation(self):
        from ninwavelets_tpu.ops.connectivity import surrogate_pvalues
        import jax
        sig = jnp.zeros((2, 64))
        with pytest.raises(ValueError):
            surrogate_pvalues(lambda s: jnp.zeros(()), jnp.zeros(()), sig,
                              jax.random.PRNGKey(0), 9, min_shift=40)


def test_sharded_nm_plv_matches_single_device():
    from ninwavelets_tpu.ops.connectivity import nm_plv_from_bank
    mesh = par.make_mesh(data=2, freq=4)
    freqs_a = np.arange(8.0, 16.0, 1.0, np.float32)     # 8 rows / 4 shards
    bank_a = _bank(freqs_a, 1024)
    bank_b = _bank(freqs_a * 2.0, 1024)
    rng = np.random.default_rng(9)
    sa = jnp.asarray(rng.standard_normal((4, 1, 1024)).astype(np.float32))
    sb = jnp.asarray(rng.standard_normal((4, 1, 1024)).astype(np.float32))
    want = np.asarray(nm_plv_from_bank(sa, sb, bank_a, bank_b, 2, 1,
                                       interpolate=True))
    got = np.asarray(par.sharded_nm_plv(sa, sb, bank_a, bank_b, mesh=mesh,
                                        n=2, m=1, interpolate=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


class TestPhaseLag:
    """PLI / wPLI / debiased wPLI^2 / PPC (``ops.connectivity.phase_lag``,
    ``ppc``) — imaginary-cross-spectrum statistics and the bias-free phase
    consistency, with fused-kernel and sharded variants."""

    FREQS = np.arange(20.0, 80.0, 6.0)

    def _epochs(self, lag_rad: float, e=16, n=1024, seed=0, noise=0.3):
        """Two channels sharing a 40 Hz tone at a FIXED lag across epochs
        (lag 0 models pure volume conduction from a common source)."""
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SFREQ
        pa = rng.uniform(0, 2 * np.pi, e)
        a = (np.sin(2 * np.pi * 40 * t + pa[:, None])
             + noise * rng.standard_normal((e, n))).astype(np.float32)
        b = (np.sin(2 * np.pi * 40 * t + pa[:, None] + lag_rad)
             + noise * rng.standard_normal((e, n))).astype(np.float32)
        return jnp.asarray(a[:, None]), jnp.asarray(b[:, None])

    @staticmethod
    def _oracle(sa, sb, bank, method):
        """Float64 numpy statistic straight from the definition, using the
        engine's own coefficients (the estimator math is what's under
        test; coefficient parity has its own oracle suite)."""
        import jax

        from ninwavelets_tpu.ops.cwt import cwt_from_bank
        w = jax.jit(lambda x: cwt_from_bank(x, bank, True))
        wa = np.asarray(w(sa)).astype(np.complex128)
        wb = np.asarray(w(sb)).astype(np.complex128)
        e = sa.shape[0]
        x = wa * np.conj(wb)
        im = x.imag
        if method == "pli":
            return np.abs(np.sign(im).sum(0)) / e
        if method == "wpli":
            return np.abs(im.sum(0)) / np.abs(im).sum(0)
        if method == "dwpli":
            s, sq = im.sum(0), (im * im).sum(0)
            sab = np.abs(im).sum(0)
            return (s * s - sq) / (sab * sab - sq)
        u = x / np.abs(x)
        s = u.sum(0)
        return (np.abs(s) ** 2 - e) / (e * (e - 1))

    @pytest.mark.parametrize("method", ["pli", "wpli", "dwpli"])
    def test_oracle_parity(self, method):
        from ninwavelets_tpu.ops.connectivity import phase_lag
        bank = _bank(self.FREQS, 1024)
        sa, sb = self._epochs(1.0, e=7)
        want = self._oracle(sa, sb, bank, method)
        got = np.asarray(phase_lag(sa, sb, bank, method=method,
                                   interpolate=True))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_ppc_oracle_parity_and_plv_identity(self):
        from ninwavelets_tpu.ops.connectivity import ppc
        bank = _bank(self.FREQS, 1024)
        sa, sb = self._epochs(1.0, e=9)
        want = self._oracle(sa, sb, bank, "ppc")
        got = np.asarray(ppc(sa, sb, bank, interpolate=True))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        # Exact algebraic identity: PPC = (E^2 PLV^2 - E) / (E (E - 1)).
        e = sa.shape[0]
        v = np.asarray(plv(sa, sb, bank, interpolate=True)).astype(
            np.float64)
        np.testing.assert_allclose(got, (e * e * v * v - e) / (e * (e - 1)),
                                   rtol=1e-3, atol=1e-5)

    def test_volume_conduction_immunity(self):
        """The defining property: zero-lag (common-source) coupling drives
        PLV up but leaves the phase-lag family near zero; a true lag
        drives both up."""
        from ninwavelets_tpu.ops.connectivity import phase_lag
        bank = _bank(self.FREQS, 1024)
        row = int(np.argmin(np.abs(self.FREQS - 40.0)))
        m = 200
        sa, sb = self._epochs(0.0, e=24)            # zero lag
        v = np.asarray(plv(sa, sb, bank, interpolate=True))[0]
        assert v[row, m:-m].mean() > 0.9            # PLV fooled
        for method in ("pli", "wpli", "dwpli"):
            pl = np.asarray(phase_lag(sa, sb, bank, method=method,
                                      interpolate=True))[0]
            assert pl[row, m:-m].mean() < 0.35, method
        sa, sb = self._epochs(np.pi / 3, e=24, seed=1)   # true lag
        for method in ("pli", "wpli", "dwpli"):
            pl = np.asarray(phase_lag(sa, sb, bank, method=method,
                                      interpolate=True))[0]
            assert pl[row, m:-m].mean() > 0.85, method

    def test_self_connection_nan_and_eps_floor(self):
        from ninwavelets_tpu.ops.connectivity import phase_lag
        bank = _bank(self.FREQS, 1024)
        sa, _ = self._epochs(0.0, e=4)
        w = np.asarray(phase_lag(sa, sa, bank, method="wpli",
                                 interpolate=True))
        assert np.isnan(w).all()                    # 0/0 convention
        w = np.asarray(phase_lag(sa, sa, bank, method="wpli",
                                 interpolate=True, eps=1e-12))
        np.testing.assert_allclose(w, 0.0)

    @staticmethod
    def _assert_oracle(method, sa, sb, bank, got):
        """Against the float64 oracle: wpli/dwpli to the 90 dB gate; pli
        counts signs, so a cell whose lag sits at zero may flip under
        round-off — at most one cell in a thousand may differ."""
        want = ro.phase_lag(np.asarray(sa), np.asarray(sb), bank, True,
                            method)
        got = np.asarray(got)
        if method == "pli":
            assert np.mean(np.abs(got - want) > 1e-6) < 1e-3
        else:
            assert ro.snr_db(want, got) >= 90.0

    @pytest.mark.parametrize("method", ["pli", "wpli", "dwpli"])
    def test_matches_oracle(self, method):
        from ninwavelets_tpu.ops.connectivity import phase_lag
        bank = _bank(self.FREQS, 1024)
        sa, sb = self._epochs(1.0, e=6)
        got = phase_lag(sa, sb, bank, method=method, interpolate=True)
        self._assert_oracle(method, sa, sb, bank, got)

    def test_ragged_epoch_count(self):
        """An odd epoch count (11) through the four epoch sums."""
        from ninwavelets_tpu.ops.connectivity import phase_lag
        bank = _bank(self.FREQS, 1024)
        sa, sb = self._epochs(1.0, e=11)
        for method in ("pli", "dwpli"):
            got = phase_lag(sa, sb, bank, method=method, interpolate=True)
            self._assert_oracle(method, sa, sb, bank, got)

    def test_ppc_matches_oracle(self):
        from ninwavelets_tpu.ops.connectivity import ppc
        bank = _bank(self.FREQS, 1024)
        sa, sb = self._epochs(1.0, e=6)
        got = np.asarray(ppc(sa, sb, bank, interpolate=True))
        want = ro.ppc(np.asarray(sa), np.asarray(sb), bank, True)
        assert ro.snr_db(want, got) >= 90.0

    def test_sharded_matches_single_device(self):
        from ninwavelets_tpu.ops.connectivity import phase_lag, ppc
        mesh = par.make_mesh(data=4, freq=2)
        bank = _bank(self.FREQS, 1024)
        sa, sb = self._epochs(1.0, e=8)
        for method in ("pli", "wpli", "dwpli"):
            want = np.asarray(phase_lag(sa, sb, bank, method=method,
                                        interpolate=True))
            got = np.asarray(par.sharded_phase_lag(
                sa, sb, bank, mesh=mesh, method=method, interpolate=True))
            # atol covers dwpli cells whose denominator nearly cancels
            # (psum reassociation vs the single-device sum order).
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=5e-6)
        want = np.asarray(ppc(sa, sb, bank, interpolate=True))
        got = np.asarray(par.sharded_ppc(sa, sb, bank, mesh=mesh,
                                         interpolate=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=5e-6)

    def test_matrices_match_per_pair(self):
        from ninwavelets_tpu.ops.connectivity import (phase_lag, ppc,
                                                      ppc_matrix,
                                                      wpli_matrix)
        bank = _bank(self.FREQS[:4], 1024)
        rng = np.random.default_rng(3)
        sig = jnp.asarray(rng.standard_normal((6, 3, 1024)).astype(
            np.float32))
        mat = np.asarray(wpli_matrix(sig, bank, method="wpli",
                                     interpolate=True))
        assert mat.shape == (4, 3, 3)
        assert np.isnan(mat[:, np.arange(3), np.arange(3)]).all()
        for a, b in ((0, 1), (2, 0)):
            want = np.asarray(phase_lag(
                sig[:, a:a + 1], sig[:, b:b + 1], bank, method="wpli",
                interpolate=True))[0].mean(-1)
            np.testing.assert_allclose(mat[:, a, b], want, rtol=2e-4,
                                       atol=1e-5)
        pm = np.asarray(ppc_matrix(sig, bank, interpolate=True))
        np.testing.assert_allclose(pm[:, np.arange(3), np.arange(3)], 1.0,
                                   atol=1e-4)
        want = np.asarray(ppc(sig[:, 0:1], sig[:, 1:2], bank,
                              interpolate=True))[0].mean(-1)
        np.testing.assert_allclose(pm[:, 0, 1], want, rtol=2e-4, atol=1e-5)

    def test_adapter_convenience(self):
        from tests.test_epochs import FakeEpochs
        sa, sb = self._epochs(np.pi / 3, e=12)
        data = np.concatenate([np.asarray(sa), np.asarray(sb)], axis=1)
        ew = nw.EpochsWavelet(FakeEpochs(data, SFREQ), nw.Morse(SFREQ))
        row = int(np.argmin(np.abs(self.FREQS - 40.0)))
        w = np.asarray(ew.wpli("EEG 000", "EEG 001", self.FREQS))
        assert w.shape == (self.FREQS.size, 1024)
        assert w[row, 200:-200].mean() > 0.8
        p = np.asarray(ew.pli("EEG 000", "EEG 001", self.FREQS))
        assert p[row, 200:-200].mean() > 0.8
        c = np.asarray(ew.ppc("EEG 000", "EEG 001", self.FREQS))
        assert c[row, 200:-200].mean() > 0.8
        m = np.asarray(ew.wpli_matrix(self.FREQS[:3]))
        assert m.shape == (3, 2, 2)
        pm = np.asarray(ew.ppc_matrix(self.FREQS[:3],
                                      time_range=(0.1, 0.9)))
        assert pm.shape == (3, 2, 2)

    def test_bad_method_raises(self):
        from ninwavelets_tpu.ops.connectivity import (phase_lag,
                                                      wpli_matrix)
        bank = _bank(self.FREQS[:2], 1024)
        sa, sb = self._epochs(1.0, e=2)
        with pytest.raises(ValueError, match="method"):
            phase_lag(sa, sb, bank, method="nope")
        with pytest.raises(ValueError, match="method"):
            wpli_matrix(sa, bank, method="nope")


def test_phase_lag_significance():
    """Lagged coupling hits the permutation floor; independent channels
    give roughly uniform p."""
    from ninwavelets_tpu.ops.connectivity import phase_lag_significance
    freqs = np.arange(30.0, 55.0, 8.0)
    bank = _bank(freqs, 1024)
    rng = np.random.default_rng(11)
    t = np.arange(1024) / SFREQ
    e = 16
    pa = rng.uniform(0, 2 * np.pi, e)
    a = (np.sin(2 * np.pi * 40 * t + pa[:, None])
         + 0.4 * rng.standard_normal((e, 1024))).astype(np.float32)
    b = (np.sin(2 * np.pi * 40 * t + pa[:, None] + 1.0)
         + 0.4 * rng.standard_normal((e, 1024))).astype(np.float32)
    obs, p = phase_lag_significance(jnp.asarray(a[:, None]),
                                    jnp.asarray(b[:, None]), bank,
                                    method="wpli", interpolate=True,
                                    n_surrogates=99, seed=3)
    obs, p = np.asarray(obs)[0], np.asarray(p)[0]
    row = int(np.argmin(np.abs(freqs - 40.0)))
    m = 300
    assert obs[row, m:-m].mean() > 0.8
    assert np.median(p[row, m:-m]) <= 0.02 + 1e-9
    b2 = rng.standard_normal((e, 1024)).astype(np.float32)
    _, p0 = phase_lag_significance(jnp.asarray(a[:, None]),
                                   jnp.asarray(b2[:, None]), bank,
                                   method="wpli", interpolate=True,
                                   n_surrogates=99, seed=4)
    p0 = np.asarray(p0)[0]
    assert 0.15 < np.median(p0[:, m:-m]) < 0.85
    with pytest.raises(ValueError, match="method"):
        phase_lag_significance(jnp.asarray(a[:, None]),
                               jnp.asarray(b2[:, None]), bank,
                               method="nope")


class TestPartialCoherence:
    """Inverse-cross-spectral conditional coupling: mediated chains
    vanish, direct links survive, float64 oracle."""
    FREQS = np.arange(16.0, 64.0, 6.0)

    def _chain(self, e=24, n=2048, seed=0):
        """x1 = z, x2 = z + e2, x3 = x2 + e3: marginally coh(1,3) is
        high but x1 and x3 are independent GIVEN x2."""
        rng = np.random.default_rng(seed)
        z = rng.standard_normal((e, n))
        e2 = 0.5 * rng.standard_normal((e, n))
        e3 = 0.5 * rng.standard_normal((e, n))
        x = np.stack([z, z + e2, z + e2 + e3], axis=1)
        return jnp.asarray(x.astype(np.float32))

    def test_mediated_chain_vanishes(self):
        from ninwavelets_tpu.ops.connectivity import partial_coherence
        x = self._chain()
        bank = _bank(self.FREQS, 2048, interpolate=False)
        pc = np.asarray(partial_coherence(x, bank)).mean(0)
        coh = np.asarray(coherence_matrix(x, bank)).mean(0)
        # marginal 1-3 coherence is strong; partialed on 2 it collapses
        assert coh[0, 2] > 0.5
        assert pc[0, 2] < 0.1
        # the direct links survive the conditioning (attenuated — the
        # conditioning channel carries part of each neighbor's signal,
        # e.g. pc(1,2|3) < coh(1,2) because x3 = x2 + e3 explains x2)
        assert pc[0, 1] > 0.3 and pc[1, 2] > 0.4
        assert pc[0, 1] > 20 * pc[0, 2] and pc[1, 2] > 20 * pc[0, 2]
        np.testing.assert_allclose(np.diagonal(pc), 1.0, atol=1e-4)
        np.testing.assert_allclose(pc, pc.T, atol=1e-5)

    def test_matches_float64_oracle(self):
        from ninwavelets_tpu.ops.connectivity import partial_coherence
        x = self._chain(e=8, n=1024, seed=1)
        bank = _bank(self.FREQS, 1024, interpolate=False)
        got = np.asarray(partial_coherence(x, bank, lam=1e-5))
        xs = np.asarray(x, np.float64)
        spec = np.fft.fft(xs)
        bk = np.asarray(bank, np.float64)
        for f in range(bk.shape[0]):
            w = np.fft.ifft(spec * bk[f])                 # (E, C, N)
            s = np.einsum('ean,ebn->ab', w, w.conj()) / (8 * 1024)
            s = s + 1e-5 * np.real(np.trace(s)) / 3 * np.eye(3)
            si = np.linalg.inv(s)
            d = np.real(np.diag(si))
            want = np.abs(si) ** 2 / (d[:, None] * d[None, :])
            np.testing.assert_allclose(got[f], want, rtol=2e-2,
                                       atol=2e-3)

    def test_sharded_matches_single_device(self):
        from ninwavelets_tpu.ops.connectivity import partial_coherence
        mesh = par.make_mesh(data=2, freq=4)
        x = self._chain(e=8, n=1024, seed=2)
        bank = _bank(self.FREQS, 1024, interpolate=False)
        want = np.asarray(partial_coherence(x, bank))
        got = np.asarray(par.sharded_partial_coherence(x, bank,
                                                       mesh=mesh))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_adapter_and_validation(self):
        from tests.test_epochs import FakeEpochs
        from ninwavelets_tpu.ops.connectivity import \
            partial_coherence_from_bank
        x = np.asarray(self._chain(e=8, n=1024, seed=3))
        ew = nw.EpochsWavelet(FakeEpochs(x, SFREQ), nw.Morse(SFREQ))
        pc = np.asarray(ew.partial_coherence(self.FREQS))
        assert pc.shape == (self.FREQS.size, 3, 3)
        assert pc.mean(0)[0, 2] < 0.1
        with pytest.raises(ValueError, match="channels"):
            partial_coherence_from_bank(
                jnp.zeros((4, 1, 256)), _bank(self.FREQS, 256,
                                              interpolate=False))


class TestPSI:
    """Phase-slope index (Nolte 2008): float64 oracle, direction
    detection, antisymmetry, jackknife normalization."""
    FREQS = np.arange(16.0, 80.0, 4.0)

    @staticmethod
    def _psi_oracle(x, bank):
        """Direct float64 transcription of the PSI definition."""
        e, c, n = x.shape
        spec = np.fft.fft(np.asarray(x, np.float64))
        s = np.zeros((bank.shape[0], c, c), complex)
        for f in range(bank.shape[0]):
            w = np.fft.ifft(spec * np.asarray(bank[f], np.float64))
            s[f] = np.einsum('ean,ebn->ab', w, w.conj())
        p = np.real(np.einsum('faa->fa', s))
        coh = s / np.sqrt(p[:, :, None] * p[:, None, :])
        return np.imag(np.sum(coh[:-1].conj() * coh[1:], axis=0))

    def _delayed(self, e=16, n=2048, delay=8, seed=0):
        """ch0 leads ch1 by `delay` samples; ch2 independent noise."""
        rng = np.random.default_rng(seed)
        s = rng.standard_normal((e, n + delay))
        x = np.stack([s[:, delay:], s[:, :n],
                      rng.standard_normal((e, n))], axis=1)
        x += 0.2 * rng.standard_normal(x.shape)
        return jnp.asarray(x.astype(np.float32))

    def test_matches_float64_oracle(self):
        from ninwavelets_tpu.ops.connectivity import psi_matrix
        x = self._delayed(e=8, n=1024)
        bank = _bank(self.FREQS, 1024, interpolate=False)
        got = np.asarray(psi_matrix(x, bank, normalize=False))
        want = self._psi_oracle(np.asarray(x), np.asarray(bank))
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_direction_and_antisymmetry(self):
        from ninwavelets_tpu.ops.connectivity import psi_matrix
        x = self._delayed()
        bank = _bank(self.FREQS, 2048, interpolate=False)
        z = np.asarray(psi_matrix(x, bank))
        # leader -> follower strongly positive, mirror negative
        assert z[0, 1] > 2.0
        assert z[1, 0] < -2.0
        # uncoupled channel: no consistent slope
        assert abs(z[0, 2]) < 4.0 and abs(z[1, 2]) < 4.0
        np.testing.assert_allclose(z, -z.T, atol=1e-4)
        np.testing.assert_allclose(np.diag(z), 0.0, atol=1e-6)

    def test_unnormalized_antisymmetry_and_null(self):
        from ninwavelets_tpu.ops.connectivity import psi_matrix
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.standard_normal((12, 3, 1024)).astype(
            np.float32))
        bank = _bank(self.FREQS, 1024, interpolate=False)
        raw = np.asarray(psi_matrix(x, bank, normalize=False))
        np.testing.assert_allclose(raw, -raw.T, atol=1e-5)
        z = np.asarray(psi_matrix(x, bank))
        off = z[~np.eye(3, dtype=bool)]
        assert np.abs(off).max() < 5.0      # z-like under independence

    def test_validation(self):
        from ninwavelets_tpu.ops.connectivity import psi_matrix_from_bank
        bank = _bank(self.FREQS, 256, interpolate=False)
        with pytest.raises(ValueError, match="epochs"):
            psi_matrix_from_bank(jnp.zeros((1, 2, 256)), bank)
        with pytest.raises(ValueError, match="bank rows"):
            psi_matrix_from_bank(jnp.zeros((4, 2, 256)), bank[:1])

    def test_adapter(self):
        from tests.test_epochs import FakeEpochs
        x = np.asarray(self._delayed(e=12, n=1024))
        ew = nw.EpochsWavelet(FakeEpochs(x, SFREQ), nw.Morse(SFREQ))
        z = np.asarray(ew.psi_matrix(self.FREQS[::-1]))   # unsorted freqs OK
        assert z.shape == (3, 3)
        assert z[0, 1] > 2.0

    def test_sharded_matches_single_device(self):
        from ninwavelets_tpu.ops.connectivity import psi_matrix
        mesh = par.make_mesh(data=4, freq=2)
        x = self._delayed(e=16, n=1024)
        bank = _bank(self.FREQS, 1024, interpolate=False)
        for normalize in (False, True):
            want = np.asarray(psi_matrix(x, bank, normalize=normalize))
            got = np.asarray(par.sharded_psi_matrix(x, bank, mesh=mesh,
                                             normalize=normalize))
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


class TestKuramoto:
    def test_locked_vs_independent(self):
        rng = np.random.default_rng(0)
        n, c, e = 2048, 8, 6
        t = np.arange(n) / SFREQ
        locked = np.stack([[np.sin(2 * np.pi * 40 * t + 0.1 * ch)
                            + 0.2 * rng.standard_normal(n)
                            for ch in range(c)] for _ in range(e)])
        indep = np.stack([[np.sin(2 * np.pi * 40 * t
                                  + rng.uniform(0, 2 * np.pi))
                           + 0.2 * rng.standard_normal(n)
                           for _ in range(c)] for _ in range(e)])
        freqs = np.arange(20.0, 60.0, 5.0)
        bank = _bank(freqs, n)
        from ninwavelets_tpu.ops.connectivity import kuramoto_order
        row = int(np.argmin(np.abs(freqs - 40.0)))
        rl = np.asarray(kuramoto_order(
            jnp.asarray(locked.astype(np.float32)), bank,
            interpolate=True))
        ri = np.asarray(kuramoto_order(
            jnp.asarray(indep.astype(np.float32)), bank,
            interpolate=True))
        assert rl.shape == (freqs.size, n)
        m = 400
        assert rl[row, m:-m].mean() > 0.9
        assert ri[row, m:-m].mean() < 0.75
        # per-epoch form averages to the epoch-mean form
        re = np.asarray(kuramoto_order(
            jnp.asarray(locked.astype(np.float32)), bank,
            interpolate=True, mean_epochs=False))
        assert re.shape == (e, freqs.size, n)
        np.testing.assert_allclose(re.mean(0), rl, rtol=1e-5, atol=1e-6)

    def test_single_channel_is_one(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((3, 1, 1024)).astype(
            np.float32))
        bank = _bank(np.arange(20.0, 40.0, 5.0), 1024)
        from ninwavelets_tpu.ops.connectivity import kuramoto_order
        r = np.asarray(kuramoto_order(x, bank, interpolate=True))
        np.testing.assert_allclose(r, 1.0, atol=1e-5)

    def test_adapter(self):
        from tests.test_epochs import FakeEpochs
        rng = np.random.default_rng(2)
        t = np.arange(1024) / SFREQ
        data = np.stack([[np.sin(2 * np.pi * 30 * t + 0.05 * ch)
                          + 0.1 * rng.standard_normal(1024)
                          for ch in range(4)] for _ in range(4)]
                        ).astype(np.float32)
        ew = nw.EpochsWavelet(FakeEpochs(data, SFREQ), nw.Morse(SFREQ))
        r = np.asarray(ew.kuramoto_order([25.0, 30.0, 35.0]))
        assert r.shape == (3, 1024)
        assert r[1, 300:-300].mean() > 0.9
