"""OnlineCWT: chunking-invariant incremental parity vs StreamingCWT."""
import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu.parallel import OnlineCWT, StreamingCWT


def _drain(oc, sig, chunks):
    """Push ``sig`` split at ``chunks`` boundaries; return assembled
    (..., F, N) plane from the emitted blocks."""
    n = sig.shape[-1]
    blocks = []
    pos = 0
    for size in chunks:
        blocks += oc.push(sig[..., pos:pos + size])
        pos += size
    assert pos == n
    blocks += oc.flush()
    out = np.zeros(sig.shape[:-1] + (len(oc.freqs), n), np.float32)
    covered = 0
    for start, blk in blocks:
        blk = np.asarray(blk)
        out[..., start:start + blk.shape[-1]] = blk
        covered += blk.shape[-1]
    assert covered == n, "blocks must tile the stream exactly once"
    return out


class TestOnlineCWT:
    sfreq = 500.0

    def _pair(self, **kw):
        morse = nw.Morse(self.sfreq)
        freqs = np.arange(5.0, 50.0, 5.0)
        kw.setdefault("window", 512)
        kw.setdefault("halo", 256)
        kw.setdefault("batch", 1)   # OnlineCWT's real-time default
        oc = OnlineCWT(morse._wdef(), freqs, self.sfreq, **kw)
        sc = StreamingCWT(morse._wdef(), freqs, self.sfreq, **kw)
        return oc, sc

    def test_single_push_equals_offline(self):
        rng = np.random.default_rng(0)
        sig = rng.standard_normal(2000).astype(np.float32)
        oc, sc = self._pair()
        got = _drain(oc, sig, [2000])
        np.testing.assert_array_equal(got, np.asarray(sc.power(sig)))

    def test_batched_mode_float32_parity(self):
        """batch>1 trades bit-parity for dispatch amortization: XLA's
        CPU rFFT rounds by row-pair, so differently-composed batches
        agree only to float32 rounding."""
        rng = np.random.default_rng(7)
        sig = rng.standard_normal(4000).astype(np.float32)
        oc, sc = self._pair(batch=4)
        got = _drain(oc, sig, [900, 1100, 2000])
        ref = np.asarray(sc.power(sig))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_random_chunking_invariant(self, seed):
        rng = np.random.default_rng(seed)
        n = 3000
        sig = rng.standard_normal(n).astype(np.float32)
        cuts = np.sort(rng.choice(np.arange(1, n), size=17, replace=False))
        chunks = np.diff(np.concatenate([[0], cuts, [n]])).tolist()
        oc, sc = self._pair()
        got = _drain(oc, sig, chunks)
        np.testing.assert_array_equal(got, np.asarray(sc.power(sig)))

    def test_tiny_chunks(self):
        rng = np.random.default_rng(4)
        sig = rng.standard_normal(1500).astype(np.float32)
        oc, sc = self._pair()
        got = _drain(oc, sig, [7] * (1500 // 7) + [1500 % 7])
        np.testing.assert_array_equal(got, np.asarray(sc.power(sig)))

    def test_multichannel(self):
        rng = np.random.default_rng(5)
        sig = rng.standard_normal((3, 2200)).astype(np.float32)
        oc, sc = self._pair()
        got = _drain(oc, sig, [500, 1, 999, 700])
        np.testing.assert_array_equal(got, np.asarray(sc.power(sig)))

    def test_emission_latency(self):
        """A window emits exactly when window+halo samples past its
        start have arrived, not later."""
        oc, _ = self._pair()   # window 512, halo 256
        assert oc.push(np.zeros(767, np.float32)) == []
        out = oc.push(np.zeros(1, np.float32))    # 768 = 512 + 256
        assert [s for s, _ in out] == [0]
        # next window needs 512+768=1280 total... already at 768; push
        # up to 1279 -> nothing, 1280 -> window 512 emits
        assert oc.push(np.zeros(511, np.float32)) == []
        out = oc.push(np.zeros(1, np.float32))
        assert [s for s, _ in out] == [512]

    def test_history_stays_bounded(self):
        oc, _ = self._pair()
        rng = np.random.default_rng(6)
        for _ in range(30):
            oc.push(rng.standard_normal(333).astype(np.float32))
        # retained history: halo context + unprocessed residue
        assert oc._hist.shape[-1] <= oc.halo + oc.window + oc.halo + 333

    def test_flush_finalizes(self):
        oc, _ = self._pair()
        oc.push(np.zeros(100, np.float32))
        blocks = oc.flush()
        assert [s for s, _ in blocks] == [0]
        assert blocks[0][1].shape[-1] == 100
        assert oc.flush() == []
        with pytest.raises(RuntimeError):
            oc.push(np.zeros(10, np.float32))

    def test_lead_dims_must_match(self):
        oc, _ = self._pair()
        oc.push(np.zeros((2, 10), np.float32))
        with pytest.raises(ValueError):
            oc.push(np.zeros(10, np.float32))

    def test_sine_peak(self):
        t = np.arange(4000) / self.sfreq
        sig = np.sin(2 * np.pi * 20 * t).astype(np.float32)
        oc, _ = self._pair()
        plane = _drain(oc, sig, [1300, 1300, 1400])
        peak = oc.freqs[plane.mean(-1).argmax()]
        assert peak == 20.0
