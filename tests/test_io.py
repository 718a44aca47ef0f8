"""IO subsystem: native gather kernels, EDF round trip, streamed
sources feeding StreamingCWT / RawWavelet.

The native C++ library builds on first use (g++ in this image); every
native result is cross-checked against the numpy fallback oracle in
``io/native.py``, which in turn is pinned against straight-line numpy
here.
"""
import os

import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu.io import (ArraySource, EDFRaw, EDFReader, EDFSource,
                                iter_ext_batches, native_available,
                                write_edf)
from ninwavelets_tpu.io import native
from ninwavelets_tpu.parallel.streaming import StreamingCWT


def _ext_oracle(data2d, starts, window, halo):
    """Straight-line reference for the gather contract."""
    n_ch, n = data2d.shape
    ext = window + 2 * halo
    out = np.zeros((len(starts), n_ch, ext), np.float32)
    for w, s in enumerate(starts):
        for t in range(ext):
            src = s - halo + t
            if 0 <= src < n:
                out[w, :, t] = data2d[:, src]
    return out


class TestNativeGather:
    def test_library_builds(self):
        if os.environ.get("NINW_NATIVE_IO") == "0":
            pytest.skip("native IO disabled by env")
        assert native_available(), "g++ is in this image; build must work"

    def test_f32_gather_matches_oracle(self):
        rng = np.random.default_rng(0)
        data = rng.standard_normal((3, 257)).astype(np.float32)
        starts = [0, 100, 200, 256]
        got = native.f32_gather(data, starts, window=64, halo=16)
        np.testing.assert_array_equal(
            got, _ext_oracle(data, starts, 64, 16))

    def test_f32_gather_native_equals_fallback(self):
        rng = np.random.default_rng(1)
        data = rng.standard_normal((2, 1000)).astype(np.float32)
        starts = [0, 512, 990]
        got = native.f32_gather(data, starts, 128, 32)
        ref = native._f32_gather_np(data, np.asarray(starts), 128, 32)
        np.testing.assert_array_equal(got, ref)

    def test_halo_zero(self):
        data = np.arange(12, dtype=np.float32).reshape(1, 12)
        got = native.f32_gather(data, [0], window=12, halo=0)
        np.testing.assert_array_equal(got[0, 0], data[0])

    def test_fully_outside_windows_zero(self):
        """Starts far outside the recording yield all-zero rows — the
        native kernel must not write out of bounds (review finding:
        unclamped zero() offsets corrupted the heap)."""
        rng = np.random.default_rng(20)
        data = rng.standard_normal((2, 100)).astype(np.float32)
        starts = [-10**6, -200, 100, 500, 10**6, 50]
        got = native.f32_gather(data, starts, window=16, halo=4)
        ref = _ext_oracle(data, starts, 16, 4)
        np.testing.assert_array_equal(got, ref)
        assert np.all(got[[0, 1, 3, 4]] == 0)   # fully-outside rows
        assert np.any(got[2] != 0) and np.any(got[5] != 0)

    def test_edf_gather_outside_windows_zero(self, tmp_path=None):
        import tempfile
        rng = np.random.default_rng(21)
        data = rng.standard_normal((2, 300)) * 10
        path = tempfile.mktemp(suffix=".edf")
        write_edf(path, data, 100.0)
        r = EDFReader(path)
        starts = [-10**6, 250, 10**6]
        got = r.gather(starts, window=64, halo=16)
        full = r.get_data()
        np.testing.assert_array_equal(got, _ext_oracle(full, starts, 64, 16))
        assert np.all(got[0] == 0) and np.all(got[2] == 0)
        os.unlink(path)

    def test_bad_geometry_raises(self):
        if not native_available():
            pytest.skip("fallback path validates via numpy broadcasting")
        data = np.zeros((1, 8), np.float32)
        with pytest.raises(ValueError):
            native.f32_gather(data, [0], window=0, halo=1)


class TestEDF:
    def _roundtrip(self, tmp_path, data, sfreq, **kw):
        path = os.path.join(tmp_path, "t.edf")
        write_edf(path, data, sfreq, **kw)
        return path, EDFReader(path)

    def test_header_roundtrip(self, tmp_path):
        rng = np.random.default_rng(2)
        data = rng.standard_normal((3, 500)) * 50
        path, r = self._roundtrip(tmp_path, data, 100.0,
                                  ch_names=["Fz", "Cz", "Pz"])
        assert r.ch_names == ["Fz", "Cz", "Pz"]
        assert r.sfreq == 100.0
        assert r.n_samples == 500
        assert r.n_records == 5
        assert r.units == ["uV", "uV", "uV"]

    def test_data_roundtrip_quantization(self, tmp_path):
        rng = np.random.default_rng(3)
        data = rng.standard_normal((4, 1000)) * 30 + 5
        path, r = self._roundtrip(tmp_path, data, 250.0)
        got = r.get_data()
        assert got.dtype == np.float32
        # 16-bit quantization: error bounded by one digital step
        step = (data.max(1) - data.min(1)) / 65535.0
        assert np.all(np.abs(got - data) <= step[:, None] * 0.51 + 1e-6)

    def test_native_load_equals_fallback(self, tmp_path):
        rng = np.random.default_rng(4)
        data = rng.standard_normal((2, 300)) * 10
        path, r = self._roundtrip(tmp_path, data, 100.0)
        ref = native._edf_load_np(
            np.asarray(r._mm), r._rec_stride,
            r._ch_off_all[r._data_idx], r._scale_all[r._data_idx],
            r._dc_all[r._data_idx], 100, 300)
        np.testing.assert_array_equal(r.get_data(), ref)

    def test_gather_matches_loaded_slices(self, tmp_path):
        rng = np.random.default_rng(5)
        data = rng.standard_normal((3, 700)) * 20
        path, r = self._roundtrip(tmp_path, data, 100.0)
        full = r.get_data()
        starts = [0, 150, 690]
        got = r.gather(starts, window=128, halo=32)
        np.testing.assert_array_equal(got, _ext_oracle(full, starts, 128, 32))

    def test_gather_native_equals_fallback(self, tmp_path):
        rng = np.random.default_rng(6)
        data = rng.standard_normal((2, 512)) * 7
        path, r = self._roundtrip(tmp_path, data, 128.0)
        idx = r._data_idx
        ref = native._edf_gather_np(
            np.asarray(r._mm), r._rec_stride, r._ch_off_all[idx],
            r._scale_all[idx], r._dc_all[idx], 128,
            np.asarray([0, 256, 500]), 64, 16, 512)
        got = r.gather([0, 256, 500], 64, 16)
        np.testing.assert_array_equal(got, ref)

    def test_picks_by_name_and_index(self, tmp_path):
        rng = np.random.default_rng(7)
        data = rng.standard_normal((3, 200))
        path, r = self._roundtrip(tmp_path, data, 100.0,
                                  ch_names=["a", "b", "c"])
        by_name = r.get_data(picks=["c", "a"])
        by_idx = r.get_data(picks=[2, 0])
        np.testing.assert_array_equal(by_name, by_idx)
        np.testing.assert_allclose(by_name[0], r.get_data()[2])
        with pytest.raises(KeyError):
            r.get_data(picks=["nope"])

    def test_tail_padding(self, tmp_path):
        # 250 samples at 100 Hz -> 3 records, 50 pad samples.  The pad
        # is physical zero where the calibrated range covers it, else
        # clipped to the range edge (EDF cannot encode out-of-range).
        data = np.vstack([np.linspace(-1.0, 1.0, 250),
                          np.full(250, 3.0)])
        path, r = self._roundtrip(tmp_path, data, 100.0)
        assert r.n_samples == 300
        got = r.get_data()
        step = 2.0 / 65535
        np.testing.assert_allclose(got[0, :250], data[0], atol=5 * step)
        np.testing.assert_allclose(got[0, 250:], 0.0, atol=5 * step)
        np.testing.assert_allclose(got[1, 250:], 3.0, atol=5 * step)

    def test_truncated_header_raises(self, tmp_path):
        p = os.path.join(tmp_path, "bad.edf")
        with open(p, "wb") as f:
            f.write(b"0       " * 4)
        with pytest.raises(ValueError):
            EDFReader(p)

    def test_units_aligned_with_ch_names(self, tmp_path):
        rng = np.random.default_rng(22)
        data = rng.standard_normal((2, 100))
        path = os.path.join(tmp_path, "u.edf")
        write_edf(path, data, 100.0, ch_names=["Fz", "Pz"], units="mV")
        r = EDFReader(path)
        assert r.units == ["mV", "mV"]
        assert len(r.units) == len(r.ch_names)

    def test_record_duration_must_fit_header(self, tmp_path):
        data = np.zeros((1, 16))
        path = os.path.join(tmp_path, "rd.edf")
        # 1/1024 s = 0.0009765625: 12 chars — unrepresentable in 8
        with pytest.raises(ValueError, match="8-char"):
            write_edf(path, data, 16384.0, record_duration=1.0 / 1024)
        # 1/128 s = "0.007812" truncates -> must also refuse
        with pytest.raises(ValueError, match="8-char"):
            write_edf(path, data, 2048.0, record_duration=1.0 / 128)
        write_edf(path, data, 256.0, record_duration=0.0625)  # "0.0625" ok
        assert EDFReader(path).sfreq == 256.0

    def test_edfraw_duck(self, tmp_path):
        rng = np.random.default_rng(8)
        data = rng.standard_normal((2, 400))
        path = os.path.join(tmp_path, "r.edf")
        write_edf(path, data, 200.0, ch_names=["x", "y"])
        raw = EDFRaw(path)
        assert raw.info["sfreq"] == 200.0
        assert raw.ch_names == ["x", "y"]
        assert raw.get_data().shape == (2, 400)


class TestSources:
    def test_iter_matches_array_source(self):
        rng = np.random.default_rng(9)
        sig = rng.standard_normal((2, 1000)).astype(np.float32)
        src = ArraySource(sig)
        batches = list(iter_ext_batches(src, window=256, halo=64, batch=3))
        starts_seen = [s for g, _ in batches for s in g]
        assert starts_seen == list(range(0, 1000, 256))
        for group, ext in batches:
            assert ext.shape == (3, 2, 256 + 128)
            ref = _ext_oracle(sig, group, 256, 64)
            np.testing.assert_array_equal(ext[:len(group)], ref)
            np.testing.assert_array_equal(ext[len(group):], 0)

    def test_prefetch_order_equals_serial(self):
        rng = np.random.default_rng(10)
        sig = rng.standard_normal(5000).astype(np.float32)
        src = ArraySource(sig)
        pre = [(g, e.copy()) for g, e in
               iter_ext_batches(src, 512, 128, 2, prefetch=True)]
        ser = [(g, e.copy()) for g, e in
               iter_ext_batches(src, 512, 128, 2, prefetch=False)]
        assert [g for g, _ in pre] == [g for g, _ in ser]
        for (_, a), (_, b) in zip(pre, ser):
            np.testing.assert_array_equal(a, b)

    def test_edf_source_streaming_cwt(self, tmp_path):
        """File-streamed power == in-memory power of the decoded data."""
        rng = np.random.default_rng(11)
        sfreq = 256.0
        t = np.arange(4096) / sfreq
        data = (np.sin(2 * np.pi * 20 * t)[None]
                + 0.1 * rng.standard_normal((2, 4096)))
        path = os.path.join(tmp_path, "s.edf")
        write_edf(path, data, sfreq, record_duration=2.0)
        reader = EDFReader(path)

        morse = nw.Morse(sfreq)
        freqs = np.arange(5.0, 40.0, 5.0)
        s = StreamingCWT(morse._wdef(), freqs, sfreq, window=1024,
                         halo=512, batch=2)
        via_file = np.asarray(s.power_device_source(EDFSource(reader)))
        via_mem = np.asarray(s.power_device(reader.get_data()))
        np.testing.assert_allclose(via_file, via_mem, rtol=1e-6, atol=1e-9)

    def test_raw_wavelet_from_edf(self, tmp_path):
        rng = np.random.default_rng(12)
        sfreq = 256.0
        t = np.arange(2048) / sfreq
        data = (np.sin(2 * np.pi * 12 * t)[None]
                + 0.05 * rng.standard_normal((3, 2048)))
        path = os.path.join(tmp_path, "rw.edf")
        write_edf(path, data, sfreq, record_duration=2.0,
                  ch_names=["a", "b", "c"])

        morse = nw.Morse(sfreq)
        rw = nw.RawWavelet.from_edf(path, morse, window=1024, halo=512)
        freqs = np.arange(4.0, 30.0, 2.0)
        p_file = np.asarray(rw.power(freqs))
        assert p_file.shape == (3, len(freqs), 2048)
        # file-backed never snapshots the recording on host
        assert not hasattr(rw, "_host")
        peak = freqs[p_file.mean(-1).argmax(-1)]
        np.testing.assert_allclose(peak, 12.0, atol=2.0)
        # parity vs the host-snapshot path on the same decoded samples
        raw_mem = type("R", (), {})()
        raw_mem.info = {"sfreq": sfreq}
        raw_mem.ch_names = ["a", "b", "c"]
        raw_mem.get_data = lambda: EDFReader(path).get_data()
        rw_mem = nw.RawWavelet(raw_mem, nw.Morse(sfreq), window=1024,
                               halo=512)
        # float32 decode differs by an FMA rounding between the int16
        # gather and the snapshot path; through the FFT pipeline that is
        # a few 1e-6 relative on the power plane.
        np.testing.assert_allclose(p_file, np.asarray(rw_mem.power(freqs)),
                                   rtol=1e-4, atol=1e-9)
        # power_channel slices the same plane
        pc = np.asarray(rw.power_channel("b", freqs))
        np.testing.assert_allclose(pc, p_file[1], rtol=1e-4, atol=1e-9)

    def test_epochs_from_edf_gather(self, tmp_path):
        """Event-locked epoching off the file mmap == snapshot slicing."""
        rng = np.random.default_rng(14)
        sfreq = 250.0
        data = rng.standard_normal((2, 2500))
        path = os.path.join(tmp_path, "e.edf")
        write_edf(path, data, sfreq, ch_names=["a", "b"])
        morse = nw.Morse(sfreq)
        rw = nw.RawWavelet.from_edf(path, morse)
        events = np.array([10, 300, 1200, 2490])  # first/last get dropped
        ew = rw.epochs(events, tmin=-0.2, tmax=0.2)
        n_win = int(round(0.4 * sfreq)) + 1
        assert ew._host_data().shape == (2, 2, n_win)
        assert not hasattr(rw, "_host")  # still no snapshot
        # parity vs snapshot-path epoching on the decoded samples
        raw_mem = type("R", (), {})()
        raw_mem.info = {"sfreq": sfreq}
        raw_mem.ch_names = ["a", "b"]
        raw_mem.get_data = lambda: EDFReader(path).get_data()
        ew_mem = nw.RawWavelet(raw_mem, nw.Morse(sfreq)).epochs(
            events, tmin=-0.2, tmax=0.2)
        np.testing.assert_allclose(ew._host_data(), ew_mem._host_data(),
                                   rtol=1e-5, atol=1e-7)

    def test_from_edf_picks(self, tmp_path):
        rng = np.random.default_rng(13)
        data = rng.standard_normal((3, 1024))
        path = os.path.join(tmp_path, "p.edf")
        write_edf(path, data, 256.0, ch_names=["a", "b", "c"])
        morse = nw.Morse(256.0)
        rw = nw.RawWavelet.from_edf(path, morse, picks=["c", "a"],
                                    window=512, halo=256)
        assert rw.raw.ch_names == ["c", "a"]
        p = np.asarray(rw.power(np.arange(5.0, 20.0, 5.0)))
        assert p.shape[0] == 2
        # picks resolve against the ADAPTER's channel list: "b" exists
        # in the file but was excluded at construction (review finding:
        # the file path used to resolve against the full file)
        with pytest.raises(ValueError):
            rw.power(np.arange(5.0, 20.0, 5.0), picks=["b"])
        with pytest.raises(ValueError):
            rw.epochs([600], tmin=-0.1, tmax=0.1, picks=["b"])

    def test_edf_source_rejects_picks_on_picked_view(self, tmp_path):
        from ninwavelets_tpu.io import EDFSource
        rng = np.random.default_rng(23)
        data = rng.standard_normal((2, 200))
        path = os.path.join(tmp_path, "pp.edf")
        write_edf(path, data, 100.0, ch_names=["a", "b"])
        view = EDFReader(path).pick(["a"])
        with pytest.raises(ValueError, match="re-pick"):
            EDFSource(view, picks=["a"])


class TestAnnotations:
    def test_edfplus_roundtrip_and_markers(self, tmp_path):
        from ninwavelets_tpu.io.edf import EDFReader, write_edf
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 2500)).astype(np.float32)
        anns = [(0.5, 0.0, "stim/A"), (3.25, 0.5, "stim/B"),
                (7.8, 0.0, "response")]
        p = str(tmp_path / "rec.edf")
        write_edf(p, x, 250.0, annotations=anns)
        r = EDFReader(p)
        # data untouched by the extra signal
        assert r.ch_names == ["ch0", "ch1", "ch2"]
        got = r.get_data()
        err = np.abs(got - x).max()
        assert err < np.abs(x).max() / 1000
        # annotations round-trip (onset, duration, text)
        back = r.read_annotations()
        assert back == [(0.5, 0.0, "stim/A"), (3.25, 0.5, "stim/B"),
                        (7.8, 0.0, "response")]
        # marker convention at the recording rate
        assert r.markers == [(125, "Annotation", "stim/A"),
                             (812, "Annotation", "stim/B"),
                             (1950, "Annotation", "response")]

    def test_epochs_from_edf_markers(self, tmp_path):
        """The full event workflow straight off an EDF+ file:
        annotations -> marker epochs -> ERP."""
        import ninwavelets_tpu as nw
        from ninwavelets_tpu.io.edf import write_edf
        rng = np.random.default_rng(1)
        n, sfreq = 20000, 250.0
        x = 0.2 * rng.standard_normal((2, n)).astype(np.float32)
        bump = np.exp(-0.5 * ((np.arange(150) - 75) / 20.0) ** 2)
        events = [1000, 5000, 9000, 13000]
        for s in events:
            x[0, s:s + 150] += 3.0 * bump.astype(np.float32)
        write_edf(str(tmp_path / "rec.edf"), x, sfreq,
                  ch_names=["c0", "c1"],
                  annotations=[(s / sfreq, 0.0, "stim") for s in events])
        rw = nw.RawWavelet.from_edf(str(tmp_path / "rec.edf"),
                                    nw.Morse(sfreq))
        ew = rw.epochs_from_markers(-0.1, 0.5, description="stim")
        assert len(ew.epochs) == 4
        ev = np.asarray(ew.evoked())[0]
        assert abs(int(np.argmax(ev)) - (25 + 75)) < 10

    def test_no_annotations_plain_edf(self, tmp_path):
        from ninwavelets_tpu.io.edf import EDFReader, write_edf
        x = np.zeros((2, 500), np.float32)
        p = str(tmp_path / "plain.edf")
        write_edf(p, x, 250.0)
        r = EDFReader(p)
        assert r.read_annotations() == []
        assert r.markers == []


class TestAnnotationPrecision:
    def test_late_onset_keeps_subsecond_precision(self, tmp_path):
        """%g-style 6-significant-digit formatting would shift an
        8-hour onset by tens of ms — the writer must keep full
        sub-second precision at any onset."""
        from ninwavelets_tpu.io.edf import EDFReader, write_edf
        n = 250 * 40
        x = np.zeros((1, n), np.float32)
        p = str(tmp_path / "long.edf")
        # recording "starts" late via a large onset near the end
        write_edf(p, x, 250.0, annotations=[(28.805504, 0.0, "late")])
        back = EDFReader(p).read_annotations()
        assert back == [(28.805504, 0.0, "late")]

    def test_out_of_range_annotation_raises(self, tmp_path):
        from ninwavelets_tpu.io.edf import write_edf
        x = np.zeros((1, 2500), np.float32)
        with pytest.raises(ValueError, match="outside the recording"):
            write_edf(str(tmp_path / "a.edf"), x, 250.0,
                      annotations=[(11.0, 0.0, "late")])
        with pytest.raises(ValueError, match="outside the recording"):
            write_edf(str(tmp_path / "b.edf"), x, 250.0,
                      annotations=[(-0.5, 0.0, "early")])
        # exactly-at-end lands in the last record, not dropped
        from ninwavelets_tpu.io.edf import EDFReader
        p = str(tmp_path / "c.edf")
        write_edf(p, x, 250.0, annotations=[(10.0, 0.0, "end")])
        assert EDFReader(p).read_annotations() == [(10.0, 0.0, "end")]
