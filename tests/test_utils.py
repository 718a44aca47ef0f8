"""Tooltip utilities, observability, config dataclasses, streaming CWT."""
import doctest
import logging
import operator

import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu import config as cfg
from ninwavelets_tpu.parallel import StreamingCWT
from ninwavelets_tpu.utils import observability, tooltip
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu.ops.cwt import power as power_jit

import jax.numpy as jnp


class TestTooltip:
    def test_doctests(self):
        results = doctest.testmod(tooltip)
        assert results.failed == 0, results

    def test_parallel_runs_in_order(self):
        p = tooltip.Parallel(3)
        for i in range(5):
            p.append(operator.mul, i, 10)
        assert p.run() == [0, 10, 20, 30, 40]
        assert "mul" in repr(p)

    def test_sequence_chain(self):
        out = (tooltip.Sequence([1, 2, 3, 4])
               .map(lambda x: x * 2)
               .filter(lambda x: x > 2)
               .reduce(operator.add))
        assert out == 18

    def test_sequence_parallel_map(self):
        seq = tooltip.Sequence(range(10), core=4)
        assert seq.map(lambda x: x * x).get() == [i * i for i in range(10)]

    def test_sequence_protocols(self):
        s = tooltip.Sequence([5, 6, 7])
        assert len(s) == 3 and s[1] == 6 and list(s) == [5, 6, 7]
        assert (s & [8]).to_list() == [5, 6, 7, 8]
        assert str(s) == "Sequence: [5, 6, 7]"

    def test_starmap(self):
        s = tooltip.Sequence(zip([1, 2], [3, 4])).starmap(operator.mul)
        assert s.get() == [3, 8]

    def test_compose_dict_map_csv(self):
        assert tooltip.compose(str, len)(1234) == 4
        assert tooltip.dict_map(abs, {"a": -1}) == {"a": 1}
        assert tooltip.oneline_csv(1, "x") == "1,x\n"
        assert tooltip.not_none(0) and not tooltip.not_none(None)


class TestObservability:
    def test_timer_blocks(self):
        sig = jnp.ones((8, 256), jnp.float32)
        bank = jnp.ones((4, 256), jnp.float32)
        with observability.Timer("t") as t:
            out = power_jit(sig, bank)
            t.block(out)
        assert t.elapsed > 0

    def test_cwt_cost_model(self):
        cost = observability.cwt_cost(batch=8, n_freqs=100, n=2048)
        assert cost.flops > 1e8
        assert cost.hbm_bytes < cost.coeff_bytes * 4
        assert cost.arithmetic_intensity > 1

    def test_debug_nans_toggle(self):
        import jax
        with observability.debug_nans(True):
            assert jax.config.jax_debug_nans
        assert not jax.config.jax_debug_nans

    def test_logger_is_quiet(self):
        log = logging.getLogger("ninwavelets_tpu")
        assert any(isinstance(h, logging.NullHandler) for h in log.handlers)


class TestConfig:
    def test_morse_defaults_match_reference(self):
        c = cfg.MorseConfig()
        assert (c.sfreq, c.b, c.r, c.interpolate) == (1000.0, 17.5, 3.0,
                                                      False)
        m = c.build()
        assert isinstance(m, nw.Morse) and m.b == 17.5

    def test_morlet_defaults(self):
        c = cfg.MorletConfig()
        assert c.sigma == 7.0
        m = c.build()
        assert isinstance(m, nw.Morlet) and not m.gabor

    def test_pipeline_compose(self):
        p = cfg.PipelineConfig(baseline=(0.0, 0.2))
        assert p.engine.mesh_shape == (1, 1, 1)
        assert p.baseline_method == "zscore"


class TestStreaming:
    def test_streamed_matches_whole_signal_interior(self):
        sfreq, n = 1000.0, 8192
        t = np.arange(n) / sfreq
        sig = (np.sin(2 * np.pi * 60 * t)
               + 0.3 * np.sin(2 * np.pi * 31 * t)).astype(np.float32)
        freqs = np.arange(25.0, 80.0, 5.0, dtype=np.float32)
        morse = nw.Morse(sfreq)
        s = StreamingCWT(morse._wdef(), freqs, sfreq, window=2048,
                         halo_tol=1e-5)
        got = s.power(sig)
        bank = make_fft_bank(morse._wdef(), jnp.asarray(freqs), n, sfreq)
        want = np.asarray(power_jit(jnp.asarray(sig), jnp.asarray(bank)))
        assert got.shape == want.shape
        m = s.halo
        err = np.abs(got[:, m:-m] - want[:, m:-m]).max()
        assert err < 1e-3 * np.abs(want).max()

    def test_streaming_blocks_cover_signal(self):
        morse = nw.Morse(1000)
        s = StreamingCWT(morse._wdef(), [40.0, 50.0], 1000.0, window=1000,
                         halo=300)
        sig = np.random.default_rng(0).standard_normal(2500).astype(
            np.float32)
        blocks = list(s.blocks(sig))
        starts = [b[0] for b in blocks]
        assert starts == [0, 1000, 2000]
        assert blocks[-1][1].shape == (2, 500)

    def test_halo_must_fit_window(self):
        morse = nw.Morse(1000)
        with pytest.raises(ValueError):
            StreamingCWT(morse._wdef(), [1.0], 1000.0, window=128)


class TestPipeline:
    def test_run_pipeline(self):
        import numpy as np

        class FakeEpochs:
            info = {'sfreq': 1000.0}
            ch_names = ['a', 'b']
            def get_data(self):
                rng = np.random.default_rng(0)
                t = np.arange(600) / 1000.0
                return (np.sin(2 * np.pi * 30 * t)[None, None, :]
                        + 0.2 * rng.standard_normal((4, 2, 600)))

        p = cfg.PipelineConfig(baseline=(0.0, 0.1),
                               freqs=(5.0, 65.0, 1.0))
        out = cfg.run_pipeline(p, FakeEpochs())
        assert np.asarray(out["power"]).shape == (2, 60, 600)
        assert np.asarray(out["itc"]).shape == (2, 60, 600)
        # zscore baseline: the corrected window should center near zero
        win = np.asarray(out["power"])[:, :, :100]
        assert abs(win.mean()) < 1.0
        # without a baseline the power is the plain epoch mean
        p2 = cfg.PipelineConfig(freqs=(5.0, 65.0, 1.0))
        out2 = cfg.run_pipeline(p2, FakeEpochs())
        assert np.asarray(out2["power"]).shape == (2, 60, 600)
        from ninwavelets_tpu.utils.mne_adapter import EpochsWavelet
        ew = EpochsWavelet(FakeEpochs(), p2.wavelet.build())
        np.testing.assert_allclose(
            np.asarray(out2["power"]),
            np.asarray(ew.power_all(np.arange(5.0, 65.0, 1.0))),
            rtol=1e-5, atol=1e-6 * float(np.abs(out2["power"]).max()))

    def test_connectivity_stages(self):
        import numpy as np

        class FakeEpochs:
            info = {'sfreq': 1000.0}
            ch_names = ['a', 'b', 'c']
            def get_data(self):
                rng = np.random.default_rng(1)
                t = np.arange(512) / 1000.0
                base = np.sin(2 * np.pi * 40 * t)
                data = np.stack([base, base, np.cos(2 * np.pi * 25 * t)])
                return data[None] + 0.2 * rng.standard_normal((6, 3, 512))

        p = cfg.PipelineConfig(freqs=(20.0, 60.0, 5.0),
                               connectivity="both",
                               connectivity_window=(0.1, 0.4))
        out = cfg.run_pipeline(p, FakeEpochs())
        m = np.asarray(out["plv_matrix"])
        c = np.asarray(out["coherence_matrix"])
        assert m.shape == (8, 3, 3) and c.shape == (8, 3, 3)
        row = 4   # 40 Hz
        assert m[row, 0, 1] > 0.9 > m[row, 0, 2] + 0.2
        np.testing.assert_allclose(
            c[:, np.arange(3), np.arange(3)], 1.0, rtol=1e-4)

        with pytest.raises(ValueError, match="connectivity"):
            cfg.run_pipeline(
                cfg.PipelineConfig(connectivity="nope"), FakeEpochs())

        # Phase-lag + PPC stages: comma-separated subset selection.
        p = cfg.PipelineConfig(freqs=(20.0, 60.0, 5.0),
                               connectivity="wpli,ppc,pli")
        out = cfg.run_pipeline(p, FakeEpochs())
        for key in ("wpli_matrix", "ppc_matrix", "pli_matrix"):
            assert np.asarray(out[key]).shape == (8, 3, 3), key
        # channels 0/1 are a common source at zero lag: PPC (like PLV)
        # sees them; the phase-lag family must not.
        w = np.asarray(out["wpli_matrix"])
        pp = np.asarray(out["ppc_matrix"])
        assert pp[row, 0, 1] > 0.8
        assert not w[row, 0, 1] > 0.5

        # r4 additions: partial coherence + directed PSI stages.
        p = cfg.PipelineConfig(freqs=(20.0, 60.0, 5.0),
                               connectivity="pcoh,psi")
        out = cfg.run_pipeline(p, FakeEpochs())
        pc = np.asarray(out["partial_coherence"])
        z = np.asarray(out["psi_matrix"])
        assert pc.shape == (8, 3, 3) and z.shape == (3, 3)
        np.testing.assert_allclose(
            pc[:, np.arange(3), np.arange(3)], 1.0, atol=1e-4)
        np.testing.assert_allclose(z, -z.T, atol=1e-4)


class TestCoverageGaps:
    def test_profiler_trace_smoke(self, tmp_path):
        import jax.numpy as jnp
        with observability.trace(str(tmp_path)):
            jnp.square(jnp.arange(8.0)).block_until_ready()
        assert any(tmp_path.iterdir())   # trace files written

    def test_tooltip_process_pool(self):
        p = tooltip.Parallel(2, processes=True)
        p.append(abs, -3).append(abs, -4)
        assert p.run() == [3, 4]

    def test_sequence_process_map(self):
        s = tooltip.Sequence([1, 2, 3], core=2, processes=True)
        assert s.map(abs).get() == [1, 2, 3]

    def test_icwt_complex_signal_no_mirror(self):
        import jax.numpy as jnp
        from ninwavelets_tpu.ops.icwt import icwt_from_bank
        from ninwavelets_tpu.ops.cwt import cwt_from_bank
        n = 1000
        t = np.arange(n) / 1000.0
        analytic = np.exp(2j * np.pi * 60 * t).astype(np.complex64)
        morse = nw.Morse(1000.0)
        bank = make_fft_bank(morse._wdef(),
                             jnp.arange(5.0, 200.0), n, 1000.0)
        c = cwt_from_bank(jnp.asarray(analytic), bank)
        rec = np.asarray(icwt_from_bank(c, bank, real_signal=False))
        assert np.abs(rec - analytic).max() < 1e-3


class TestStreamingBatched:
    def test_batched_windows_match_oracle(self):
        """Window batching (3 windows per device call, a ragged tail
        batch) against the float64 oracle's whole-signal power."""
        import reference_oracle as ro
        sfreq, n = 1000.0, 8192
        t = np.arange(n) / sfreq
        sig = (np.sin(2 * np.pi * 60 * t)
               + 0.3 * np.sin(2 * np.pi * 31 * t)).astype(np.float32)
        freqs = np.arange(25.0, 80.0, 5.0, dtype=np.float32)
        morse = nw.Morse(sfreq)
        s = StreamingCWT(morse._wdef(), freqs, sfreq, window=1024,
                         halo=512, interpolate=True, batch=3)
        got = s.power(sig)
        want = np.abs(ro.cwt(sig, "morse", freqs, sfreq, True)) ** 2
        m = s.halo
        err = np.abs(got - want)[:, m:-m].max()
        assert err < 1e-3 * np.abs(want).max(), err

    def test_halo_rounds_up_to_power_of_two(self):
        """A window whose extended length is not a power of two (1000 +
        2*300) gets its halo rounded up and still streams correctly."""
        morse = nw.Morse(1000)
        s = StreamingCWT(morse._wdef(), [40.0, 50.0], 1000.0, window=1000,
                         halo=300)
        ext = s.window + 2 * s.halo
        assert s.halo >= 300 and ext & (ext - 1) == 0
        sig = np.random.default_rng(1).standard_normal(4000).astype(
            np.float32)
        bank = make_fft_bank(morse._wdef(), jnp.asarray([40.0, 50.0]),
                             4000, 1000.0)
        want = np.asarray(power_jit(jnp.asarray(sig), jnp.asarray(bank)))
        got = s.power(sig)
        m = s.halo
        err = np.abs(got - want)[:, m:-m].max()
        assert err < 1e-3 * np.abs(want).max(), err


def test_power_device_matches_host_blocks():
    """On-device assembly (one dynamic_update_slice per window batch)
    must equal the host-assembled plane, including the ragged tail."""
    morse = nw.Morse(1000)
    s = StreamingCWT(morse._wdef(), [30.0, 60.0], 1000.0, window=1000,
                     halo=300, batch=2)
    sig = np.random.default_rng(5).standard_normal(3500).astype(np.float32)
    host = s.power(sig)
    dev = np.asarray(s.power_device(sig))
    assert dev.shape == host.shape == (2, 3500)
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-8)


def test_streaming_multichannel_matches_per_channel():
    """(C, N) signals ride the device batch alongside the windows; the
    result must equal per-channel streaming exactly."""
    morse = nw.Morse(1000)
    s = StreamingCWT(morse._wdef(), [30.0, 50.0], 1000.0, window=1000,
                     halo=300)
    sig = np.random.default_rng(3).standard_normal((3, 2500)).astype(
        np.float32)
    multi = s.power(sig)
    assert multi.shape == (3, 2, 2500)
    for ch in range(3):
        np.testing.assert_allclose(multi[ch], s.power(sig[ch]),
                                   rtol=1e-6, atol=1e-7)
    dev = np.asarray(s.power_device(sig))
    np.testing.assert_allclose(dev, multi, rtol=1e-5, atol=1e-6)


def test_pipeline_ssq_stage():
    import numpy as np

    class FakeEpochs:
        info = {'sfreq': 1000.0}
        ch_names = ['a']
        def get_data(self):
            rng = np.random.default_rng(2)
            t = np.arange(512) / 1000.0
            return (np.sin(2 * np.pi * 40 * t)[None, None, :]
                    + 0.1 * rng.standard_normal((4, 1, 512)))

    out = cfg.run_pipeline(
        cfg.PipelineConfig(freqs=(20.0, 60.0, 5.0), ssq=True), FakeEpochs())
    s = np.asarray(out["ssq_power"])
    p = np.asarray(out["power"])
    assert s.shape == p.shape == (1, 8, 512)
    # Reassignment concentrates the 40 Hz tone's band energy
    row = 4
    band = slice(3, 6)
    m = 100
    conc_s = s[0, row, m:-m].sum() / max(s[0, band, m:-m].sum(), 1e-12)
    conc_p = p[0, row, m:-m].sum() / max(p[0, band, m:-m].sum(), 1e-12)
    assert conc_s > conc_p


def test_pipeline_all_stages_integration():
    """Everything-on pipeline over the reference's golden composite signal:
    power, itc, baseline, significance, COI/global spectrum, ridge, ssq,
    and connectivity all come back shape-consistent from one config."""
    import numpy as np
    from conftest import make_example

    base = make_example(1.0)
    rng = np.random.default_rng(5)

    class FakeEpochs:
        info = {'sfreq': 1000.0}
        ch_names = ['a', 'b']
        def get_data(self):
            return np.stack([
                np.stack([base + 0.05 * rng.standard_normal(base.shape),
                          base + 0.05 * rng.standard_normal(base.shape)])
                for _ in range(4)])

    p = cfg.PipelineConfig(freqs=(20.0, 340.0, 20.0),
                           baseline=(0.0, 0.1),
                           significance=0.95,
                           global_spectrum=True,
                           ridge=True,
                           ssq=True,
                           superlet=(1, 4),
                           connectivity="both",
                           connectivity_window=(0.1, 0.9),
                           cluster_test=True,
                           cluster_adjacency=((0, 1),),
                           cluster_n_perm=29)
    out = cfg.run_pipeline(p, FakeEpochs())
    n_f, n = 16, 1000
    assert np.asarray(out["power"]).shape == (2, n_f, n)
    assert np.asarray(out["itc"]).shape == (2, n_f, n)
    assert np.asarray(out["significant"]).dtype == bool
    assert out["coi"].shape == (n_f, n)
    assert np.asarray(out["global_spectrum"]).shape == (2, n_f)
    assert out["ridge_hz"].shape == (2, n)
    assert np.asarray(out["ssq_power"]).shape == (2, n_f, n)
    assert np.asarray(out["superlet_power"]).shape == (2, n_f, n)
    assert np.asarray(out["plv_matrix"]).shape == (n_f, 2, 2)
    assert np.asarray(out["coherence_matrix"]).shape == (n_f, 2, 2)
    assert out["cluster"].t_obs.shape == (2, n_f, n)
    assert out["cluster"].null_max.shape == (29,)
    # The golden signal's steady 60 Hz: both channels share it ->
    # off-diagonal PLV high at the 60 Hz row.
    row = int(np.argmin(np.abs(np.arange(20.0, 340.0, 20.0) - 60.0)))
    assert np.asarray(out["plv_matrix"])[row, 0, 1] > 0.9


def test_streaming_ssq_matches_whole_signal_interior():
    """Streamed synchrosqueezing: interiors must match the whole-signal
    reassigned plane (frequency reassignment is time-local; edges differ
    by the per-window noise-gate floor and the halo)."""
    from ninwavelets_tpu.ops.sst import ssq_power

    sfreq, n = 1000.0, 8192
    t = np.arange(n) / sfreq
    sig = (np.sin(2 * np.pi * 60 * t)
           + 0.5 * np.sin(2 * np.pi * 33 * t)).astype(np.float32)
    freqs = np.arange(25.0, 80.0, 5.0, dtype=np.float32)
    morse = nw.Morse(sfreq)
    s = StreamingCWT(morse._wdef(), freqs, sfreq, window=2048,
                     halo_tol=1e-5, interpolate=True)
    got = np.asarray(s.ssq_power_device(sig))
    bank = make_fft_bank(morse._wdef(), jnp.asarray(freqs), n, sfreq, True)
    want = np.asarray(ssq_power(sig, jnp.asarray(np.asarray(
        bank, np.float32)), freqs, sfreq, interpolate=True))
    assert got.shape == want.shape
    m = s.halo + 128
    err = np.abs(got[:, m:-m] - want[:, m:-m]).max()
    assert err < 2e-3 * np.abs(want).max()

    # complex banks are rejected
    mh = nw.MexicanHat(sfreq)
    with pytest.raises(ValueError, match="analytic"):
        StreamingCWT(mh._wdef(), [40.0], sfreq, window=1024,
                     halo=256).ssq_power_device(sig[:2048])


def test_pipeline_cluster_requires_baseline():
    import numpy as np
    import pytest

    class FakeEpochs:
        info = {'sfreq': 500.0}
        ch_names = ['a']
        def get_data(self):
            return np.random.default_rng(0).standard_normal((4, 1, 128))

    with pytest.raises(ValueError, match="baseline"):
        cfg.run_pipeline(cfg.PipelineConfig(freqs=(20.0, 40.0, 10.0),
                                            cluster_test=True),
                         FakeEpochs())


class TestReport:
    def test_full_report_roundtrip(self, tmp_path):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import ninwavelets_tpu as nw

        rep = nw.Report(title="Subject 01 <QA>")
        fig, ax = plt.subplots()
        ax.plot([0, 1, 2], [1, 4, 9])
        rep.add_figure("Power spectrum", fig, caption="demo & caption")
        rep.add_table("Peaks", {"channel": ["Cz", "Pz"],
                                "latency_ms": [301.5, 287.0]})
        rep.add_dict("Summary", {"n_epochs": 40, "gev": 0.93,
                                 "matrix": np.zeros((3, 3))})
        rep.add_text("Notes", "run 2 excluded <artifacts>")
        p = str(tmp_path / "report.html")
        assert rep.save(p) == p
        html_out = open(p, encoding="utf-8").read()
        # one self-contained file: inline PNG, no external refs
        assert "data:image/png;base64," in html_out
        assert "Subject 01 &lt;QA&gt;" in html_out      # escaped title
        assert "demo &amp; caption" in html_out
        assert "301.5" in html_out and "Cz" in html_out
        assert "array(3, 3)" in html_out
        assert "run 2 excluded &lt;artifacts&gt;" in html_out
        # nav links to every section
        for i in range(4):
            assert f'href="#s{i}"' in html_out

    def test_table_validation(self):
        import ninwavelets_tpu as nw
        rep = nw.Report()
        with pytest.raises(ValueError, match="share a length"):
            rep.add_table("bad", {"a": [1, 2], "b": [1]})
