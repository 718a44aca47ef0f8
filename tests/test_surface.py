"""Public-surface tests: exports, plotting (headless), demo driver, error
paths, and reference-API details not covered elsewhere."""
import importlib.util
import os
import sys

import matplotlib
matplotlib.use("Agg")

import numpy as np
import pytest

import ninwavelets_tpu as nw


class TestExports:
    def test_reference_surface_complete(self):
        """Everything the reference __init__ exports
        (``/root/reference/ninwavelets/__init__.py:1-3``) exists here."""
        for name in ["WaveletBase", "WaveletMode", "plot_tf", "Baseline",
                     "Morse", "MorseMNE", "Morlet", "Haar", "MexicanHat",
                     "Shannon", "EpochsWavelet"]:
            assert hasattr(nw, name), name

    def test_mode_enum_members(self):
        """All five reference modes, incl. the never-used Indifferentiable
        (``base.py:126-142``)."""
        for m in ["Normal", "Both", "Reverse", "Indifferentiable", "Twice"]:
            assert hasattr(nw.WaveletMode, m)

    def test_freq_dist_recorded(self):
        m = nw.Morse(1000)
        m.make_fft_wavelets(np.arange(10.0, 20.0, 2.0))
        assert m.freq_dist == pytest.approx(2.0)

    def test_cuda_flag_accepted_and_ignored(self):
        m = nw.Morse(1000, cuda=True)
        p = np.asarray(m.power(np.ones(500, np.float32), [10.0]))
        assert p.shape == (1, 500)


class TestPlotting:
    def test_plot_wavelet_smoke(self):
        m = nw.Morse(1000)
        fig = m.plot(10.0, show=False)
        assert fig is not None
        import matplotlib.pyplot as plt
        assert len(fig.axes) == 3  # time trace + 3D + help text (Morse)
        plt.close("all")

    def test_plot_tf_smoke(self):
        data = np.random.default_rng(0).random((20, 100))
        ax = nw.plot_tf(data, 1000, frange=(0, 20, 5), trange=(0, 0.1, 0.05),
                        show=False)
        assert ax is not None
        import matplotlib.pyplot as plt
        plt.close("all")

    @staticmethod
    def _scalp(c=32):
        """Upper-hemisphere Fibonacci montage (realistic scalp cover)."""
        i = np.arange(c, dtype=np.float64) + 0.5
        phi = np.arccos(1 - i / c)          # polar angle < 90 deg
        th = np.pi * (1 + 5 ** 0.5) * i
        return np.stack([np.sin(phi) * np.cos(th),
                         np.sin(phi) * np.sin(th), np.cos(phi)], axis=1)

    def test_plot_topomap_interpolates_electrode_values(self):
        from ninwavelets_tpu.utils.plotting import (_disc_projection,
                                                    _topo_grid)
        pos = self._scalp()
        vals = pos[:, 2] ** 2 - pos[:, 0]   # smooth field
        img, rad = _topo_grid(vals, pos, res=128, lam=1e-8)
        p2d = _disc_projection(pos)
        xs = np.linspace(-rad, rad, 128)
        ix = np.clip(np.searchsorted(xs, p2d[:, 0]), 0, 127)
        iy = np.clip(np.searchsorted(xs, p2d[:, 1]), 0, 127)
        got = img[iy, ix]                   # row = y, col = x
        err = np.nanmax(np.abs(got - vals))
        assert err < 0.15 * np.abs(vals).max()   # nearest-pixel slack
        ax = nw.plot_topomap(vals, pos, show=False)
        assert ax is not None
        import matplotlib.pyplot as plt
        plt.close("all")

    def test_plot_microstates_grid(self):
        pos = self._scalp(16)
        maps = np.stack([pos[:, 0], pos[:, 1], pos[:, 2]])
        stats = {"coverage": np.array([0.5, 0.3, 0.2])}
        fig = nw.plot_microstates(maps, pos, stats=stats, show=False)
        assert len(fig.axes) == 3
        assert "A" in fig.axes[0].get_title()
        assert "50%" in fig.axes[0].get_title()
        import matplotlib.pyplot as plt
        plt.close("all")


class TestDemo:
    def test_demo_sin_headless(self, capsys):
        spec = importlib.util.spec_from_file_location(
            "demo", os.path.join(os.path.dirname(__file__), "..",
                                 "examples", "demo.py"))
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        demo.main(["sin"])
        out = capsys.readouterr().out
        assert "60 Hz" in out


class TestErrorPaths:
    def test_morse_mne_requires_mne(self):
        m = nw.MorseMNE(1000)
        with pytest.raises(ImportError, match="mne"):
            m.cwt(np.ones(100), [10.0])

    def test_empty_freqs(self):
        with pytest.raises(ValueError):
            nw.Morse(1000).cwt(np.ones(100, np.float32), [])

    def test_cwt_without_bank_or_freqs(self):
        with pytest.raises(ValueError):
            nw.Morse(1000).cwt(np.ones(100, np.float32))

    def test_size_error_is_exception(self):
        from ninwavelets_tpu.ops.signal_utils import SizeError
        with pytest.raises(SizeError, match="boom"):
            raise SizeError("boom")


class TestTwiceMode:
    def test_explicit_twice_mode_runs(self):
        """mode=Twice routed through the iFFT->reFFT path
        (``base.py:249-256``): switch a Morse instance like the reference
        demo flips modes at runtime."""
        m = nw.Morse(1000)
        m.mode = nw.WaveletMode.Twice
        c = m.cwt(np.sin(2 * np.pi * 40 * np.arange(1000) / 1000.0),
                  [30.0, 40.0])
        assert c.shape == (2, 1000)
        assert np.isfinite(c).all()

    def test_runtime_mode_switch_changes_bank(self):
        m = nw.Morlet(1000)
        freqs = [20.0]
        bank_both = np.asarray(m.make_fft_wavelets(freqs))
        m.mode = nw.WaveletMode.Twice
        bank_twice = np.asarray(m.make_fft_wavelets(freqs))
        assert bank_both.shape == bank_twice.shape
        assert not np.allclose(bank_both, bank_twice)


class TestCacheKeys:
    """Regression: jit cache keys must include wavelet hyper-parameters."""

    def test_parameter_mutation_retraces(self):
        sig = np.sin(2 * np.pi * 40 * np.arange(1000) / 1000.0)
        m = nw.Morse(1000)
        p1 = np.asarray(m.power(sig, [30.0, 40.0], reuse=False))
        m.b = 5.0
        p2 = np.asarray(m.power(sig, [30.0, 40.0], reuse=False))
        fresh = np.asarray(nw.Morse(1000, b=5.0).power(sig, [30.0, 40.0],
                                                       reuse=False))
        assert not np.allclose(p1, p2)
        np.testing.assert_allclose(p2, fresh, rtol=1e-5)

    def test_identical_instances_share_key(self):
        a, b = nw.Morse(1000), nw.Morse(1000)
        assert a._wdef() == b._wdef()
        assert hash(a._wdef()) == hash(b._wdef())
        b2 = nw.Morse(1000, b=5.0)
        assert a._wdef() != b2._wdef()

    def test_fft_wavelets_lazy_property(self):
        m = nw.Morse(1000)
        with pytest.raises(AttributeError):
            _ = m.fft_wavelets
        m.cwt(np.ones(500, np.float32), [10.0, 20.0])
        assert m.fft_wavelets.shape == (2, 500)


class TestGuards:
    def test_mismatched_bank_rejected(self):
        """A bank built for another signal length would sample the wavelet
        at the wrong frequency resolution: refused with a clear error."""
        from ninwavelets_tpu.ops import cwt
        import jax.numpy as jnp
        bank = jnp.ones((16, 4096), jnp.float32)
        with pytest.raises(ValueError, match="bank length"):
            cwt.mean_power(jnp.ones((2, 1, 2048), jnp.float32), bank,
                           interpolate=True)

    def test_halo_requires_freq_domain_mode(self):
        from ninwavelets_tpu.parallel import halo_samples
        mex = nw.MexicanHat(1000)
        with pytest.raises(ValueError, match="Reverse/Both"):
            halo_samples(mex._wdef(), 5.0, 1000.0)


class TestWorkflowDemo:
    def test_workflow_demo_headless(self, capsys):
        spec = importlib.util.spec_from_file_location(
            "workflow_demo", os.path.join(os.path.dirname(__file__), "..",
                                          "examples", "workflow_demo.py"))
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        demo.main()
        out = capsys.readouterr().out
        assert "kept 35/40" in out
        assert "3/3 planted events" in out
        assert "partial coherence 0.0" in out
        assert "long-range correlated" in out


class TestSourceDemo:
    def test_source_demo_headless(self, capsys):
        spec = importlib.util.spec_from_file_location(
            "source_demo", os.path.join(os.path.dirname(__file__), "..",
                                        "examples", "source_demo.py"))
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        demo.main()
        out = capsys.readouterr().out
        assert "top-3 NAI sources [4, 11, 22]" in out
        assert "planted 20" in out
        assert "sloreta: top-3 sources [4, 11, 22]" in out
