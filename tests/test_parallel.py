"""Sharded-engine tests on the 8-device virtual CPU mesh.

Correctness bar (SURVEY §4): the same math on one device and on a sharded
mesh must agree to float32 round-off — the sharded programs are the single-
device programs plus collectives, nothing else.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu import parallel as par
from ninwavelets_tpu.ops import cwt as ops_cwt
from ninwavelets_tpu.ops.bank import make_fft_bank
import reference_oracle as ro


def _morse_bank(n, sfreq=1000.0, freqs=None, interpolate=False):
    morse = nw.Morse(sfreq)
    freqs = np.arange(10, 90, dtype=np.float32) if freqs is None else freqs
    bank = make_fft_bank(morse._wdef(), jnp.asarray(freqs), n, sfreq,
                         interpolate)
    return np.asarray(bank, dtype=np.float32), freqs


def _epochs_block(e=8, c=3, n=500, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 1000.0
    sig = np.sin(2 * np.pi * 40 * t)[None, None, :]
    return (sig + 0.3 * rng.standard_normal((e, c, n))).astype(np.float32)


class TestShardedReductions:
    def test_mean_power_matches_single_device(self):
        mesh = par.make_mesh(data=4, freq=2)
        sig = _epochs_block()
        bank, _ = _morse_bank(sig.shape[-1])
        want = np.asarray(ops_cwt.mean_power(jnp.asarray(sig),
                                             jnp.asarray(bank)))
        got = np.asarray(par.sharded_mean_power(jnp.asarray(sig),
                                                jnp.asarray(bank), mesh=mesh))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)

    def test_itc_matches_single_device(self):
        mesh = par.make_mesh(data=2, freq=4)
        sig = _epochs_block(e=6)
        bank, _ = _morse_bank(sig.shape[-1])
        want = np.asarray(ops_cwt.itc(jnp.asarray(sig), jnp.asarray(bank)))
        got = np.asarray(par.sharded_itc(jnp.asarray(sig), jnp.asarray(bank),
                                         mesh=mesh))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)

    def test_cwt_ri_and_power_sharded(self):
        mesh = par.make_mesh(data=8, freq=1)
        sig = _epochs_block(e=8, c=2, n=256)
        bank, _ = _morse_bank(256, freqs=np.arange(20, 52, dtype=np.float32))
        wr, wi = ops_cwt.cwt_ri(jnp.asarray(sig), jnp.asarray(bank))
        gr, gi = par.sharded_cwt_ri(jnp.asarray(sig), jnp.asarray(bank),
                                    mesh=mesh)
        np.testing.assert_allclose(np.asarray(gr), np.asarray(wr),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gi), np.asarray(wi),
                                   rtol=2e-5, atol=1e-5)
        wp = np.asarray(ops_cwt.power(jnp.asarray(sig), jnp.asarray(bank)))
        gp = np.asarray(par.sharded_power(jnp.asarray(sig),
                                          jnp.asarray(bank), mesh=mesh))
        np.testing.assert_allclose(gp, wp, rtol=2e-5, atol=1e-6)

    def test_complex_bank_family_sharded(self):
        """Normal/Twice-mode (MexicanHat) banks are complex -> the imag bank
        path through shard_map."""
        mesh = par.make_mesh(data=2, freq=2)
        mex = nw.MexicanHat(1000)
        freqs = np.arange(10, 26, dtype=np.float32)
        sig = _epochs_block(e=4, c=2, n=300)
        bank = make_fft_bank(mex._wdef(), jnp.asarray(freqs), 300, 1000.0,
                             False, mex.real_wave_length)
        br = jnp.asarray(np.asarray(bank.real, np.float32))
        bi = jnp.asarray(np.asarray(bank.imag, np.float32))
        want = np.asarray(ops_cwt.mean_power(jnp.asarray(sig), br, bi))
        got = np.asarray(par.sharded_mean_power(jnp.asarray(sig), br, bi,
                                                mesh=mesh))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


class TestChunked:
    def test_halo_samples_reasonable(self):
        morse = nw.Morse(1000)
        h = par.halo_samples(morse._wdef(), min_freq=20.0, sfreq=1000.0)
        # Morse(b=17.5) at 20 Hz lives a few hundred ms; halo must be
        # positive and far below the probe length.
        assert 10 < h < 4000

    def test_chunked_power_matches_whole_signal_interior(self):
        sfreq = 1000.0
        n = 4096
        mesh = par.flat_mesh(par.TIME_AXIS)
        n_dev = mesh.shape[par.TIME_AXIS]
        chunk = n // n_dev
        t = np.arange(n) / sfreq
        sig = (np.sin(2 * np.pi * 60 * t)
               + 0.5 * np.sin(2 * np.pi * 23 * t)).astype(np.float32)
        freqs = np.arange(20, 80, 4, dtype=np.float32)
        morse = nw.Morse(sfreq)
        halo = par.halo_samples(morse._wdef(), float(freqs.min()), sfreq,
                                tol=1e-5)
        assert halo <= chunk, "test geometry: halo must fit in a chunk"
        br, bi = par.chunk_bank(morse._wdef(), freqs, chunk, halo, sfreq)
        got = np.asarray(par.chunked_power(jnp.asarray(sig), br, bi,
                                           mesh=mesh, halo=halo))
        bank_full, _ = _morse_bank(n, sfreq, freqs)
        want = np.asarray(ops_cwt.power(jnp.asarray(sig),
                                        jnp.asarray(bank_full)))
        assert got.shape == want.shape == (len(freqs), n)
        # Interior: away from the global edges, chunked(linear) ==
        # whole-signal(circular) to float32.
        m = halo
        gi, wi = got[:, m:-m], want[:, m:-m]
        err = np.abs(gi - wi)
        scale = np.abs(wi).max()
        assert err.max() < 1e-3 * scale

    def test_chunked_cwt_ri_shapes(self):
        mesh = par.flat_mesh(par.TIME_AXIS)
        n_dev = mesh.shape[par.TIME_AXIS]
        n = 256 * n_dev
        sig = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        freqs = np.arange(30, 46, dtype=np.float32)
        morse = nw.Morse(1000)
        br, bi = par.chunk_bank(morse._wdef(), freqs, 256, 64, 1000.0)
        r, i = par.chunked_cwt_ri(jnp.asarray(sig), br, bi, mesh=mesh,
                                  halo=64)
        assert r.shape == i.shape == (len(freqs), n)


class TestMeshHelpers:
    def test_auto_mesh_factors_all_devices(self):
        mesh = par.auto_mesh()
        assert mesh.devices.size == len(jax.devices())

    def test_make_mesh_too_many_devices_raises(self):
        with pytest.raises(ValueError):
            par.make_mesh(data=64, freq=2)

    def test_pad_to_multiple(self):
        x = np.ones((5, 3))
        y = par.pad_to_multiple(x, 4, axis=0)
        assert y.shape == (8, 3)
        assert np.all(y[5:] == 0)
        assert par.pad_to_multiple(x, 5, axis=0) is x


class TestShardedOracle:
    """The sharded epoch reductions (per-shard XLA scan + pmean) against
    the float64 oracle on the CPU mesh."""

    def test_mean_power_matches_oracle(self):
        mesh = par.make_mesh(data=2, freq=2)
        sig = _epochs_block(e=8, c=2, n=1024)
        bank, _ = _morse_bank(1024, freqs=np.arange(10, 42, dtype=np.float32),
                              interpolate=True)
        got = np.asarray(par.sharded_mean_power(
            jnp.asarray(sig), jnp.asarray(bank), mesh=mesh,
            interpolate=True))
        assert ro.snr_db(ro.mean_power(sig, bank, True), got) >= 90.0

    def test_mean_power_sixteen_local_epochs(self):
        """16 local epochs per shard exercise the vma-cast scan inside
        shard_map."""
        mesh = par.make_mesh(data=2, freq=1)
        sig = _epochs_block(e=32, c=2, n=1024)
        bank, _ = _morse_bank(1024, freqs=np.arange(10, 26, dtype=np.float32),
                              interpolate=True)
        got = np.asarray(par.sharded_mean_power(
            jnp.asarray(sig), jnp.asarray(bank), mesh=mesh,
            interpolate=True))
        assert ro.snr_db(ro.mean_power(sig, bank, True), got) >= 90.0

    def test_itc_matches_oracle(self):
        mesh = par.make_mesh(data=2, freq=2)
        sig = _epochs_block(e=8, c=2, n=1024)
        bank, _ = _morse_bank(1024, freqs=np.arange(10, 42, dtype=np.float32),
                              interpolate=True)
        got = np.asarray(par.sharded_itc(
            jnp.asarray(sig), jnp.asarray(bank), mesh=mesh,
            interpolate=True))
        assert ro.snr_db(ro.itc(sig, bank, True), got) >= 90.0


class TestDifferentiability:
    """JAX-native capability the reference cannot offer: gradients flow
    through the whole CWT pipeline (bank synthesis included)."""

    def test_grad_through_mean_power(self):
        import jax
        from ninwavelets_tpu.ops.cwt import mean_power_from_bank
        sig = jnp.asarray(np.random.default_rng(0)
                          .standard_normal((2, 1, 256)).astype(np.float32))
        bank, _ = _morse_bank(256, freqs=np.arange(20, 28,
                                                   dtype=np.float32))
        loss = lambda s: mean_power_from_bank(s, jnp.asarray(bank),
                                              True).sum()
        g = jax.grad(loss)(sig)
        assert g.shape == sig.shape
        assert np.isfinite(np.asarray(g)).all()
        assert np.abs(np.asarray(g)).max() > 0

    def test_grad_through_bank_synthesis(self):
        """d(power)/d(analysis frequency) — the bank is differentiable."""
        import jax
        import ninwavelets_tpu as nw
        from ninwavelets_tpu.ops.bank import make_fft_bank
        from ninwavelets_tpu.ops.cwt import power_from_bank
        morse = nw.Morse(1000.0)
        sig = jnp.asarray(np.sin(2 * np.pi * 40 * np.arange(256) / 1000.0)
                          .astype(np.float32))

        def loss(freq):
            bank = make_fft_bank(morse._wdef(), jnp.stack([freq]), 256,
                                 1000.0, True)
            return power_from_bank(sig, bank, True).sum()

        g = jax.grad(loss)(jnp.float32(35.0))
        assert np.isfinite(float(g))
        # Moving the analysis freq toward the signal's 40 Hz raises power.
        assert float(g) > 0


class TestDistributedAPI:
    """High-level wavelet-object-in, sharded-TFR-out wrappers."""

    def test_distributed_mean_power_matches_single_device(self):
        from ninwavelets_tpu.ops import cwt as ops_cwt
        sig = _epochs_block(e=8, c=2, n=512)
        morse = nw.Morse(1000.0, interpolate=True)
        mesh = par.make_mesh(data=4, freq=2)
        got = np.asarray(par.distributed_mean_power(
            sig, morse, np.arange(10.0, 42.0), 1000.0, mesh=mesh))
        bank = make_fft_bank(morse._wdef(), jnp.arange(10.0, 42.0), 512,
                             1000.0, True)
        want = np.asarray(ops_cwt.mean_power(
            jnp.asarray(sig), jnp.asarray(np.asarray(bank, np.float32)),
            interpolate=True))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)

    def test_distributed_mean_power_ragged_epochs(self):
        """E not divisible by the data axis: zero-pad + rescale."""
        from ninwavelets_tpu.ops import cwt as ops_cwt
        sig = _epochs_block(e=7, c=2, n=512)
        morse = nw.Morse(1000.0)
        mesh = par.make_mesh(data=4, freq=1)
        got = np.asarray(par.distributed_mean_power(
            sig, morse, np.arange(10.0, 26.0), 1000.0, mesh=mesh))
        bank = make_fft_bank(morse._wdef(), jnp.arange(10.0, 26.0), 512,
                             1000.0, False)
        want = np.asarray(ops_cwt.mean_power(
            jnp.asarray(sig), jnp.asarray(np.asarray(bank, np.float32))))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)

    def test_distributed_itc_divisibility(self):
        sig = _epochs_block(e=7, c=1, n=512)
        with pytest.raises(ValueError, match="divide"):
            par.distributed_itc(sig, nw.Morse(1000.0), [20.0], 1000.0,
                                mesh=par.make_mesh(data=4, freq=1))

    def test_distributed_itc_matches_single_device(self):
        from ninwavelets_tpu.ops import cwt as ops_cwt
        sig = _epochs_block(e=8, c=2, n=512)
        morse = nw.Morse(1000.0)
        mesh = par.make_mesh(data=2, freq=2)
        got = np.asarray(par.distributed_itc(
            sig, morse, np.arange(10.0, 42.0), 1000.0, mesh=mesh))
        bank = make_fft_bank(morse._wdef(), jnp.arange(10.0, 42.0), 512,
                             1000.0, False)
        want = np.asarray(ops_cwt.itc(
            jnp.asarray(sig), jnp.asarray(np.asarray(bank, np.float32))))
        # bank built by a different executable (jitted _build) -> ~3e-5
        # f32 rounding skew; gate on same-math, not bit-identity
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_chunked_abs_matches_sqrt_power():
    mesh = par.flat_mesh(par.TIME_AXIS)
    n_dev = mesh.shape[par.TIME_AXIS]
    n = 256 * n_dev
    sig = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    freqs = np.arange(30.0, 46.0, dtype=np.float32)
    morse = nw.Morse(1000)
    br, bi = par.chunk_bank(morse._wdef(), freqs, 256, 64, 1000.0)
    a = np.asarray(par.chunked_abs(jnp.asarray(sig), br, bi, mesh=mesh,
                                   halo=64))
    p = np.asarray(par.chunked_power(jnp.asarray(sig), br, bi, mesh=mesh,
                                     halo=64))
    np.testing.assert_allclose(a * a, p, rtol=1e-4, atol=1e-6)


def test_multihost_two_processes():
    """Real jax.distributed across two CPU processes: 2 x 4 local devices
    form an 8-device global mesh and the sharded epoch-mean runs with the
    pmean crossing the process boundary (examples/multihost_demo.py)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:        # free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = os.path.join(os.path.dirname(__file__), "..", "examples",
                          "multihost_demo.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    procs = [subprocess.Popen(
        [sys.executable, script, str(i), "2", f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
        assert p.returncode == 0, out
    assert any("global=8" in o for o in outs), outs
    assert all("finite=True" in o for o in outs), outs


def test_chunked_power_matches_oracle():
    """Chunked power (halo exchange over the time mesh) against the
    float64 oracle's whole-signal power: interiors agree to the halo
    truncation tolerance."""
    sfreq = 1000.0
    mesh = par.flat_mesh(par.TIME_AXIS)
    n_dev = mesh.shape[par.TIME_AXIS]
    chunk, halo = 1024, 512
    n = chunk * n_dev
    t = np.arange(n) / sfreq
    sig = (np.sin(2 * np.pi * 60 * t)
           + 0.5 * np.sin(2 * np.pi * 23 * t)).astype(np.float32)
    freqs = np.arange(20, 80, 4, dtype=np.float32)
    morse = nw.Morse(sfreq)
    br, bi = par.chunk_bank(morse._wdef(), freqs, chunk, halo, sfreq)
    assert bi is None                        # Morse bank is real
    got = np.asarray(par.chunked_power(jnp.asarray(sig), br, None,
                                       mesh=mesh, halo=halo,
                                       interpolate=True))
    want = np.abs(ro.cwt(sig, "morse", freqs, sfreq, True)) ** 2
    assert got.shape == want.shape == (len(freqs), n)
    err = np.abs(got - want)[:, halo:-halo].max()
    assert err < 1e-3 * np.abs(want).max(), err


def test_chunked_power_two_sided_matches_oracle():
    """Chunked power on the two-sided spectrum (no analytic trick) of a
    noise signal against the float64 oracle's whole-signal power: the
    interiors agree to the halo truncation tolerance."""
    mesh = par.flat_mesh(par.TIME_AXIS)
    n_dev = mesh.shape[par.TIME_AXIS]
    chunk, halo = 1024, 512
    sig = np.random.default_rng(3).standard_normal(
        chunk * n_dev).astype(np.float32)
    freqs = np.arange(30, 46, dtype=np.float32)
    morse = nw.Morse(1000)
    br, bi = par.chunk_bank(morse._wdef(), freqs, chunk, halo, 1000.0)
    got = np.asarray(par.chunked_power(jnp.asarray(sig), br, bi,
                                       mesh=mesh, halo=halo))
    want = np.abs(ro.cwt(sig, "morse", freqs, 1000.0, False)) ** 2
    err = np.abs(got - want)[:, halo:-halo].max()
    assert err < 1e-3 * np.abs(want).max(), err


class TestShardedCrossSignal:
    """Mesh variants of the cross-signal extensions (VERDICT r1 item 8)."""

    def _pair(self, e=8, c=2, n=1024, seed=0):
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((e, c, n)).astype(np.float32)
        other = (0.6 * base
                 + 0.4 * rng.standard_normal((e, c, n))).astype(np.float32)
        freqs = np.arange(20, 52, 4, dtype=np.float32)
        bank, _ = _morse_bank(n, 1000.0, freqs)
        return jnp.asarray(base), jnp.asarray(other), jnp.asarray(bank)

    def test_cross_power_matches_single_device(self):
        from ninwavelets_tpu.ops.extensions import cross_power_from_bank
        sa, sb, bank = self._pair()
        mesh = par.auto_mesh()
        gr, gi = par.sharded_cross_power(sa, sb, bank, mesh=mesh,
                                         interpolate=True)
        wr, wi = jax.jit(lambda a, b, bk: cross_power_from_bank(
            a, b, bk, True))(sa, sb, bank)
        np.testing.assert_allclose(np.asarray(gr), np.asarray(wr),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(gi), np.asarray(wi),
                                   rtol=1e-4, atol=1e-5)

    def test_coherence_matches_single_device(self):
        from ninwavelets_tpu.ops.extensions import epoch_coherence_from_bank
        sa, sb, bank = self._pair()
        mesh = par.auto_mesh()
        got = np.asarray(par.sharded_coherence(sa, sb, bank, mesh=mesh,
                                               interpolate=True))
        want = np.asarray(jax.jit(lambda a, b, bk: epoch_coherence_from_bank(
            a, b, bk, True))(sa, sb, bank))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
        assert got.max() <= 1.0 + 1e-4

    def test_self_coherence_is_one(self):
        sa, _, bank = self._pair()
        mesh = par.auto_mesh()
        got = np.asarray(par.sharded_coherence(sa, sa, bank, mesh=mesh,
                                               interpolate=True))
        np.testing.assert_allclose(got, 1.0, atol=1e-3)

    def test_dead_freq_shard_matches_single_device(self):
        """A frequency shard whose bank rows are ALL dead (zero spectral
        support — a Bump bank outside its band) must return coherence 0
        there, like the single-device path: the relative denominator
        floor's max must complete globally over the freq axis, or the
        dead shard floors against eps*0 and emits 0/0 NaN (r5 review
        finding)."""
        from ninwavelets_tpu.ops.extensions import (
            epoch_coherence_from_bank, imcoh_from_bank)
        sa, sb, bank = self._pair()
        bank = np.array(bank)                # writable copy
        nf = bank.shape[0]
        bank[nf // 2:] = 0.0                 # second freq shard all dead
        bank = jnp.asarray(bank)
        mesh = par.auto_mesh()
        got = np.asarray(par.sharded_coherence(sa, sb, bank, mesh=mesh,
                                               interpolate=True))
        want = np.asarray(jax.jit(
            lambda a, b, bk: epoch_coherence_from_bank(a, b, bk, True)
        )(sa, sb, bank))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
        gi = np.asarray(par.sharded_imcoh(sa, sb, bank, mesh=mesh,
                                          interpolate=True))
        wi = np.asarray(jax.jit(
            lambda a, b, bk: imcoh_from_bank(a, b, bk, True)
        )(sa, sb, bank))
        assert np.isfinite(gi).all()
        np.testing.assert_allclose(gi, wi, rtol=1e-3, atol=1e-5)


def test_sharded_complex_bank_matches_oracle():
    """The sharded reduction with a complex (Twice-mode) bank against the
    float64 oracle."""
    mh = nw.MexicanHat(1000.0)
    from ninwavelets_tpu.ops.bank import make_fft_bank_ri
    n, e, c = 1024, 8, 2
    br, bi = make_fft_bank_ri(mh._wdef(), jnp.arange(8.0, 24.0), n,
                              1000.0, True)
    assert bi is not None
    mesh = par.auto_mesh()
    sig = np.random.default_rng(9).standard_normal((e, c, n)).astype(
        np.float32)
    got = np.asarray(par.sharded_mean_power(jnp.asarray(sig), br, bi,
                                            mesh=mesh, interpolate=True))
    bank = np.asarray(br) + 1j * np.asarray(bi)
    assert ro.snr_db(ro.mean_power(sig, bank, True), got) >= 90.0


def test_sharded_ssq_mean_power_matches_single_device():
    """Synchrosqueezing shards sources over freq and epochs over data;
    psum-completed target planes must equal the single-device epoch mean
    (including the pmax-global noise-gate floor)."""
    from ninwavelets_tpu.ops.sst import ssq_mean_power

    mesh = par.make_mesh(data=2, freq=4)
    sig = _epochs_block(e=4, c=2, n=1024, seed=5)
    freqs = np.arange(20.0, 84.0, 2.0, dtype=np.float32)   # 32 rows / 4
    bank, _ = _morse_bank(1024, freqs=freqs, interpolate=True)
    f_grid = jnp.asarray(freqs)
    want = np.asarray(ssq_mean_power(jnp.asarray(sig), jnp.asarray(bank),
                                     f_grid, 1000.0, interpolate=True))
    got = np.asarray(par.sharded_ssq_mean_power(
        jnp.asarray(sig), jnp.asarray(bank), f_grid, mesh=mesh,
        sfreq=1000.0, interpolate=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def test_sharded_reassigned_mean_power_matches_single_device():
    """2-D reassignment: freq-sharded sources scatter by VALUE into
    full-height planes; psum-completed mesh result must equal the
    single-device epoch mean bit-for-float32."""
    from ninwavelets_tpu.ops.reassign import reassigned_mean_power

    mesh = par.make_mesh(data=2, freq=4)
    sig = _epochs_block(e=4, c=2, n=1024, seed=11)
    freqs = np.arange(20.0, 84.0, 2.0, dtype=np.float32)   # 32 rows / 4
    bank, _ = _morse_bank(1024, freqs=freqs, interpolate=True)
    f_grid = jnp.asarray(freqs)
    want = np.asarray(reassigned_mean_power(
        jnp.asarray(sig), jnp.asarray(bank), f_grid, 1000.0,
        interpolate=True, t_decim=16))
    got = np.asarray(par.sharded_reassigned_mean_power(
        jnp.asarray(sig), jnp.asarray(bank), f_grid, mesh=mesh,
        sfreq=1000.0, interpolate=True, t_decim=16))
    assert got.shape == want.shape == (2, 32, 64)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=1e-6 * want.max())


def test_sharded_mean_power_grad_matches_single_device():
    """The distributed training step: power, signal grad (epoch-sharded, no
    collective) and bank grad (freq-sharded, data-psum-completed) must all
    match jax.vjp of the single-device epoch-mean power."""
    from ninwavelets_tpu.ops.cwt import mean_power_from_bank

    mesh = par.make_mesh(data=2, freq=4)
    sig = jnp.asarray(_epochs_block(e=4, c=2, n=1024, seed=7))
    bank, _ = _morse_bank(1024, freqs=np.arange(20.0, 52.0),
                          interpolate=True)
    bank = jnp.asarray(bank)
    g = jnp.asarray(np.random.default_rng(8)
                    .standard_normal((2, 32, 1024)).astype(np.float32))

    p_want, vjp = jax.vjp(
        lambda s, b: mean_power_from_bank(s, b, True), sig, bank)
    ds_want, db_want = vjp(g)

    p, ds, db = par.sharded_mean_power_grad(sig, bank, g, mesh=mesh,
                                            interpolate=True)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_want),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ds), np.asarray(ds_want),
                               rtol=2e-5,
                               atol=1e-5 * np.abs(np.asarray(ds_want)).max())
    np.testing.assert_allclose(np.asarray(db), np.asarray(db_want),
                               rtol=2e-5,
                               atol=1e-5 * np.abs(np.asarray(db_want)).max())


def test_sharded_power_itc_matches_single_device():
    """The sharded power and itc on a (2, 4) mesh match the single-device
    one-pass ``ops.cwt.power_itc``."""
    mesh = par.make_mesh(data=2, freq=4)
    sig = jnp.asarray(_epochs_block(e=4, c=2, n=1024, seed=11))
    bank, _ = _morse_bank(1024, freqs=np.arange(20.0, 52.0),
                          interpolate=True)
    bank = jnp.asarray(bank)
    p_want, i_want = (np.asarray(x) for x in
                      ops_cwt.power_itc(sig, bank, interpolate=True))
    p = par.sharded_mean_power(sig, bank, mesh=mesh, interpolate=True)
    i = par.sharded_itc(sig, bank, mesh=mesh, interpolate=True)
    np.testing.assert_allclose(np.asarray(p), p_want, rtol=1e-4,
                               atol=1e-5 * np.abs(p_want).max())
    finite = np.isfinite(i_want)
    np.testing.assert_allclose(np.asarray(i)[finite], i_want[finite],
                               rtol=1e-3, atol=1e-4)


def test_sharded_coherence_matches_oracle():
    """Sharded coherence (pmean of the four epoch sums) against the
    float64 oracle."""
    rng = np.random.default_rng(13)
    mesh = par.make_mesh(data=2, freq=4)
    sa = _epochs_block(e=4, c=2, n=1024, seed=13)
    sb = (0.5 * sa + rng.standard_normal(sa.shape)).astype(np.float32)
    bank, _ = _morse_bank(1024, freqs=np.arange(20.0, 52.0),
                          interpolate=True)
    got = np.asarray(par.sharded_coherence(
        jnp.asarray(sa), jnp.asarray(sb), jnp.asarray(bank), mesh=mesh,
        interpolate=True))
    assert ro.snr_db(ro.coherence(sa, sb, bank, True), got) >= 90.0
