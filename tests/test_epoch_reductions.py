"""Epoch reductions on the XLA path against the float64 oracle.

Every epoch reduction the engine offers — mean power, ITC, both in one
pass, coherence, imaginary coherency, PLV, PPC and the phase-lag family —
is checked against ``tests/reference_oracle.py`` (numpy, float64) across
geometries: N = 1024 / 2048 / 2000, ragged epoch counts, analytic and
two-sided spectra, real and complex (Normal/Twice-mode) banks.  The
gradient rule — the analytic adjoint behind
``ops.cwt.mean_power_adjoint_from_bank`` — is checked against autodiff of
the plain forward at matmul precision "highest".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ninwavelets_tpu as nw
import reference_oracle as ro
from ninwavelets_tpu.ops import cwt
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu.ops.cwt import (_mean_power_bwd, _mean_power_bwd_complex,
                                     mean_power_adjoint_from_bank,
                                     mean_power_from_bank)

#: The repo's parity gate (tests/test_parity.py); float32 XLA reaches
#: ~120-135 dB on these reductions.
SNR_DB = 90.0


def _workload(n=2048, nf=100, e=4, c=3, interpolate=True, seed=0):
    sfreq = 1000.0
    morse = nw.Morse(sfreq)
    bank = np.asarray(make_fft_bank(morse._wdef(),
                                    jnp.arange(1.0, nf + 1.0), n, sfreq,
                                    interpolate), np.float32)
    sig = np.random.default_rng(seed).standard_normal((e, c, n)).astype(
        np.float32)
    return sig, bank


def _complex_workload(n, e, c, f0=5.0, f1=45.0, seed=4):
    sfreq = 1000.0
    mh = nw.MexicanHat(sfreq)
    bank = make_fft_bank(mh._wdef(), jnp.arange(f0, f1), n, sfreq, True)
    assert jnp.iscomplexobj(bank)
    sig = np.random.default_rng(seed).standard_normal((e, c, n)).astype(
        np.float32)
    return sig, np.asarray(bank)


def _pair(e, c, n, nf, interpolate, seed=17):
    sa, bank = _workload(e=e, c=c, nf=nf, n=n, interpolate=interpolate)
    rng = np.random.default_rng(seed)
    # a correlated component so the pair statistics are non-trivial
    sb = (0.6 * sa + 0.8 * rng.standard_normal(sa.shape)).astype(np.float32)
    return sa, sb, bank


def _assert_snr(want, got, gate=SNR_DB):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    snr = ro.snr_db(want[finite], got[finite])
    assert snr >= gate, snr


def _assert_close_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("interpolate", [True, False])
def test_mean_power_matches_oracle(interpolate):
    sig, bank = _workload(interpolate=interpolate)
    got = cwt.mean_power(sig, bank, interpolate=interpolate)
    _assert_snr(ro.mean_power(sig, bank, interpolate), got)


def test_mean_power_n1024_small_bank():
    sig, bank = _workload(n=1024, nf=37, e=8, c=2)
    _assert_snr(ro.mean_power(sig, bank, True),
                cwt.mean_power(sig, bank, interpolate=True))


def test_mean_power_sixteen_epochs():
    """16 epochs in one scan: the running sum over epochs must equal the
    oracle's epoch mean."""
    sig, bank = _workload(e=16, c=2, nf=24)
    _assert_snr(ro.mean_power(sig, bank, True),
                cwt.mean_power(sig, bank, interpolate=True))


def test_default_precision_within_gate():
    """The default-precision program (no matmul-precision override) meets
    the 90 dB gate at the 100-frequency bench bank."""
    sig, bank = _workload(e=8, c=4)
    got = jax.jit(lambda s, b: mean_power_from_bank(s, b, True))(sig, bank)
    _assert_snr(ro.mean_power(sig, bank, True), got)


def test_mean_power_any_geometry():
    """The XLA path takes every geometry: no channel axis, N that is not a
    power of two, a complex bank."""
    sig, bank = _workload(n=2000, nf=12, e=3, c=2)
    _assert_snr(ro.mean_power(sig, bank, True),
                cwt.mean_power(sig, bank, interpolate=True))
    flat = sig[:, 0, :]                                   # (E, N)
    _assert_snr(ro.mean_power(flat, bank, True),
                cwt.mean_power(flat, bank, interpolate=True))
    csig, cbank = _complex_workload(2000, e=3, c=2)
    _assert_snr(ro.mean_power(csig, cbank, True),
                cwt.mean_power(csig, cbank.real, cbank.imag,
                               interpolate=True))


def test_mean_power_ragged_epoch_count():
    """An epoch count that divides nothing (19) needs no padding on the
    scan path and must match the oracle's mean."""
    sig, bank = _workload(e=19, c=2, nf=16)
    _assert_snr(ro.mean_power(sig, bank, True),
                cwt.mean_power(sig, bank, interpolate=True))


def test_itc_ragged_epoch_count():
    sig, bank = _workload(e=19, c=1, nf=8)
    _assert_snr(ro.itc(sig, bank, True),
                cwt.itc(sig, bank, interpolate=True))


def test_entry_point_matches_traced_program():
    """The float-boundary entry point runs the same program as the traced
    function under jit."""
    sig, bank = _workload(e=4, c=2, nf=16)
    want = np.asarray(jax.jit(
        lambda s, b: mean_power_from_bank(s, b, True))(sig, bank))
    got = np.asarray(cwt.mean_power(jnp.asarray(sig), jnp.asarray(bank),
                                    interpolate=True))
    # Separate executables of the same program can differ by ~1e-5 on the
    # CPU backend (FFT thread-scheduling nondeterminism); the gate checks
    # "same math", not bit-identity.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("e", [4, 16])
def test_itc_matches_oracle(e):
    sig, bank = _workload(e=e, c=2, nf=24)
    _assert_snr(ro.itc(sig, bank, True),
                cwt.itc(sig, bank, interpolate=True))


def test_itc_identical_epochs_is_one():
    """Identical epochs -> unit phase coherence everywhere |c| > 0."""
    sig, bank = _workload(e=1, c=1, nf=16)
    sig = np.repeat(sig, 4, axis=0)
    got = np.asarray(cwt.itc(sig, bank, interpolate=True))
    finite = np.isfinite(got)
    np.testing.assert_allclose(got[finite], 1.0, atol=1e-4)


def test_itc_entry_point_matches_traced_program():
    from ninwavelets_tpu.ops.cwt import itc_from_bank
    sig, bank = _workload(e=4, c=2, nf=16)
    want = np.asarray(jax.jit(
        lambda s, b: itc_from_bank(s, b, True))(sig, bank))
    got = np.asarray(cwt.itc(jnp.asarray(sig), jnp.asarray(bank),
                             interpolate=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_adjoint_matches_autodiff():
    """The analytic adjoint behind ``mean_power_adjoint_from_bank`` gives
    the autodiff gradient of the plain forward."""
    sig, bank = _workload(e=4, c=2, nf=16)
    sig_j, bank_j = jnp.asarray(sig), jnp.asarray(bank)
    with jax.default_matmul_precision("highest"):
        g_adj = jax.grad(lambda s: mean_power_adjoint_from_bank(
            s, bank_j, True).sum())(sig_j)
        g_xla = jax.grad(lambda s: mean_power_from_bank(
            s, bank_j, True).sum())(sig_j)
    _assert_close_grad(g_adj, g_xla)


def test_adjoint_matches_autodiff_both_args():
    """Both gradients — signals and bank — through the custom VJP, with a
    ragged epoch count and a weighted (non-uniform) cotangent."""
    rng = np.random.default_rng(7)
    sig, bank = _workload(e=19, c=2, nf=16)
    w = jnp.asarray(rng.standard_normal((2, 16, 2048)).astype(np.float32))
    sig_j, bank_j = jnp.asarray(sig), jnp.asarray(bank)

    def loss_adj(s, b):
        return jnp.sum(w * mean_power_adjoint_from_bank(s, b, True))

    def loss_xla(s, b):
        return jnp.sum(w * mean_power_from_bank(s, b, True))

    with jax.default_matmul_precision("highest"):
        gs_a, gb_a = jax.jit(jax.grad(loss_adj, argnums=(0, 1)))(sig_j,
                                                                  bank_j)
        gs_x, gb_x = jax.jit(jax.grad(loss_xla, argnums=(0, 1)))(sig_j,
                                                                 bank_j)
    _assert_close_grad(gs_a, gs_x)
    _assert_close_grad(gb_a, gb_x)


def test_complex_bank_matches_oracle():
    """Normal/Twice-mode families (complex banks): power and itc against
    the oracle."""
    sig, bank = _complex_workload(2048, e=6, c=2)
    _assert_snr(ro.mean_power(sig, bank, True),
                cwt.mean_power(sig, bank.real, bank.imag, interpolate=True))
    _assert_snr(ro.itc(sig, bank, True),
                cwt.itc(sig, bank.real, bank.imag, interpolate=True))


def test_complex_bank_float_pair_wrapper():
    """The public wrapper takes the (real, imag) float pair and assembles
    the complex bank inside the program."""
    sig, bank = _complex_workload(1024, e=3, c=2, f0=10.0, f1=26.0, seed=5)
    want = np.asarray(jax.jit(
        lambda s, b: mean_power_from_bank(s, b, True))(sig, bank))
    got = np.asarray(cwt.mean_power(sig, jnp.asarray(bank.real),
                                    jnp.asarray(bank.imag),
                                    interpolate=True))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    _assert_snr(ro.mean_power(sig, bank, True), got)


def test_complex_bank_adjoint_matches_autodiff():
    """jax.grad works on the complex-bank adjoint path."""
    sig, bank = _complex_workload(1024, e=3, c=2, f0=10.0, f1=26.0, seed=6)
    sig, bank = jnp.asarray(sig), jnp.asarray(bank)
    with jax.default_matmul_precision("highest"):
        g_adj = jax.grad(lambda s: mean_power_adjoint_from_bank(
            s, bank, True).sum())(sig)
        g_xla = jax.grad(lambda s: mean_power_from_bank(
            s, bank, True).sum())(sig)
    _assert_close_grad(g_adj, g_xla)


@pytest.mark.parametrize("interpolate", [True, False])
def test_real_bank_adjoint_matches_vjp(interpolate):
    """The real-bank adjoint reproduces jax.vjp of the forward on both
    cotangents, on both spectrum conventions, with a bank count (13) that
    divides nothing."""
    rng = np.random.default_rng(11)
    sig, bank = _workload(e=5, c=2, nf=13, interpolate=interpolate)
    g = jnp.asarray(rng.standard_normal((2, 13, 2048)).astype(np.float32))
    sig_j, bank_j = jnp.asarray(sig), jnp.asarray(bank)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda s, b: mean_power_from_bank(s, b, interpolate),
            sig_j, bank_j)
        ds_w, db_w = vjp(g)
        ds_g, db_g = jax.jit(
            lambda s, b, gg: _mean_power_bwd(s, b, interpolate, gg))(
            sig_j, bank_j, g)
    _assert_close_grad(ds_g, ds_w)
    _assert_close_grad(db_g, db_w)


def test_power_itc_grad_matches_itc():
    """The ITC half of the one-pass ``power_itc_from_bank`` has the same
    gradient as ``itc_from_bank``."""
    from ninwavelets_tpu.ops.cwt import itc_from_bank, power_itc_from_bank
    sig, bank = _workload(e=4, c=2, nf=16)
    sig_j, bank_j = jnp.asarray(sig), jnp.asarray(bank)
    g_one = jax.grad(lambda s: power_itc_from_bank(
        s, bank_j, True)[1].sum())(sig_j)
    g_xla = jax.grad(lambda s: itc_from_bank(s, bank_j, True).sum())(sig_j)
    _assert_close_grad(g_one, g_xla)


@pytest.mark.parametrize("interpolate", [True, False])
def test_complex_bank_adjoint_matches_vjp(interpolate):
    """The complex-bank adjoint's conjugation conventions (conj(bank) in
    dS, conj(u)*S in dbank) reproduce jax.vjp of the XLA forward for BOTH
    cotangents."""
    rng = np.random.default_rng(3)
    e, c, f, n = 4, 2, 6, 1024
    sig = jnp.asarray(rng.standard_normal((e, c, n)).astype(np.float32))
    bank = jnp.asarray((rng.standard_normal((f, n))
                        + 1j * rng.standard_normal((f, n))
                        ).astype(np.complex64))
    g = jnp.asarray(rng.standard_normal((c, f, n)).astype(np.float32))

    _, vjp = jax.vjp(lambda s, b: mean_power_from_bank(s, b, interpolate),
                     sig, bank)
    ds_w, db_w = vjp(g)
    ds_g, db_g = _mean_power_bwd_complex(sig, bank, interpolate, g)
    _assert_close_grad(ds_g, ds_w)
    _assert_close_grad(db_g, db_w)


@pytest.mark.parametrize("e", [4, 19])
def test_power_itc_matches_oracle(e):
    """One pass over the epochs reproduces BOTH reductions."""
    sig, bank = _workload(e=e, c=2, nf=16)
    p, i = cwt.power_itc(sig, bank, interpolate=True)
    _assert_snr(ro.mean_power(sig, bank, True), p)
    _assert_snr(ro.itc(sig, bank, True), i)


@pytest.mark.parametrize("interpolate", [True, False])
def test_custom_vjp_random_complex_bank(interpolate):
    """The custom VJP with a random complex bank (complex dbank) matches
    jax.vjp of the plain forward."""
    rng = np.random.default_rng(13)
    e, c, f, n = 4, 2, 13, 2048
    sig = jnp.asarray(rng.standard_normal((e, c, n)).astype(np.float32))
    bank = jnp.asarray((rng.standard_normal((f, n))
                        + 1j * rng.standard_normal((f, n))
                        ).astype(np.complex64))
    g = jnp.asarray(rng.standard_normal((c, f, n)).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        _, vjp_w = jax.vjp(
            lambda s, b: mean_power_from_bank(s, b, interpolate), sig, bank)
        _, vjp_a = jax.vjp(
            lambda s, b: mean_power_adjoint_from_bank(s, b, interpolate),
            sig, bank)
        ds_w, db_w = vjp_w(g)
        ds_g, db_g = vjp_a(g)
    _assert_close_grad(ds_g, ds_w)
    _assert_close_grad(db_g, db_w)


@pytest.mark.parametrize("e,n", [(4, 2048), (4, 1024), (11, 2048)])
@pytest.mark.parametrize("interpolate", [True, False])
def test_coherence_matches_oracle(e, n, interpolate):
    """Epoch coherence and imaginary coherency (one set of four epoch
    sums) against the oracle — aligned and ragged pair counts."""
    from ninwavelets_tpu.ops.extensions import (epoch_coherence_from_bank,
                                                imcoh_from_bank)
    sa, sb, bank = _pair(e, 2, n, 13, interpolate)
    got = jax.jit(lambda a, b, k: epoch_coherence_from_bank(
        a, b, k, interpolate))(sa, sb, bank)
    _assert_snr(ro.coherence(sa, sb, bank, interpolate), got)
    got = jax.jit(lambda a, b, k: imcoh_from_bank(
        a, b, k, interpolate))(sa, sb, bank)
    _assert_snr(ro.imcoh(sa, sb, bank, interpolate), got)


@pytest.mark.parametrize("e", [4, 11])
def test_plv_ppc_match_oracle(e):
    """PLV and PPC (the same unit cross-phase sums) against the oracle."""
    from ninwavelets_tpu.ops.connectivity import plv, ppc
    sa, sb, bank = _pair(e, 2, 2048, 13, True, seed=19)
    _assert_snr(ro.plv(sa, sb, bank, True),
                plv(sa, sb, bank, interpolate=True))
    _assert_snr(ro.ppc(sa, sb, bank, True),
                ppc(sa, sb, bank, interpolate=True))


@pytest.mark.parametrize("method", ["wpli", "dwpli"])
def test_phase_lag_matches_oracle(method):
    """wPLI and debiased wPLI^2 against the oracle (PLI counts signs, so
    cells whose lag sits at zero may flip under round-off; its parity is
    in tests/test_connectivity.py)."""
    from ninwavelets_tpu.ops.connectivity import phase_lag
    sa, sb, bank = _pair(6, 2, 1024, 13, True, seed=23)
    _assert_snr(ro.phase_lag(sa, sb, bank, True, method),
                phase_lag(sa, sb, bank, method=method, interpolate=True))
