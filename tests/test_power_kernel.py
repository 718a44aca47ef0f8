"""The Triton epoch-mean power kernel (``ops.power_kernel``): its arithmetic
in the Pallas interpreter against the float64 oracle, the four-step DFT
geometry and constants, the workload gate, and the dispatch and gradient
rules in ``ops.cwt``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import ninwavelets_tpu as nw
import reference_oracle as ro
from ninwavelets_tpu.ops import cwt, power_kernel
from ninwavelets_tpu.ops.bank import make_fft_bank

N = 2048
#: Every epoch length the kernel serves.
LENGTHS = [n for n in (2 ** k for k in range(16))
           if power_kernel.MIN_N <= n <= power_kernel.MAX_N]


def _bank(nf, n=N, interpolate=True):
    return jnp.asarray(np.asarray(make_fft_bank(
        nw.Morse(1000.0)._wdef(), jnp.arange(1.0, nf + 1.0) * 7.0, n,
        1000.0, interpolate), np.float32))


@pytest.mark.parametrize("e,c,nf,n", [(1, 1, 3, N), (3, 2, 5, N),
                                       (5, 3, 2, N), (3, 2, 3, 512),
                                       (2, 2, 3, 1024), (2, 1, 2, 4096)])
def test_interpret_matches_oracle(e, c, nf, n):
    bank = _bank(nf, n)
    sig = np.random.default_rng(e + c).standard_normal((e, c, n)).astype(
        np.float32)
    got = np.asarray(power_kernel.mean_power(jnp.asarray(sig), bank,
                                             interpret=True))
    assert got.shape == (c, nf, n)
    assert ro.snr_db(ro.mean_power(sig, np.asarray(bank), True), got) >= 90


@pytest.mark.parametrize("n", LENGTHS)
def test_four_step_constants_invert_the_dft(n):
    """The kernel's factorization, replayed in numpy float64 with its own
    constants, is the inverse DFT of the analytic half-spectrum."""
    w1r, w1i, tr, ti, w2r, w2i, w2s = (np.asarray(x, np.float64)
                                       for x in power_kernel._constants(n))
    np.testing.assert_allclose(w2s, w2r + w2i, atol=1e-6)
    _, n2, k1 = power_kernel.geometry(n)
    rng = np.random.default_rng(0)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z[n // 2:] = 0
    zt = z[:n // 2].reshape(k1, n2)
    a = (w1r + 1j * w1i) @ zt
    x = ((a * (tr + 1j * ti)) @ (w2r + 1j * w2i)) / n
    want = np.fft.ifft(z)
    # float32 constants: the factorization is exact to their rounding
    assert ro.snr_db(want, x.T.reshape(-1)) >= 120


@pytest.mark.parametrize("n", LENGTHS)
def test_geometry_fits_triton_dots(n):
    """Every dot operand dimension is a power of two >= 16, the smallest
    tile a Triton dot takes, and the split covers N exactly."""
    n1, n2, k1 = power_kernel.geometry(n)
    assert n1 * n2 == n and k1 * n2 == n // 2
    for d in (n1, n2, k1):
        assert d >= 16 and d & (d - 1) == 0


@pytest.mark.parametrize("shape,dtype,bank_kind,interpolate,want", [
    ((4, 2, N), jnp.float32, "real", True, True),
    ((4, 2, N), jnp.float32, "real", False, False),     # two-sided
    ((4, N), jnp.float32, "real", True, False),         # no channel axis
    ((4, 2, 1024), jnp.float32, "real", True, True),    # shorter epochs
    ((4, 2, 512), jnp.float32, "real", True, True),     # shortest served
    ((4, 2, 256), jnp.float32, "real", True, False),    # below MIN_N
    ((4, 2, 2000), jnp.float32, "real", True, False),   # not a power of 2
    ((2, 2, 2 * power_kernel.MAX_N), jnp.float32, "real", True, False),
    ((4, 2, N), jnp.float32, "complex", True, False),   # Normal/Twice bank
    ((4, 2, N), jnp.complex64, "real", True, False),    # complex signal
])
def test_supports_gate(shape, dtype, bank_kind, interpolate, want):
    n = shape[-1]
    bank = jnp.zeros((3, n), jnp.complex64 if bank_kind == "complex"
                     else jnp.float32)
    assert power_kernel.supports(shape, dtype, bank, interpolate) is want


def _jaxpr(signals, bank, interpolate):
    return str(jax.make_jaxpr(
        lambda s, b: cwt._kernel_or_xla_mean_power(s, b, interpolate))(
        signals, bank))


def test_dispatch_offers_the_kernel_for_cuda_only():
    """A conforming workload traces a platform switch whose CUDA branch is
    the kernel; the CPU program takes the XLA branch and matches it."""
    bank = _bank(4)
    sig = jnp.asarray(np.random.default_rng(1).standard_normal(
        (3, 2, N)).astype(np.float32))
    text = _jaxpr(sig, bank, True)
    assert "platform_index" in text and "pallas_call" in text
    assert "epoch_mean_power" in text
    got = np.asarray(cwt.mean_power(sig, bank, interpolate=True))
    want = np.asarray(jax.jit(lambda s, b: cwt.mean_power_from_bank(
        s, b, True))(sig, bank))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_dispatch_skips_the_kernel_when_it_does_not_apply():
    bank = _bank(4)
    sig = jnp.zeros((3, 2, N), jnp.float32)
    assert "pallas_call" not in _jaxpr(sig, bank, False)
    assert "pallas_call" not in _jaxpr(sig[..., :2000], bank[:, :2000], True)
    assert "pallas_call" not in _jaxpr(sig[..., :256], bank[:, :256], True)


def test_kernel_workload_grad_matches_autodiff():
    """Where the kernel applies, ``mean_power``'s gradient is the analytic
    adjoint and equals autodiff of the plain forward."""
    bank = _bank(4)
    sig = jnp.asarray(np.random.default_rng(2).standard_normal(
        (3, 2, N)).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        got = jax.grad(lambda s: cwt.mean_power(
            s, bank, interpolate=True).sum())(sig)
        want = jax.grad(lambda s: cwt.mean_power_from_bank(
            s, bank, True).sum())(sig)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def mean_power_adjoint(signals, bank):
    return cwt.mean_power_adjoint_from_bank(signals, bank, True).sum()


def test_complex_signal_grad_matches_autodiff():
    """A complex signal (``signal_i``) is outside the kernel and the real-
    signal adjoint: both parts get the autodiff gradient."""
    bank = _bank(4)
    rng = np.random.default_rng(3)
    sr, si = (jnp.asarray(rng.standard_normal((3, 2, N)).astype(np.float32))
              for _ in range(2))

    def loss(a, b):
        return cwt.mean_power(a, bank, None, b, interpolate=True).sum()

    def loss_plain(a, b):
        return cwt.mean_power_from_bank(lax.complex(a, b), bank, True).sum()

    for got, want in zip(jax.grad(loss, argnums=(0, 1))(sr, si),
                         jax.grad(loss_plain, argnums=(0, 1))(sr, si)):
        assert np.abs(np.asarray(want)).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    got = jax.grad(lambda b: mean_power_adjoint(sr + 1j * b, bank))(si)
    want = jax.grad(loss_plain, argnums=1)(sr, si)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,interpolate", [(2000, True), (N, False)])
def test_forward_mode_outside_the_kernel(n, interpolate):
    """Workloads the kernel does not serve keep forward-mode autodiff."""
    bank = _bank(3, n, interpolate)
    rng = np.random.default_rng(4)
    sig, tan = (jnp.asarray(rng.standard_normal((2, 2, n)).astype(
        np.float32)) for _ in range(2))
    _, got = jax.jvp(lambda s: cwt.mean_power(
        s, bank, interpolate=interpolate), (sig,), (tan,))
    _, want = jax.jvp(lambda s: cwt.mean_power_from_bank(
        s, bank, interpolate), (sig,), (tan,))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
