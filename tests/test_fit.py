"""Gradient-based fitting: frequency grids and free-form banks (extension
— the reference has no gradients at all)."""
import jax.numpy as jnp
import numpy as np
import pytest

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops.bank import make_fft_bank
from ninwavelets_tpu.ops.cwt import mean_power_from_bank
from ninwavelets_tpu.ops.fit import fit_frequencies, learn_bank

SFREQ, N = 1000.0, 1024


def _tone_epochs(f0=60.0, e=6, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SFREQ
    return np.stack([
        np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        + 0.2 * rng.standard_normal(N) for _ in range(e)
    ]).astype(np.float32)[:, None, :]


def test_fit_frequencies_converges_to_tone():
    """Rows initialized far from a 60 Hz tone descend onto it; the loss
    is monotone-ish decreasing end to end."""
    morse = nw.Morse(SFREQ)
    f_fit, losses = fit_frequencies(_tone_epochs(), morse._wdef(),
                                    [40.0, 75.0], SFREQ, steps=150,
                                    lr=0.02)
    f_fit = np.asarray(f_fit)
    np.testing.assert_allclose(f_fit, 60.0, atol=1.0)
    assert float(losses[-1]) < float(losses[0])
    assert np.all(f_fit > 0)          # log-space parameterization


def test_learn_bank_recovers_target():
    """A perturbed wavelet bank descends back toward the target TFR; the
    'power' loss runs too (no target needed)."""
    morse = nw.Morse(SFREQ)
    freqs = np.arange(30.0, 90.0, 5.0, np.float32)
    bank0 = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(freqs), N, SFREQ, True), np.float32))
    sig = jnp.asarray(_tone_epochs(seed=1))
    target = mean_power_from_bank(sig, bank0, True)
    bank, losses = learn_bank(sig, bank0 * 1.3, target, steps=100, lr=5e-3)
    assert float(losses[-1]) < 0.15 * float(losses[0])
    got = np.asarray(mean_power_from_bank(sig, bank, True))
    want = np.asarray(target)
    assert np.abs(got - want).max() < 0.35 * np.abs(want).max()

    _, pl = learn_bank(sig, bank0, loss="power", steps=5, lr=1e-3)
    assert float(pl[-1]) <= float(pl[0])

    with pytest.raises(ValueError, match="target"):
        learn_bank(sig, bank0, None, loss="mse", steps=1)
    with pytest.raises(ValueError, match="loss"):
        learn_bank(sig, bank0, target, loss="nope", steps=1)


def test_learn_bank_matches_optax_autodiff():
    """learn_bank (analytic-adjoint gradient each step) follows the same
    descent as a plain optax loop over autodiff of the XLA forward."""
    import jax
    import optax
    morse = nw.Morse(SFREQ)
    freqs = np.arange(30.0, 90.0, 10.0, np.float32)
    bank0 = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(freqs), 2048, SFREQ, True), np.float32))
    rng = np.random.default_rng(2)
    sig = jnp.asarray(rng.standard_normal((4, 1, 2048)).astype(np.float32))
    target = mean_power_from_bank(sig, bank0, True)
    b_a, l_a = learn_bank(sig, bank0 * 1.2, target, steps=10, lr=1e-3)

    opt = optax.adam(1e-3)
    loss = jax.jit(jax.value_and_grad(lambda b: jnp.mean(jnp.square(
        mean_power_from_bank(sig, b, True) - target))))
    b, state, l_x = bank0 * 1.2, None, []
    state = opt.init(b)
    for _ in range(10):
        val, g = loss(b)
        updates, state = opt.update(g, state, b)
        b = optax.apply_updates(b, updates)
        l_x.append(float(val))
    np.testing.assert_allclose(np.asarray(l_a), np.asarray(l_x),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(np.asarray(b_a), np.asarray(b),
                               rtol=1e-2, atol=1e-5)


def test_learn_bank_complex_pair_boundary():
    """A complex (Normal/Twice) initialization enters and leaves as a
    (real, imag) float pair — complex64 never crosses the jit boundary."""
    mh = nw.MexicanHat(SFREQ)
    from ninwavelets_tpu.ops.bank import make_fft_bank_ri
    br, bi = make_fft_bank_ri(mh._wdef(),
                              jnp.asarray(np.arange(20.0, 60.0, 5.0),
                                          jnp.float32),
                              N, SFREQ, True, mh.real_wave_length)
    assert bi is not None
    sig = jnp.asarray(_tone_epochs(f0=40.0, seed=3))
    import jax.lax as lax
    import jax
    target = jax.jit(lambda s, r, i: __import__(
        'ninwavelets_tpu.ops.cwt', fromlist=['mean_power_from_bank']
    ).mean_power_from_bank(s, lax.complex(r, i), True))(sig, br, bi)
    (lr_, li_), losses = __import__(
        'ninwavelets_tpu.ops.fit', fromlist=['learn_bank']).learn_bank(
        sig, br * 1.2, target, steps=20, lr=2e-3, bank0_i=bi * 1.2)
    assert lr_.dtype == jnp.float32 and li_.dtype == jnp.float32
    assert float(losses[-1]) < float(losses[0])


def test_uniform_grid_hint_rejects_degenerate():
    from ninwavelets_tpu.ops.sst import uniform_grid_hint
    assert uniform_grid_hint([40.0, 40.0, 40.0]) is None   # df = 0
    assert uniform_grid_hint([50.0, 40.0, 30.0]) is None   # descending
