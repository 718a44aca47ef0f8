"""Superlets (fractional adaptive superresolution transform — extension;
Moca et al. 2021).  The reference has no counterpart; these gate the
implementation's own contracts."""
import jax.numpy as jnp
import numpy as np

import ninwavelets_tpu as nw
from ninwavelets_tpu.ops.superlets import (superlet_mean_power,
                                           superlet_power,
                                           superlet_weights)

SFREQ = 1000.0


def test_weights_schedule():
    freqs = np.linspace(10.0, 100.0, 10)
    w = superlet_weights(freqs, order_min=2, order_max=7, adaptive=True)
    assert w.shape == (7, 10)
    # column sums ARE the fractional orders, linear from o_min to o_max
    np.testing.assert_allclose(w.sum(0), np.linspace(2.0, 7.0, 10),
                               rtol=1e-6)
    assert w.min() >= 0.0 and w.max() <= 1.0
    # non-adaptive: full order everywhere
    w0 = superlet_weights(freqs, order_min=2, order_max=7, adaptive=False)
    np.testing.assert_allclose(w0.sum(0), 7.0)
    import pytest
    with pytest.raises(ValueError):
        superlet_weights(freqs, order_min=0, order_max=3)
    with pytest.raises(ValueError):
        superlet_weights(freqs, order_min=5, order_max=3)


def test_tone_peak_and_order1_reduces_to_morlet():
    t = np.arange(2048) / SFREQ
    sig = np.sin(2 * np.pi * 60 * t).astype(np.float32)
    freqs = np.arange(30.0, 90.0, 3.0)
    p = np.asarray(superlet_power(jnp.asarray(sig), freqs, SFREQ,
                                  base_sigma=3.0, order_max=6))
    assert freqs[int(np.argmax(p.mean(-1)))] == 60.0
    # order 1 with one member IS that Morlet's power
    p1 = np.asarray(superlet_power(jnp.asarray(sig), freqs, SFREQ,
                                   base_sigma=3.0, order_min=1,
                                   order_max=1))
    want = np.asarray(nw.Morlet(SFREQ, sigma=3.0).power(sig, freqs))
    np.testing.assert_allclose(p1, want, rtol=2e-4, atol=1e-8)


def test_superresolution_separates_close_tones():
    """Two tones 6 Hz apart that a 3-cycle Morlet smears together: the
    superlet's multiplicative fusion deepens the valley between them."""
    t = np.arange(4096) / SFREQ
    sig = (np.sin(2 * np.pi * 50 * t)
           + np.sin(2 * np.pi * 56 * t)).astype(np.float32)
    freqs = np.arange(40.0, 67.0, 1.0)
    m = 800
    i50 = int(np.argmin(np.abs(freqs - 50.0)))
    i53 = int(np.argmin(np.abs(freqs - 53.0)))
    i56 = int(np.argmin(np.abs(freqs - 56.0)))

    def profile(order):
        p = np.asarray(superlet_power(jnp.asarray(sig), freqs, SFREQ,
                                      base_sigma=3.0, order_min=order,
                                      order_max=order, adaptive=False))
        pr = p[:, m:-m].mean(-1)
        return pr / pr.max()

    p1 = profile(1)
    # the single 3-cycle Morlet does NOT resolve: the midpoint is the max
    assert p1[i53] >= p1[i50] and p1[i53] >= p1[i56]
    p12 = profile(12)
    # the order-12 superlet does: two peaks at the tones, deep valley
    top2 = freqs[np.argsort(p12)[-2:]]
    assert set(np.round(top2)) == {50.0, 56.0}
    assert p12[i53] < 0.5 * min(p12[i50], p12[i56])


def test_time_localization_survives_high_order():
    """A 100 ms burst: the adaptive superlet keeps the burst's temporal
    footprint close to the short wavelet's (the point of the method —
    a single long wavelet would smear it)."""
    t = np.arange(4096) / SFREQ
    burst = np.zeros(4096, np.float32)
    w = slice(2000, 2100)
    burst[w] = np.sin(2 * np.pi * 60 * t[w]).astype(np.float32)
    freqs = np.arange(45.0, 76.0, 3.0)
    row = int(np.argmin(np.abs(freqs - 60.0)))

    def halfwidth(p):
        tr = p[row]
        half = tr.max() * 0.5
        return int(np.sum(tr > half))

    p_slt = np.asarray(superlet_power(jnp.asarray(burst), freqs, SFREQ,
                                      base_sigma=3.0, order_max=8))
    p_short = np.asarray(nw.Morlet(SFREQ, sigma=3.0).power(burst, freqs))
    p_long = np.asarray(nw.Morlet(SFREQ, sigma=24.0).power(burst, freqs))
    # tighter than the longest member, no wider than the shortest
    assert halfwidth(p_slt) < 0.8 * halfwidth(p_long)
    assert halfwidth(p_slt) <= halfwidth(p_short) + 5


def test_mean_power_matches_per_epoch_mean():
    rng = np.random.default_rng(0)
    sigs = rng.standard_normal((5, 1024)).astype(np.float32)
    freqs = np.arange(20.0, 60.0, 5.0)
    want = np.mean([np.asarray(superlet_power(jnp.asarray(s), freqs, SFREQ,
                                              order_max=4))
                    for s in sigs], axis=0)
    got = np.asarray(superlet_mean_power(jnp.asarray(sigs), freqs, SFREQ,
                                         order_max=4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


def test_class_frontend():
    sl = nw.Superlet(SFREQ, sigma=3.0, order_max=5)
    t = np.arange(1024) / SFREQ
    sig = np.sin(2 * np.pi * 40 * t)
    freqs = np.arange(20.0, 60.0, 4.0)
    p = np.asarray(sl.power(sig, freqs))
    assert p.shape == (freqs.size, 1024)
    assert freqs[int(np.argmax(p.mean(-1)))] == 40.0
    ep = np.asarray(sl.mean_power(np.stack([sig, sig]), freqs))
    np.testing.assert_allclose(ep, p, rtol=1e-6, atol=1e-9)
    import pytest
    with pytest.raises(ZeroDivisionError):
        sl.power(sig, [0.0])


def test_sharded_superlet_matches_single_device():
    from ninwavelets_tpu import parallel as par
    from ninwavelets_tpu.ops.superlets import (superlet_banks,
                                               superlet_weights)
    mesh = par.make_mesh(data=2, freq=4)
    freqs = np.arange(16.0, 48.0, 4.0)                  # 8 rows / 4 shards
    rng = np.random.default_rng(2)
    sigs = jnp.asarray(rng.standard_normal((4, 1, 1024)).astype(np.float32))
    banks = superlet_banks(freqs, 1024, SFREQ, order_max=4)
    w = jnp.asarray(superlet_weights(freqs, order_max=4))
    want = np.asarray(superlet_mean_power(sigs, freqs, SFREQ, order_max=4))
    got = np.asarray(par.sharded_superlet_mean_power(sigs, banks, w,
                                                     mesh=mesh))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
