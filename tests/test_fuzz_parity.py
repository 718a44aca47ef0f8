"""Randomized parity sweep: random hyper-parameters, lengths, and frequency
grids against the float64 oracle.  Deterministic seeds, a handful of draws
per family — broad evidence that parity is not tuned to the golden signal.
"""
import numpy as np
import pytest

import reference_oracle as oracle

import ninwavelets_tpu as nw

SFREQ = 1000.0
N_DRAWS = 4


def _random_case(rng):
    n = int(rng.integers(300, 2200))
    lo = float(rng.uniform(1.0, 20.0))
    hi = float(rng.uniform(50.0, 400.0))
    step = float(rng.uniform(3.0, 20.0))
    freqs = np.arange(lo, hi, step)
    t = np.arange(n) / SFREQ
    sig = sum(float(rng.uniform(0.2, 2.0))
              * np.sin(2 * np.pi * float(rng.uniform(3.0, 400.0)) * t
                       + float(rng.uniform(0, 2 * np.pi)))
              for _ in range(4)) + 0.2 * rng.standard_normal(n)
    return sig, freqs


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_morse_random_params(seed):
    rng = np.random.default_rng(100 + seed)
    sig, freqs = _random_case(rng)
    b = float(rng.uniform(5.0, 30.0))
    r = float(rng.uniform(1.5, 5.0))
    interp = bool(rng.integers(0, 2))
    w = nw.Morse(SFREQ, b=b, r=r, interpolate=interp)
    got = np.asarray(w.cwt(sig, freqs))
    want = oracle.cwt(sig, "morse", freqs, SFREQ, interp,
                      params={"b": b, "r": r})
    snr = oracle.snr_db(want, got)
    assert snr > 85.0, (seed, b, r, interp, snr)


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_morlet_random_params(seed):
    rng = np.random.default_rng(200 + seed)
    sig, freqs = _random_case(rng)
    sigma = float(rng.uniform(4.0, 12.0))
    gabor = bool(rng.integers(0, 2))
    interp = bool(rng.integers(0, 2))
    w = nw.Morlet(SFREQ, sigma=sigma, gabor=gabor, interpolate=interp)
    got = np.asarray(w.cwt(sig, freqs))
    want = oracle.cwt(sig, "morlet", freqs, SFREQ, interp,
                      params={"sigma": sigma, "gabor": gabor})
    snr = oracle.snr_db(want, got)
    assert snr > 85.0, (seed, sigma, gabor, interp, snr)


@pytest.mark.parametrize("idx,family",
                         list(enumerate(["shannon", "mexican_hat", "haar"])))
def test_other_families_random_signal(idx, family):
    rng = np.random.default_rng(300 + idx)
    sig, freqs = _random_case(rng)
    cls = {"shannon": nw.Shannon, "mexican_hat": nw.MexicanHat,
           "haar": nw.Haar}[family]
    w = cls(SFREQ)
    got = np.asarray(w.cwt(sig, freqs))
    want = oracle.cwt(sig, family, freqs, SFREQ, False)
    snr = oracle.snr_db(want, got)
    assert snr > 85.0, (family, snr)


@pytest.mark.parametrize("seed", range(N_DRAWS))
def test_mean_power_random_geometry(seed):
    """Randomized epoch-mean power parity against the float64 oracle:
    N in {1024..8192}, random F/E/C, real or complex bank, random
    interpolate."""
    import jax
    import jax.numpy as jnp
    from ninwavelets_tpu.ops.bank import make_fft_bank
    from ninwavelets_tpu.ops.cwt import mean_power_from_bank

    rng = np.random.default_rng(500 + seed)
    n = int(rng.choice([1024, 2048, 4096, 8192]))
    e = int(rng.integers(1, 20))
    c = int(rng.integers(1, 4))
    nf = int(rng.integers(3, 60))
    interp = bool(rng.integers(0, 2))
    complex_bank = bool(rng.integers(0, 2))
    w = (nw.MexicanHat(SFREQ) if complex_bank
         else nw.Morse(SFREQ, b=float(rng.uniform(8, 25))))
    freqs = jnp.asarray(np.linspace(rng.uniform(2, 10),
                                    rng.uniform(50, 300), nf),
                        jnp.float32)
    bank = make_fft_bank(w._wdef(), freqs, n, SFREQ, interp)
    sig = jnp.asarray(rng.standard_normal((e, c, n)).astype(np.float32))
    got = np.asarray(jax.jit(
        lambda s, b: mean_power_from_bank(s, b, interp))(sig, bank))
    want = oracle.mean_power(np.asarray(sig), np.asarray(bank), interp)
    snr = oracle.snr_db(want, got)
    assert snr >= 90.0, (n, e, c, nf, interp, complex_bank, snr)


@pytest.mark.parametrize("seed", range(12))
def test_piecewise_grid_segmentation_fuzz(seed):
    """Random concatenations of arithmetic/geometric runs: the greedy
    segmentation's summed closed forms must equal np.searchsorted exactly
    away from edges, for every grid the hint accepts."""
    from ninwavelets_tpu.ops.sst import _edge_segments, uniform_grid_hint

    rng = np.random.default_rng(seed)
    pieces = []
    f0 = rng.uniform(1.0, 8.0)
    for _ in range(rng.integers(2, 5)):
        kind = rng.choice(["lin", "log"])
        k = int(rng.integers(6, 20))
        if kind == "lin":
            step = rng.uniform(0.5, 6.0)
            seg = f0 + step * np.arange(1, k + 1)
        else:
            r = rng.uniform(1.05, 1.4)
            seg = f0 * r ** np.arange(1, k + 1)
        pieces.append(seg)
        f0 = seg[-1]
    freqs = np.concatenate([[rng.uniform(0.5, 1.0) * pieces[0][0]],
                            *pieces])
    edges = 0.5 * (freqs[1:] + freqs[:-1])
    segs = _edge_segments(edges)
    assert sum(s[3] for s in segs) == edges.size

    probe = np.linspace(0.0, float(freqs[-1]) * 1.3, 4001)
    want = np.searchsorted(edges, probe, side="left")
    got = np.zeros_like(probe)
    for kind, p0, step, m in segs:
        x = np.log(np.maximum(probe, 1e-30)) if kind == "log" else probe
        c = np.where(probe > 0, np.ceil((x - p0) / step), 0.0)
        got += np.clip(c, 0.0, m)
    off_edge = np.abs(probe[:, None] - edges[None, :]).min(1) > 1e-6
    np.testing.assert_array_equal(got[off_edge], want[off_edge])

    hint = uniform_grid_hint(freqs)
    if hint is not None and hint[0] == "pw":
        assert 8 * len(hint[1]) < edges.size
