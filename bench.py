"""Headline benchmark: EEG-seconds/s/chip on the BASELINE workload.

Workload (BASELINE.json north star): Morse CWT power TFR of 64-channel 1 kHz
EEG over 100 analysis frequencies — the bank x FFT x iFFT + |.|^2 +
epoch-mean pipeline (``ops.cwt.mean_power``: the Triton power kernel on
CUDA devices, XLA elsewhere), everything resident on device.

Prints ONE JSON line:
  {"metric": "eeg_seconds_per_s_per_chip", "value": ..., "unit": "EEG-s/s",
   "vs_baseline": ...}

``vs_baseline`` compares against the ACTUAL reference implementation
measured on THIS host's CPU (numpy backend, cupy stubbed, warm bank cache,
the exact same 64ch x 2048-sample x 100-freq workload, per-channel loop as
the reference's EpochsWavelet does): 6.1 ms per channel-call = 5.22
EEG-seconds/s.  For the record, the reference README's own 2018-laptop
numbers (README.md:463-465: 15.9 s for 50 s single-channel = 3.14
signal-s/s = 0.049 EEG-s/s at 64 ch) are ~100x slower still — reported as
``vs_readme_baseline``.  ``vs_target`` is the fraction of the BASELINE.json
north-star target (3600 EEG-s/s/chip = 1 real-time hour/s).
"""
import json
import os
import time

import numpy as np

REF_EEG_SECONDS_PER_S = 5.224              # reference numpy, this host (see above)
REF_README_EEG_SECONDS_PER_S = 3.1446541 / 64.0   # README.md:465 at 64 ch
TARGET_EEG_SECONDS_PER_S = 3600.0          # BASELINE.json north star


def _enable_compile_cache():
    from ninwavelets_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()


def main_streaming():
    """BENCH_MODE=streaming: the long-recording workload (SURVEY §5 /
    BASELINE's 10-min 1 kHz case) through StreamingCWT, one device call
    per window batch.  Reports signal-seconds/s for a single channel; the
    reference's analog is one whole-signal host FFT per frequency
    (README.md:464-465: 50 s in 15.9 s numpy / 7.25 s cupy = 3.1 / 6.9
    signal-s/s)."""
    import jax
    _enable_compile_cache()
    import ninwavelets_tpu as nw
    from ninwavelets_tpu.parallel import StreamingCWT
    from ninwavelets_tpu.parallel.chunked import halo_samples

    sfreq = 1000.0
    n = int(os.environ.get("BENCH_N", 600_000))        # 10 min at 1 kHz
    n_freqs = int(os.environ.get("BENCH_FREQS", 100))
    # 2 Hz default: the 1 Hz Morse halo (~6.5k samples) would leave a
    # 16384-sample extended window almost no interior.
    min_freq = float(os.environ.get("BENCH_MIN_FREQ", 2.0))
    freqs = np.linspace(min_freq, 100.0, n_freqs).astype(np.float32)
    wdef = nw.Morse(sfreq)._wdef()
    # Geometry: pick the window so the extended window is exactly 16384 —
    # pow2_halo then keeps the derived halo.
    halo = halo_samples(wdef, min_freq, sfreq)
    window = 16384 - 2 * halo
    window -= window % 2
    s = StreamingCWT(wdef, freqs, sfreq, window=window, halo=halo,
                     interpolate=True,
                     batch=int(os.environ.get("BENCH_STREAM_BATCH", 8)))
    rng = np.random.default_rng(0)
    sig = rng.standard_normal(n).astype(np.float32)
    # Warm up at the FULL signal length: the device buffer shape (and so
    # the compiled program) depends on it.
    jax.block_until_ready(s.power_device(sig))
    # Best of BENCH_REPS repetitions: the fastest is the one least
    # disturbed by other work on the host.
    reps = int(os.environ.get("BENCH_REPS", 3))
    elapsed = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = s.power_device(sig)      # TFR stays on device, like main()
        jax.block_until_ready(out)
        elapsed = min(elapsed, time.perf_counter() - t0)
    value = (n / sfreq) / elapsed
    print(json.dumps({
        "metric": "streaming_signal_seconds_per_s_per_chip",
        "value": round(value, 2),
        "unit": "signal-s/s",
        "vs_baseline": round(value / 3.1446541, 1),   # README 50 s numpy
        "config": {"samples": n, "freqs": n_freqs, "min_freq": min_freq,
                   "window": s.window, "halo": s.halo,
                   "out_shape": list(out.shape),
                   "device": str(jax.devices()[0])},
    }))


def main_ssq():
    """BENCH_MODE=ssq: epoch-mean synchrosqueezed power (CWT + phase
    transform + reassignment), EEG-s/s like the main bench.  The
    reference has no synchrosqueezing; this tracks the reassignment
    engine (vectorized edge-count + row-wise accumulate in place of an
    XLA scatter and searchsorted)."""
    import jax
    _enable_compile_cache()
    import jax.numpy as jnp
    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops.bank import make_fft_bank
    from ninwavelets_tpu.ops.sst import ssq_mean_power

    sfreq = 1000.0
    n = int(os.environ.get("BENCH_N", 2048))
    channels = int(os.environ.get("BENCH_CHANNELS", 64))
    epochs = int(os.environ.get("BENCH_EPOCHS", 16))
    n_freqs = int(os.environ.get("BENCH_FREQS", 100))
    iters = int(os.environ.get("BENCH_ITERS", 5))

    morse = nw.Morse(sfreq)
    freqs = np.arange(1.0, n_freqs + 1.0, dtype=np.float32)
    bank = jnp.asarray(np.asarray(
        make_fft_bank(morse._wdef(), jnp.asarray(freqs), n, sfreq, True),
        dtype=np.float32))
    rng = np.random.default_rng(0)
    signals = jnp.asarray(
        rng.standard_normal((epochs, channels, n)).astype(np.float32))
    f_grid = jnp.asarray(freqs)

    step = lambda s: ssq_mean_power(s, bank, f_grid, sfreq,
                                    interpolate=True)
    jax.block_until_ready(step(signals))
    # Best of reps: the fastest repetition is the one least disturbed by
    # other work on the host.
    reps = int(os.environ.get("BENCH_REPS", 3))
    elapsed = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for k in range(iters):
            out = step(signals * (1.0 + 1e-7 * k))   # distinct inputs; one
        s = float(jnp.sum(out))                      # fetch ends the timing
        elapsed = min(elapsed, time.perf_counter() - t0)
    value = epochs * (n / sfreq) * iters / elapsed
    print(json.dumps({
        "metric": "ssq_eeg_seconds_per_s_per_chip",
        "value": round(value, 2),
        "unit": "EEG-s/s",
        "vs_baseline": round(value / REF_EEG_SECONDS_PER_S, 1),
        "config": {"channels": channels, "freqs": n_freqs, "segment_n": n,
                   "epochs_per_call": epochs, "iters": iters,
                   "device": str(jax.devices()[0])},
    }))


def main_cluster():
    """BENCH_MODE=cluster: cluster-permutation null throughput — sign-flip
    t-maps as (chunk, E) @ (E, F*N) matmuls + batched component
    labeling + mass scatter, reported as permutations/s.  The reference
    has no inferential statistics at all."""
    import jax
    _enable_compile_cache()
    import jax.numpy as jnp
    from ninwavelets_tpu.ops.cluster import _sign_flip_null

    epochs = int(os.environ.get("BENCH_EPOCHS", 40))
    n_freqs = int(os.environ.get("BENCH_FREQS", 100))
    n = int(os.environ.get("BENCH_N", 1024))
    n_perm = int(os.environ.get("BENCH_PERMS", 256))
    iters = int(os.environ.get("BENCH_ITERS", 3))

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(
        (epochs, n_freqs, n)).astype(np.float32))
    key = jax.random.PRNGKey(0)
    step = lambda d: _sign_flip_null(d, key, n_perm=n_perm, threshold=2.0)
    jax.block_until_ready(step(x))
    t0 = time.perf_counter()
    for k in range(iters):
        out = step(x * (1.0 + 1e-7 * k))         # distinct inputs; one
    s = float(jnp.sum(out))                      # fetch ends the timing
    elapsed = time.perf_counter() - t0
    value = n_perm * iters / elapsed
    print(json.dumps({
        "metric": "cluster_permutations_per_s",
        "value": round(value, 2),
        "unit": "perm/s",
        "vs_baseline": None,
        "config": {"epochs": epochs, "freqs": n_freqs, "segment_n": n,
                   "n_perm": n_perm, "iters": iters,
                   "device": str(jax.devices()[0])},
    }))


def main_multitaper():
    """BENCH_MODE=multitaper: epoch-mean multitaper Morse power (K
    orthogonal orders through one (K*F, N)-bank pass), EEG-s/s like
    the main bench (EEG seconds counted once, not per taper)."""
    import jax
    _enable_compile_cache()
    import jax.numpy as jnp
    from ninwavelets_tpu.ops.multitaper import (multitaper_banks,
                                                multitaper_mean_power)

    sfreq = 1000.0
    n = int(os.environ.get("BENCH_N", 2048))
    channels = int(os.environ.get("BENCH_CHANNELS", 64))
    epochs = int(os.environ.get("BENCH_EPOCHS", 16))
    n_freqs = int(os.environ.get("BENCH_FREQS", 100))
    n_tapers = int(os.environ.get("BENCH_TAPERS", 3))
    iters = int(os.environ.get("BENCH_ITERS", 5))

    freqs = np.arange(1.0, n_freqs + 1.0, dtype=np.float32)
    rng = np.random.default_rng(0)
    signals = jnp.asarray(
        rng.standard_normal((epochs, channels, n)).astype(np.float32))
    # build banks once (host-side cache) so the loop times the transform
    multitaper_banks(freqs, n, sfreq, n_tapers=n_tapers, interpolate=True)
    step = lambda s: multitaper_mean_power(s, freqs, sfreq,
                                           n_tapers=n_tapers,
                                           interpolate=True)
    jax.block_until_ready(step(signals))
    # Best of reps: the fastest repetition is the one least disturbed by
    # other work on the host.
    reps = int(os.environ.get("BENCH_REPS", 3))
    elapsed = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for k in range(iters):
            out = step(signals * (1.0 + 1e-7 * k))   # distinct inputs; one
        s = float(jnp.sum(out))                      # fetch ends the timing
        elapsed = min(elapsed, time.perf_counter() - t0)
    value = epochs * (n / sfreq) * iters / elapsed
    print(json.dumps({
        "metric": "multitaper_eeg_seconds_per_s_per_chip",
        "value": round(value, 2),
        "unit": "EEG-s/s",
        "vs_baseline": round(value / REF_EEG_SECONDS_PER_S, 1),
        "config": {"channels": channels, "freqs": n_freqs, "segment_n": n,
                   "epochs_per_call": epochs, "n_tapers": n_tapers,
                   "iters": iters, "device": str(jax.devices()[0])},
    }))


def main_granger():
    """BENCH_MODE=granger: time-resolved pairwise wavelet Granger
    causality (epoch-mean cross spectra + batched Wilson factorization),
    reported as factorized time-frequency GC cells per second."""
    import jax
    _enable_compile_cache()
    import jax.numpy as jnp
    from ninwavelets_tpu.ops.granger import wavelet_granger

    sfreq = 1000.0
    n = int(os.environ.get("BENCH_N", 2048))
    channels = int(os.environ.get("BENCH_CHANNELS", 4))
    epochs = int(os.environ.get("BENCH_EPOCHS", 16))
    n_bins = int(os.environ.get("BENCH_BINS", 65))
    time_decim = int(os.environ.get("BENCH_TDECIM", 32))
    iters = int(os.environ.get("BENCH_ITERS", 3))

    rng = np.random.default_rng(0)
    sigs = rng.standard_normal((epochs, channels, n)).astype(np.float32)
    step = lambda s: wavelet_granger(s, sfreq, n_bins=n_bins,
                                     time_decim=time_decim)
    jax.block_until_ready(step(sigs))
    t0 = time.perf_counter()
    for k in range(iters):
        out = step(sigs * (1.0 + 1e-7 * k))  # distinct inputs; one
    s = float(jnp.sum(out))                  # fetch ends the timing
    elapsed = time.perf_counter() - t0
    cells = out.shape[0] * n_bins * channels * (channels - 1)
    value = cells * iters / elapsed
    print(json.dumps({
        "metric": "granger_tf_cells_per_s",
        "value": round(value, 2),
        "unit": "GC cells/s",
        "vs_baseline": None,
        "config": {"channels": channels, "bins": n_bins, "segment_n": n,
                   "epochs": epochs, "time_decim": time_decim,
                   "iters": iters, "device": str(jax.devices()[0])},
    }))


def main_grad():
    """BENCH_MODE=grad: one training step on the epoch-mean power through
    ``ops.cwt.mean_power_adjoint_from_bank``: the forward is the Triton
    kernel on CUDA devices where it applies (the XLA scan otherwise), the
    backward the analytic adjoint.  Reported in the same EEG-s/s unit as
    the forward bench so the grad:forward cost ratio is directly readable.
    The reference has no gradients at all."""
    import jax
    _enable_compile_cache()
    import jax.numpy as jnp
    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops.bank import make_fft_bank
    from ninwavelets_tpu.ops.cwt import mean_power_adjoint_from_bank

    sfreq = 1000.0
    n = int(os.environ.get("BENCH_N", 2048))
    channels = int(os.environ.get("BENCH_CHANNELS", 64))
    epochs = int(os.environ.get("BENCH_EPOCHS", 64))
    n_freqs = int(os.environ.get("BENCH_FREQS", 100))
    iters = int(os.environ.get("BENCH_ITERS", 5))

    morse = nw.Morse(sfreq)
    bank = jnp.asarray(np.asarray(
        make_fft_bank(morse._wdef(), jnp.arange(1.0, n_freqs + 1.0), n,
                      sfreq, True), dtype=np.float32))
    rng = np.random.default_rng(0)
    signals = jnp.asarray(
        rng.standard_normal((epochs, channels, n)).astype(np.float32))

    # value_and_grad: a plain grad-of-sum would let XLA drop the forward
    # (the custom VJP's residuals are just the inputs), timing only the
    # backward; a training step wants the loss too.
    grad_step = jax.jit(jax.value_and_grad(lambda s, b: jnp.sum(
        mean_power_adjoint_from_bank(s, b, True)), argnums=(0, 1)))
    jax.block_until_ready(grad_step(signals, bank))
    jax.block_until_ready(grad_step(signals, bank))
    t0 = time.perf_counter()
    for _ in range(iters):
        g = grad_step(signals, bank)
    jax.block_until_ready(g)
    elapsed = time.perf_counter() - t0
    value = epochs * (n / sfreq) * iters / elapsed
    print(json.dumps({
        "metric": "grad_eeg_seconds_per_s_per_chip",
        "value": round(value, 2),
        "unit": "EEG-s/s",
        "vs_baseline": round(value / REF_EEG_SECONDS_PER_S, 1),
        "config": {"channels": channels, "freqs": n_freqs, "segment_n": n,
                   "epochs_per_call": epochs, "iters": iters,
                   "device": str(jax.devices()[0])},
    }))


def main():
    import jax
    _enable_compile_cache()
    import jax.numpy as jnp

    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops.bank import make_fft_bank
    from ninwavelets_tpu.ops.cwt import itc, mean_power, power_itc

    sfreq = 1000.0
    n = int(os.environ.get("BENCH_N", 2048))          # samples / segment
    channels = int(os.environ.get("BENCH_CHANNELS", 64))
    epochs = int(os.environ.get("BENCH_EPOCHS", 200))  # segments / call
    # (200 = the BASELINE config-5 epochs count)
    n_freqs = int(os.environ.get("BENCH_FREQS", 100))
    iters = int(os.environ.get("BENCH_ITERS", 10))

    morse = nw.Morse(sfreq)
    bank = jnp.asarray(np.asarray(
        make_fft_bank(morse._wdef(), jnp.arange(1.0, n_freqs + 1.0), n,
                      sfreq, True), dtype=np.float32))
    rng = np.random.default_rng(0)
    signals = jnp.asarray(
        rng.standard_normal((epochs, channels, n)).astype(np.float32))

    step = lambda s, b: mean_power(s, b, interpolate=True)
    itc_step = lambda s, b: itc(s, b, interpolate=True)
    # Warmup / compile.
    jax.block_until_ready(step(signals, bank))
    jax.block_until_ready(step(signals, bank))

    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(signals, bank)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0

    eeg_seconds = epochs * (n / sfreq) * iters
    value = eeg_seconds / elapsed
    record = {
        "metric": "eeg_seconds_per_s_per_chip",
        "value": round(value, 2),
        "unit": "EEG-s/s",
        "vs_baseline": round(value / REF_EEG_SECONDS_PER_S, 1),
        "vs_readme_baseline": round(value / REF_README_EEG_SECONDS_PER_S, 1),
        "vs_target": round(value / TARGET_EEG_SECONDS_PER_S, 3),
        "config": {"channels": channels, "freqs": n_freqs, "segment_n": n,
                   "epochs_per_call": epochs, "iters": iters,
                   "device": str(jax.devices()[0])},
    }

    # Inter-trial coherence on the same workload (mneutils.py:57-71 path),
    # and both reductions in one pass over the epochs (what run_pipeline
    # dispatches).
    itc_iters = max(iters // 2, 1)
    for key, fn in (("itc_eeg_seconds_per_s", itc_step),
                    ("power_itc_eeg_seconds_per_s",
                     lambda s, b: power_itc(s, b, interpolate=True))):
        jax.block_until_ready(fn(signals, bank))
        t0 = time.perf_counter()
        for _ in range(itc_iters):
            out = fn(signals, bank)
        jax.block_until_ready(out)
        record[key] = round(
            epochs * (n / sfreq) * itc_iters / (time.perf_counter() - t0), 2)
    print(json.dumps(record))


if __name__ == "__main__":
    mode = os.environ.get("BENCH_MODE", "").lower()
    if mode == "streaming":
        main_streaming()
    elif mode == "grad":
        main_grad()
    elif mode == "ssq":
        main_ssq()
    elif mode == "cluster":
        main_cluster()
    elif mode == "multitaper":
        main_multitaper()
    elif mode == "granger":
        main_granger()
    else:
        main()
