"""Device smoke test: the wavelet engine's main path on one GPU.

    python chip_smoke.py [--seed N]        # one card: phases 0-5
    python chip_smoke.py --cards 4         # four cards: the sharded phase only

Phases (each prints one JSON line; any failure exits non-zero):

0. device — refuses to run unless JAX's backend is "gpu"; prints the
   card's ``nvidia-smi`` name and power limit, the JAX version and
   ``XLA_FLAGS``.
1. public surface — ``Morse.power`` of a 60 Hz sine peaks at row 60,
   ``cwt`` returns host complex64, a complex-bank family, the
   ``EpochsWavelet`` adapter, and the error paths.
2. headline deployment — 64 channels x 200 epochs x 2048 samples at 1 kHz,
   100 Morse frequencies (1..100 Hz), analytic: ``ops.cwt.mean_power`` /
   ``ops.cwt.itc`` (what ``bench.py`` times), ``EpochsWavelet.power_all``
   and the per-channel ``power`` / ``itc``.  8 epochs x all 64 channels are
   compared with the float64 oracle (``tests/reference_oracle.py``), and
   the Triton power kernel that ``mean_power`` runs on the card
   (``ops.power_kernel``) with the plain XLA path at the full shape.
3. epoch lengths — the power kernel at every epoch length it serves
   (``ops.power_kernel.MIN_N``..``MAX_N``) through ``ops.cwt.mean_power``,
   at the headline's 64 channels x 100 frequencies and 409.6 EEG-s per
   call, against the plain XLA path.
4. long recording — ``parallel.StreamingCWT`` over 10 min at 1 kHz,
   interior compared with one whole-signal ``ops.cwt.power``.
5. gradient — ``jax.value_and_grad`` of the epoch-mean power at the
   ``BENCH_MODE=grad`` shape (64 x 64 x 2048 x 100) through the analytic
   adjoint, compared with autodiff of the plain forward.

With ``--cards 4`` only the sharded phase runs: ``distributed_mean_power`` /
``distributed_itc`` at the headline shape on (data=4) and (data=2, freq=2)
meshes (the per-shard power must compile the Triton kernel) and
``chunked_power`` on a (time=4) mesh, each compared with the single-card
result.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Times are wall-clock of one warm call ending in ``block_until_ready``:
facts for ``PERF.md``, not a benchmark.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SFREQ = 1000.0
#: Gates, as SNR in dB against the reference computation.
POWER_GATE_DB = 90.0        # the repo's parity gate (tests/test_parity.py)
#: ITC divides every coefficient by its magnitude, which amplifies float32
#: round-off in cells where |cwt| is near zero; those cells carry no phase
#: information, and the statistic's own sampling error at 8 epochs is about
#: 1/sqrt(8), i.e. -9 dB.  80 dB keeps the check far below anything a user
#: can see while leaving room for that amplification.
ITC_GATE_DB = 80.0
STREAM_GATE_DB = 60.0       # interior vs whole signal: halo truncation at
#                             the envelope tolerance 1e-4 (power 1e-8)
GRAD_GATE_DB = 80.0         # two float32 gradients that sum F*N products
#                             in different orders


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def snr_db(want, got) -> float:
    """Signal-to-error ratio of ``got`` against ``want`` (float64) over the
    finite cells; -inf unless both have NaN in the same cells (ITC's 0/0
    convention for zero-magnitude coefficients)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    finite = np.isfinite(want)
    if want.shape != got.shape or not np.array_equal(finite,
                                                     np.isfinite(got)):
        return float("-inf")
    want, got = want[finite], got[finite]
    err = got - want
    p_err = float(np.mean(err * err))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * np.log10(float(np.mean(want * want)) / p_err)


def check(name: str, value: float, gate: float) -> dict:
    """One gated comparison; raises if ``value`` is below ``gate``."""
    if not value >= gate:
        raise AssertionError(f"{name}: {value:.1f} dB < gate {gate} dB")
    return {"snr_db": round(value, 2), "gate_db": gate}


def warm_time(fn, *args):
    """(result, seconds) of one call after a warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def morse_bank(freqs, n: int):
    """Engine bank (float32, analytic) for the Morse default."""
    import jax.numpy as jnp
    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops.bank import make_fft_bank
    return jnp.asarray(np.asarray(make_fft_bank(
        nw.Morse(SFREQ)._wdef(), jnp.asarray(freqs, jnp.float32), n, SFREQ,
        True), np.float32))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax
    smi = nvidia_smi()
    print(smi, flush=True)
    return {"phase": "device", "nvidia_smi": smi,
            "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "devices": [str(d) for d in jax.devices()]}


def phase_surface() -> dict:
    import ninwavelets_tpu as nw
    sin = np.sin(np.arange(0, 3, 0.001) * 60 * 2 * np.pi)
    morse = nw.Morse(1000, 17.5, 3)
    p = np.asarray(morse.power(sin, range(1, 100)))
    peak = int(np.argmax(p.mean(-1))) + 1
    if p.shape != (99, 3000) or peak != 60:
        raise AssertionError(f"Morse power shape {p.shape}, peak {peak} Hz")
    c = morse.cwt(sin, range(1, 100))
    if not (isinstance(c, np.ndarray) and c.dtype == np.complex64):
        raise AssertionError(f"cwt returned {type(c)} {c.dtype}")
    mh = np.asarray(nw.MexicanHat(1000).power(sin, range(40, 80)))
    if mh.shape != (40, 3000) or not np.isfinite(mh).all():
        raise AssertionError("MexicanHat power not finite")

    rng = np.random.default_rng(0)
    t = np.arange(600) / SFREQ
    data = (np.sin(2 * np.pi * 30 * t)[None, None, :]
            + 0.2 * rng.standard_normal((6, 3, 600))).astype(np.float32)
    ew = nw.EpochsWavelet(nw.ArrayEpochs(data, SFREQ),
                          nw.Morse(interpolate=True))
    freqs = np.arange(5.0, 65.0)
    pw = np.asarray(ew.power("ch1", freqs))
    itc = np.asarray(ew.itc("ch1", freqs))
    pall = np.asarray(ew.power_all(freqs))
    if (pw.shape != (60, 600) or itc.shape != (60, 600)
            or pall.shape != (3, 60, 600)):
        raise AssertionError("EpochsWavelet shapes")
    if not (np.isfinite(pall).all() and np.nanmax(itc) <= 1.0 + 1e-5):
        raise AssertionError("EpochsWavelet values")
    if snr_db(pall[1], pw) < POWER_GATE_DB:
        raise AssertionError("power_all row != per-channel power")

    for bad, exc in (([0.0, 10.0], ZeroDivisionError), ([], ValueError)):
        try:
            nw.Morse(1000).power(sin, bad)     # fresh: no cached bank
        except exc:
            continue
        raise AssertionError(f"freqs {bad} did not raise {exc.__name__}")
    return {"phase": "surface", "morse_peak_hz": peak,
            "cwt_dtype": str(c.dtype)}


def phase_headline(seed: int, channels: int = 64, epochs: int = 200,
                   n: int = 2048, n_freqs: int = 100,
                   oracle_epochs: int = 8) -> dict:
    import jax
    import ninwavelets_tpu as nw
    import reference_oracle as ro
    from ninwavelets_tpu.ops import cwt

    freqs = np.arange(1.0, n_freqs + 1.0)
    bank = morse_bank(freqs, n)
    signals = np.random.default_rng(seed).standard_normal(
        (epochs, channels, n)).astype(np.float32)
    sig_dev = jax.device_put(signals)

    kernel_power = jax.jit(lambda s, b: cwt.mean_power(s, b,
                                                       interpolate=True))
    xla_power = jax.jit(lambda s, b: cwt.mean_power_from_bank(s, b, True))
    hlo = kernel_power.lower(sig_dev, bank).compile().as_text()
    if jax.default_backend() == "gpu" and "epoch_mean_power" not in hlo:
        raise AssertionError("mean_power did not compile the power kernel")
    power, t_power = warm_time(kernel_power, sig_dev, bank)
    p_xla, t_xla = warm_time(xla_power, sig_dev, bank)
    itc, t_itc = warm_time(
        lambda s, b: cwt.itc(s, b, interpolate=True), sig_dev, bank)
    power, itc = np.asarray(power), np.asarray(itc)
    if power.shape != (channels, n_freqs, n) or not np.isfinite(power).all():
        raise AssertionError(f"mean_power {power.shape} or not finite")
    if itc.shape != power.shape or not np.isfinite(itc).all():
        raise AssertionError("itc shape or not finite")

    ew = nw.EpochsWavelet(nw.ArrayEpochs(signals, SFREQ),
                          nw.Morse(interpolate=True))
    pall, t_all = warm_time(ew.power_all, freqs)
    pall = np.asarray(pall)
    ch = ew.epochs.ch_names[channels // 2]
    p_ch, t_ch = warm_time(ew.power, ch, freqs)
    p_ch = np.asarray(p_ch)
    i_ch = np.asarray(ew.itc(ch, freqs))

    sub = signals[:oracle_epochs]
    obank = ro.make_bank("morse", freqs, n, SFREQ, True)
    p_sub = np.asarray(cwt.mean_power(sub, bank, interpolate=True))
    i_sub = np.asarray(cwt.itc(sub, bank, interpolate=True))
    return {
        "phase": "headline",
        "shape": {"channels": channels, "epochs": epochs, "n": n,
                  "freqs": n_freqs, "oracle_epochs": oracle_epochs},
        "power_vs_oracle": check("power", snr_db(
            ro.mean_power(sub, obank, True), p_sub), POWER_GATE_DB),
        "kernel_vs_xla": check("kernel", snr_db(np.asarray(p_xla), power),
                               POWER_GATE_DB),
        "kernel_in_program": "epoch_mean_power" in hlo,
        "itc_vs_oracle": check("itc", snr_db(
            ro.itc(sub, obank, True), i_sub), ITC_GATE_DB),
        "power_all_vs_mean_power": check(
            "power_all", snr_db(power, pall), POWER_GATE_DB),
        "channel_power_vs_mean_power": check(
            "channel power", snr_db(power[channels // 2], p_ch),
            POWER_GATE_DB),
        "channel_itc_vs_itc": check(
            "channel itc", snr_db(itc[channels // 2], i_ch), ITC_GATE_DB),
        "warm_s": {"mean_power": t_power, "mean_power_xla": t_xla,
                   "itc": t_itc, "power_all": t_all,
                   "channel_power": t_ch},
        "eeg_seconds_per_call": epochs * n / SFREQ,
        "peak_bytes_in_use": peak_bytes(),
    }


def phase_lengths(seed: int, channels: int = 64, n_freqs: int = 100,
                  eeg_samples: int = 200 * 2048, lengths=None) -> dict:
    import jax
    from ninwavelets_tpu.ops import cwt, power_kernel

    if lengths is None:
        lengths = [n for n in (2 ** k for k in range(20))
                   if power_kernel.MIN_N <= n <= power_kernel.MAX_N]
    out = {"phase": "lengths"}
    for n in lengths:
        epochs = eeg_samples // n
        bank = morse_bank(np.arange(1.0, n_freqs + 1.0), n)
        sig = jax.device_put(np.random.default_rng(seed + n).standard_normal(
            (epochs, channels, n)).astype(np.float32))
        kernel_power = jax.jit(
            lambda s, b: cwt.mean_power(s, b, interpolate=True))
        in_program = ("epoch_mean_power"
                      in kernel_power.lower(sig, bank).compile().as_text())
        if jax.default_backend() == "gpu" and not in_program:
            raise AssertionError(f"N={n}: mean_power did not compile the "
                                 "power kernel")
        got, t_kernel = warm_time(kernel_power, sig, bank)
        want, t_xla = warm_time(
            jax.jit(lambda s, b: cwt.mean_power_from_bank(s, b, True)),
            sig, bank)
        out[str(n)] = {"epochs": epochs, "kernel_in_program": in_program,
                       "kernel_vs_xla": check(f"N={n}", snr_db(
                           np.asarray(want), np.asarray(got)),
                           POWER_GATE_DB),
                       "warm_s": {"kernel": t_kernel, "xla": t_xla}}
    return out


def phase_stream(seed: int, n: int = 600_000, n_freqs: int = 100) -> dict:
    import jax
    import ninwavelets_tpu as nw
    from ninwavelets_tpu.ops import cwt
    from ninwavelets_tpu.parallel import StreamingCWT
    from ninwavelets_tpu.parallel.chunked import halo_samples

    min_freq = 2.0
    freqs = np.linspace(min_freq, 100.0, n_freqs).astype(np.float32)
    wdef = nw.Morse(SFREQ)._wdef()
    halo = halo_samples(wdef, min_freq, SFREQ)
    window = 16384 - 2 * halo          # extended window 16384 (bench.py)
    window -= window % 2
    s = StreamingCWT(wdef, freqs, SFREQ, window=window, halo=halo,
                     interpolate=True)
    sig = np.random.default_rng(seed + 1).standard_normal(n).astype(
        np.float32)
    got, t_stream = warm_time(s.power_device, sig)
    whole = cwt.power(jax.device_put(sig), morse_bank(freqs, n),
                      interpolate=True)
    m = s.halo
    got = np.asarray(got)[:, m:n - m]
    want = np.asarray(whole)[:, m:n - m]
    return {"phase": "stream", "samples": n, "freqs": n_freqs,
            "window": s.window, "halo": s.halo,
            "interior_vs_whole": check("stream", snr_db(want, got),
                                       STREAM_GATE_DB),
            "warm_s": t_stream, "signal_seconds": n / SFREQ,
            "peak_bytes_in_use": peak_bytes()}


def phase_grad(seed: int, channels: int = 64, epochs: int = 64,
               n: int = 2048, n_freqs: int = 100) -> dict:
    import jax
    import jax.numpy as jnp
    from ninwavelets_tpu.ops.cwt import (mean_power_adjoint_from_bank,
                                         mean_power_from_bank)

    bank = morse_bank(np.arange(1.0, n_freqs + 1.0), n)
    signals = jax.device_put(np.random.default_rng(seed + 2).standard_normal(
        (epochs, channels, n)).astype(np.float32))

    def step(fn):
        return jax.jit(jax.value_and_grad(
            lambda s, b: jnp.sum(fn(s, b, True)), argnums=(0, 1)))

    (val, (gs, gb)), t_grad = warm_time(
        step(mean_power_adjoint_from_bank), signals, bank)
    with jax.default_matmul_precision("highest"):
        val_x, (gs_x, gb_x) = step(mean_power_from_bank)(signals, bank)
    gs, gb, gs_x, gb_x = (np.asarray(x) for x in (gs, gb, gs_x, gb_x))
    if not (np.isfinite(gs).all() and np.isfinite(gb).all()):
        raise AssertionError("gradient not finite")
    rel_val = abs(float(val) - float(val_x)) / abs(float(val_x))
    if rel_val > 1e-5:
        raise AssertionError(f"loss differs by {rel_val:.2e}")
    return {"phase": "grad",
            "shape": {"channels": channels, "epochs": epochs, "n": n,
                      "freqs": n_freqs},
            "dsignals_vs_autodiff": check("dsignals", snr_db(gs_x, gs),
                                          GRAD_GATE_DB),
            "dbank_vs_autodiff": check("dbank", snr_db(gb_x, gb),
                                       GRAD_GATE_DB),
            "loss_rel_diff": rel_val,
            "warm_s": t_grad, "peak_bytes_in_use": peak_bytes()}


def phase_cards(seed: int, cards: int, channels: int = 64,
                epochs: int = 200, n: int = 2048,
                n_freqs: int = 100, stream_n: int = 65536) -> dict:
    """The sharded engine across ``cards`` devices against one device."""
    import jax
    from jax.sharding import PartitionSpec as P
    import ninwavelets_tpu as nw
    from ninwavelets_tpu import parallel as par
    from ninwavelets_tpu.ops import cwt

    devices = jax.devices()
    if len(devices) < cards:
        raise AssertionError(f"need {cards} devices, have {len(devices)}")
    devices = devices[:cards]
    freqs = np.arange(1.0, n_freqs + 1.0)
    morse = nw.Morse(SFREQ, interpolate=True)
    signals = np.random.default_rng(seed).standard_normal(
        (epochs, channels, n)).astype(np.float32)
    one = jax.device_put(signals, devices[0])
    bank = jax.device_put(morse_bank(freqs, n), devices[0])
    p_one = np.asarray(cwt.mean_power(one, bank, interpolate=True))
    i_one = np.asarray(cwt.itc(one, bank, interpolate=True))

    out = {"phase": "cards", "cards": cards}
    meshes = {"data": par.make_mesh(data=cards, freq=1, devices=devices),
              "data_freq": par.make_mesh(data=cards // 2, freq=2,
                                         devices=devices)}
    for name, mesh in meshes.items():
        in_program = "epoch_mean_power" in par.sharded_mean_power.lower(
            par.shard_batch(signals, mesh, P(par.DATA_AXIS)),
            morse_bank(freqs, n), mesh=mesh,
            interpolate=True).compile().as_text()
        if jax.default_backend() == "gpu" and not in_program:
            raise AssertionError(f"{name}: sharded_mean_power did not "
                                 "compile the power kernel")
        (p, i), t_both = warm_time(
            lambda s: (par.distributed_mean_power(s, morse, freqs, SFREQ,
                                                  mesh=mesh),
                       par.distributed_itc(s, morse, freqs, SFREQ,
                                           mesh=mesh)), signals)
        out[name] = {
            "mesh": dict(mesh.shape),
            "kernel_in_program": in_program,
            "power_devices": len(p.sharding.device_set),
            "itc_devices": len(i.sharding.device_set),
            "power_vs_one_card": check(f"{name} power",
                                       snr_db(p_one, np.asarray(p)),
                                       POWER_GATE_DB),
            "itc_vs_one_card": check(f"{name} itc",
                                     snr_db(i_one, np.asarray(i)),
                                     ITC_GATE_DB),
            "warm_s_power_and_itc": t_both}
        if out[name]["power_devices"] != cards:
            raise AssertionError(f"{name}: power on "
                                 f"{out[name]['power_devices']} devices")

    mesh = par.make_mesh(data=1, freq=1, time=cards, devices=devices)
    chunk = stream_n // cards
    halo = par.pow2_halo(chunk, par.halo_samples(morse._wdef(), 2.0, SFREQ))
    sfreqs = np.linspace(2.0, 100.0, n_freqs).astype(np.float32)
    br, bi = par.chunk_bank(morse._wdef(), sfreqs, chunk, halo, SFREQ, True)
    sig = np.random.default_rng(seed + 3).standard_normal(
        stream_n).astype(np.float32)
    sig_sharded = par.shard_batch(sig, mesh, P(par.TIME_AXIS))
    got, t_chunk = warm_time(
        lambda s: par.chunked_power(s, br, bi, mesh=mesh, halo=halo,
                                    interpolate=True), sig_sharded)
    whole = np.asarray(cwt.power(jax.device_put(sig, devices[0]),
                                 morse_bank(sfreqs, stream_n),
                                 interpolate=True))
    out["time"] = {
        "mesh": dict(mesh.shape), "samples": stream_n, "halo": halo,
        "devices": len(got.sharding.device_set),
        "interior_vs_one_card": check(
            "chunked", snr_db(whole[:, halo:-halo],
                              np.asarray(got)[:, halo:-halo]),
            STREAM_GATE_DB),
        "warm_s": t_chunk}
    if out["time"]["devices"] != cards:
        raise AssertionError("chunked power not on every device")
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1,
                    help="4 runs only the sharded phase on four cards")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU backend, JAX has "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    from ninwavelets_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    emit(phase_device())
    if args.cards > 1:
        emit(phase_cards(args.seed, args.cards))
    else:
        emit(phase_surface())
        emit(phase_headline(args.seed))
        emit(phase_lengths(args.seed))
        emit(phase_stream(args.seed))
        emit(phase_grad(args.seed))
    d = jax.devices()
    emit({"ok": True, "device": {"platform": d[0].platform,
                                 "kind": d[0].device_kind,
                                 "count": len(d)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
