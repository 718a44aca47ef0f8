"""``chip_smoke.py`` on the CPU: it refuses to report without a GPU, and its
phases and comparison helpers work at tiny sizes on the virtual mesh."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script_dir, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=script_dir,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_refuses_cpu_backend():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "GPU" in r.stderr


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_snr_and_gate():
    a = np.linspace(1.0, 2.0, 64)
    assert chip_smoke.snr_db(a, a) == float("inf")
    assert abs(chip_smoke.snr_db(a, a * (1 + 1e-3)) - 60.0) < 1e-6
    assert chip_smoke.check("x", 95.0, 90.0) == {"snr_db": 95.0,
                                                 "gate_db": 90.0}
    with pytest.raises(AssertionError, match="x: 80.0 dB < gate"):
        chip_smoke.check("x", 80.0, 90.0)
    with pytest.raises(AssertionError):
        chip_smoke.check("nan", float("nan"), 90.0)
    b = a.copy()
    b[3] = np.nan
    assert chip_smoke.snr_db(b, b) == float("inf")       # NaN in both
    assert chip_smoke.snr_db(b, a) == float("-inf")      # NaN in one


def test_surface_phase():
    rec = chip_smoke.phase_surface()
    assert rec["morse_peak_hz"] == 60 and rec["cwt_dtype"] == "complex64"


def test_headline_phase_tiny():
    rec = chip_smoke.phase_headline(0, channels=2, epochs=5, n=512,
                                    n_freqs=8, oracle_epochs=3)
    assert rec["power_vs_oracle"]["snr_db"] >= chip_smoke.POWER_GATE_DB
    assert rec["itc_vs_oracle"]["snr_db"] >= chip_smoke.ITC_GATE_DB
    assert set(rec["warm_s"]) == {"mean_power", "mean_power_xla", "itc",
                                  "power_all", "channel_power"}
    assert rec["kernel_in_program"] is False        # CPU: the XLA branch


def test_lengths_phase_tiny():
    rec = chip_smoke.phase_lengths(0, channels=2, n_freqs=4,
                                   eeg_samples=3 * 1024, lengths=(512, 1024))
    for n, epochs in (("512", 6), ("1024", 3)):
        assert rec[n]["epochs"] == epochs
        assert rec[n]["kernel_vs_xla"]["snr_db"] >= chip_smoke.POWER_GATE_DB
        assert rec[n]["kernel_in_program"] is False   # CPU: the XLA branch


def test_stream_phase_tiny():
    rec = chip_smoke.phase_stream(0, n=30_000, n_freqs=4)
    assert rec["window"] + 2 * rec["halo"] == 16384
    assert rec["interior_vs_whole"]["snr_db"] >= chip_smoke.STREAM_GATE_DB


def test_grad_phase_tiny():
    rec = chip_smoke.phase_grad(0, channels=2, epochs=3, n=256, n_freqs=8)
    assert rec["dsignals_vs_autodiff"]["snr_db"] >= chip_smoke.GRAD_GATE_DB
    assert rec["dbank_vs_autodiff"]["snr_db"] >= chip_smoke.GRAD_GATE_DB


def test_cards_phase_on_virtual_mesh():
    rec = chip_smoke.phase_cards(0, 4, channels=2, epochs=8, n=256,
                                 n_freqs=8)
    for mesh in ("data", "data_freq"):
        assert rec[mesh]["power_devices"] == 4
    assert rec["data"]["mesh"]["data"] == 4
    assert rec["data_freq"]["mesh"] == {"data": 2, "freq": 2, "time": 1}
    assert rec["time"]["devices"] == 4
    assert rec["data"]["kernel_in_program"] is False
