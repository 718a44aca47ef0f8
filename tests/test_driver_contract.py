"""Driver-contract guards: bench.py's single-JSON-line output and the
__graft_entry__ hooks must keep working — the round driver consumes both.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")


def _bench(tmp_path, **kw):
    """Run bench.py on the CPU with a tiny workload; its one JSON line.
    The compile cache goes to a temporary directory."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path), **kw)
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    d = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in d, key
    assert d["value"] > 0
    return d


def test_bench_emits_one_json_line(tmp_path):
    """Tiny CPU workload: stdout is exactly one JSON object with the
    required keys and no accelerator utilization figure."""
    d = _bench(tmp_path, BENCH_N="1024", BENCH_CHANNELS="2",
               BENCH_EPOCHS="2", BENCH_FREQS="8", BENCH_ITERS="1")
    assert d["metric"] == "eeg_seconds_per_s_per_chip"
    assert not any("utilization" in key for key in d)
    assert d["power_itc_eeg_seconds_per_s"] > 0


def test_bench_grad_mode_emits_one_json_line(tmp_path):
    d = _bench(tmp_path, BENCH_MODE="grad", BENCH_N="512",
               BENCH_CHANNELS="2", BENCH_EPOCHS="3", BENCH_FREQS="8",
               BENCH_ITERS="1")
    assert d["metric"] == "grad_eeg_seconds_per_s_per_chip"


def test_bench_streaming_mode_emits_one_json_line(tmp_path):
    d = _bench(tmp_path, BENCH_MODE="streaming", BENCH_N="20000",
               BENCH_FREQS="4", BENCH_REPS="1", BENCH_STREAM_BATCH="2")
    assert d["metric"] == "streaming_signal_seconds_per_s_per_chip"
    assert d["config"]["window"] + 2 * d["config"]["halo"] == 16384


def test_graft_entry_compiles():
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out = jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out)).all()


def test_graft_dryrun_multichip():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)   # asserts internally


def test_two_device_weak_efficiency_sane():
    """The 2-device weak-scaling point is the plumbing proof (2 <= the
    physical core count here, so the virtual-mesh ceiling does not
    apply): with median-of-N per-call-synchronized timing it must land
    in [0.90, 1.02] — below means sharding overhead, above means the
    measurement is noise (superlinear weak scaling is physically
    impossible on shared cores)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    if (os.cpu_count() or 1) < 2:
        pytest.skip("needs >= 2 physical cores for an honest 2-dev point")
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    eff = ge.efficiency_table(2, reps=5)
    e2 = eff["weak_table"][1]["efficiency"]
    if not 0.90 <= e2 <= 1.02:          # one retry: ambient load spikes
        eff = ge.efficiency_table(2, reps=7)
        e2 = eff["weak_table"][1]["efficiency"]
    if not 0.90 <= e2 <= 1.02 and \
            os.getloadavg()[0] > 1.5 * (os.cpu_count() or 1):
        pytest.skip("host under heavy external load (loadavg %.1f on "
                    "%d cores) — a wall-clock gate cannot measure "
                    "sharding overhead here; scaling on real devices is "
                    "measured with benchmarks/scaling.py"
                    % (os.getloadavg()[0], os.cpu_count() or 1))
    assert 0.90 <= e2 <= 1.02, eff
