"""Bench-coverage gate: every ops family must have at least one row in
the family table of ``benchmarks/extensions_bench.py`` (its
``record(op=...)`` calls) — a new family merged without a bench row fails
here, so coverage cannot drift.

The mapping below IS the ledger: module -> row-name substrings (any
match counts).  Core-engine modules measured by the MAIN bench
(``bench.py``: cwt/power_kernel/bank/baseline/grids/spectra/
signal_utils) and pure-infra modules are exempt and listed explicitly so a reviewer can
audit the exemptions rather than guess them.
"""
import os
import re

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                     "extensions_bench.py")

# ops module -> substrings of row "op" names that cover it
FAMILY_ROWS = {
    "asr": ["asr"],
    "beamformer": ["lcmv"],
    "bootstrap": ["bootstrap"],
    "bursts": ["burst"],
    "cluster": ["cluster_null", "cluster_f_null"],
    "complexity": ["sampen", "perm_entropy", "dfa"],
    "connectivity": ["wpli", "plv", "erpac", "psi_matrix",
                     "partial_coherence"],
    "cpd": ["cp_rank"],
    "csd": ["csd_spline"],
    "cwt2d": ["cwt2d"],
    "cycles": ["cycles"],
    "decoding": ["ssvep", "tf_decode", "csp_decode"],
    "denoise": ["denoise_64sig"],
    "dwt": ["modwt", "wavedec"],
    "dwt2d": ["dwt2d"],
    "emd": ["emd"],
    "envelope": ["env_corr"],
    "erp": ["erp_jackknife"],
    "ewt": ["ewt_"],
    "extensions": ["epoch_coherence", "psi_pairwise",
                   "wavelet_coherence", "lagged_coherence"],
    "filtering": ["bandpass", "resample"],
    "fit": ["learn_bank"],
    "granger": ["granger"],
    "graph": ["graph_small_world"],
    "hmm": ["hmm"],
    "ica": ["fastica"],
    "icwt": ["icwt"],
    "irasa": ["irasa"],
    "leadfield": ["sphere_leadfield", "fit_dipole_eeg",
                  "fit_dipole_meg"],
    "microstates": ["microstates", "microstate_syntax"],
    "mp": ["matching_pursuit"],
    "multitaper": ["multitaper"],
    "reassign": ["reassigned"],
    "reject": ["autoreject", "channel_qc"],
    "ridge": ["extract_modes"],
    "riemann": ["riemann"],
    "scattering": ["scattering"],
    "sim": ["iaaft"],
    "sleep": ["spindles", "slow_osc"],
    "spatial": ["csp_decode", "ssd_fit", "xdawn"],
    "specparam": ["specparam"],
    "sst": ["ssq"],
    "stockwell": ["stockwell"],
    "superlets": ["superlet"],
    "tc_stats": ["tc_significance"],
    "trf": ["trf"],
    "vmd": ["vmd"],
    "wpt": ["modwpt"],
}

# measured by the MAIN bench.py (the driver's BENCH_r*.json) or infra
EXEMPT = {
    "bank", "baseline", "cwt", "grids", "power_kernel", "signal_utils",
    "spectra",
}


def _ops_modules():
    root = os.path.join(os.path.dirname(__file__), "..",
                        "ninwavelets_tpu", "ops")
    return sorted(f[:-3] for f in os.listdir(root)
                  if f.endswith(".py") and f != "__init__.py")


def test_ledger_covers_every_ops_module():
    mods = set(_ops_modules())
    mapped = set(FAMILY_ROWS) | EXEMPT
    missing = mods - mapped
    assert not missing, (
        "new ops module(s) with no bench-ledger entry: %s — add a row "
        "to benchmarks/extensions_bench.py and map it here" % sorted(
            missing))
    stale = set(FAMILY_ROWS) - mods
    assert not stale, f"ledger maps deleted modules: {sorted(stale)}"


def test_artifact_has_a_row_for_every_family():
    with open(BENCH) as fh:
        ops = re.findall(r'record\(op="([^"]+)"', fh.read())
    assert ops, "no record(op=...) rows found in extensions_bench.py"
    missing = {fam: pats for fam, pats in FAMILY_ROWS.items()
               if not any(p in op for p in pats for op in ops)}
    assert not missing, (
        "ops families with no row in extensions_bench.py: %s"
        % sorted(missing))
