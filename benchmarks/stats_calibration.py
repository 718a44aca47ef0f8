"""False-positive-rate calibration of the inferential statistics on
null data: a permutation test is only worth shipping if its corrected
p-values are honest, so this script MEASURES the family-wise error of
the cluster / TFCE / max-stat tests and the pointwise rate of the
surrogate nulls over many independent null simulations, and commits the
result (tests/artifacts/stats_calibration.json) where the suite gates
it with binomial bounds.

Run anywhere (CPU mesh is fine — the statistics are backend-agnostic):

    python benchmarks/stats_calibration.py
"""
import json
import os
import time

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "artifacts",
                   "stats_calibration.json")

N_SIMS = 500
ALPHA = 0.05


def main():
    import jax
    import jax.numpy as jnp

    from ninwavelets_tpu.ops import cluster as cl
    from ninwavelets_tpu.ops.bank import make_fft_bank
    from ninwavelets_tpu.ops.connectivity import plv_significance
    from ninwavelets_tpu.models import Morse

    rng = np.random.default_rng(0)
    t0 = time.time()
    rows = {}

    def maybe_clear(i):
        # 500 sims x several compiled programs each crosses the kernel's
        # 65530 memory-mapping ceiling on the CPU backend -- LLVM then
        # dies with "Cannot
        # allocate memory"; periodically dropping executable caches
        # keeps the map count bounded.
        if i % 50 == 49:
            jax.clear_caches()

    # --- cluster / TFCE / max-stat FWER on (E, F, N) null planes ----------
    e, f, n = 20, 8, 32
    hits_cluster = hits_tfce = hits_maxstat = 0
    for s in range(N_SIMS):
        maybe_clear(s)
        x = rng.standard_normal((e, f, n)).astype(np.float32)
        res = cl.cluster_test_one_sample(x, n_perm=99, seed=s)
        if any(c["p"] <= ALPHA for c in res.clusters):
            hits_cluster += 1
        tf = cl.tfce_test_one_sample(x, n_perm=99, seed=s, stop=15.0)
        if tf.p_map.min() <= ALPHA:
            hits_tfce += 1
        _, p = cl.max_stat_test_one_sample(x, n_perm=99, seed=s)
        if p.min() <= ALPHA:
            hits_maxstat += 1
    rows["cluster_fwer"] = hits_cluster / N_SIMS
    rows["tfce_fwer"] = hits_tfce / N_SIMS
    rows["maxstat_fwer"] = hits_maxstat / N_SIMS

    # --- independent-groups cluster FWER -----------------------------------
    hits = 0
    for s in range(N_SIMS):
        maybe_clear(s)
        xa = rng.standard_normal((10, f, n)).astype(np.float32)
        xb = rng.standard_normal((12, f, n)).astype(np.float32)
        res = cl.cluster_test_independent(xa, xb, n_perm=99, seed=s)
        if any(c["p"] <= ALPHA for c in res.clusters):
            hits += 1
    rows["cluster_independent_fwer"] = hits / N_SIMS

    # --- PLV surrogate null: POINTWISE rate should be ~alpha ---------------
    sfreq, nn = 250.0, 256
    morse = Morse(sfreq)
    bank = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(np.array([10.0, 30.0], np.float32)),
        nn, sfreq, True), np.float32))
    frac = []
    for s in range(40):
        maybe_clear(s)
        sa = rng.standard_normal((12, nn)).astype(np.float32)
        sb = rng.standard_normal((12, nn)).astype(np.float32)
        _, p = plv_significance(sa, sb, bank, interpolate=True,
                                n_surrogates=99, seed=s)
        frac.append(float((np.asarray(p) <= ALPHA).mean()))
    rows["plv_pointwise_rate"] = float(np.mean(frac))

    # --- spatio-spectral cluster FWER (channel adjacency) ------------------
    hits = 0
    edges = np.array([[0, 1], [1, 2]], np.int32)
    for s in range(N_SIMS // 2):
        maybe_clear(s)
        x = rng.standard_normal((16, 3, 6, 16)).astype(np.float32)
        res = cl.cluster_test_one_sample(x, n_perm=99, seed=s,
                                         adjacency=edges)
        if any(c["p"] <= ALPHA for c in res.clusters):
            hits += 1
    rows["cluster_adjacency_fwer"] = hits / (N_SIMS // 2)

    # --- decoding null: cross-validated AUC must sit at chance -------------
    from ninwavelets_tpu.ops.decoding import tf_decode
    aucs = []
    for s in range(60):
        maybe_clear(s)
        r2 = np.random.default_rng(1000 + s)
        xa = r2.standard_normal((20, 4, 5, 12)).astype(np.float32)
        xb = r2.standard_normal((20, 4, 5, 12)).astype(np.float32)
        aucs.append(float(np.asarray(tf_decode(xa, xb,
                                               n_folds=5)).mean()))
    rows["decode_null_auc_mean"] = float(np.mean(aucs))
    rows["decode_null_auc_sd"] = float(np.std(aucs))

    # --- regression (GLM covariate) cluster FWER ---------------------------
    hits = 0
    for s in range(N_SIMS):
        maybe_clear(s)
        r7 = np.random.default_rng(13000 + s)
        x = r7.standard_normal((18, f, n)).astype(np.float32)
        z = r7.standard_normal(18).astype(np.float32)
        res = cl.cluster_test_regression(x, z, n_perm=99, seed=s)
        if any(c["p"] <= ALPHA for c in res.clusters):
            hits += 1
    rows["cluster_regression_fwer"] = hits / N_SIMS

    # --- F-test (3-group ANOVA) cluster FWER -------------------------------
    hits = 0
    for s in range(N_SIMS):
        maybe_clear(s)
        r8 = np.random.default_rng(15000 + s)
        groups = [r8.standard_normal((8, f, n)).astype(np.float32)
                  for _ in range(3)]
        res = cl.cluster_test_f(groups, n_perm=99, seed=s)
        if any(c["p"] <= ALPHA for c in res.clusters):
            hits += 1
    rows["cluster_f_fwer"] = hits / N_SIMS

    # --- FDR (BH) on all-null maps: P(any rejection) <= alpha --------------
    # under the complete null, BH's FDR equals its FWER, so the any-
    # rejection rate over null t-test p-maps must sit at/below alpha
    from scipy import stats as _st
    hits = 0
    for s in range(N_SIMS):
        maybe_clear(s)
        r3 = np.random.default_rng(5000 + s)
        x = r3.standard_normal((16, 100))
        p = _st.ttest_1samp(x, 0.0, axis=0).pvalue
        rej, _ = cl.fdr_correction(p, alpha=ALPHA)
        if bool(np.asarray(rej).any()):
            hits += 1
    rows["fdr_any_rejection_rate"] = hits / N_SIMS

    # --- wavelet-coherence Monte-Carlo level: pointwise rate ~ 1 - q -------
    from ninwavelets_tpu.ops.extensions import (wavelet_coherence,
                                                wtc_significance)
    nwc = 512
    bank_wc = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(np.array([8.0, 16.0, 32.0],
                                            np.float32)),
        nwc, sfreq, True), np.float32))
    fr_wc = []
    for s in range(30):
        maybe_clear(s)
        r4 = np.random.default_rng(7000 + s)
        sa = r4.standard_normal(nwc).astype(np.float32)
        sb = r4.standard_normal(nwc).astype(np.float32)
        lev = wtc_significance(sa, sb, bank_wc,
                               np.array([8.0, 16.0, 32.0]), sfreq,
                               n_surrogates=60, q=0.95, seed=s)
        coh = wavelet_coherence(sa, sb, bank_wc,
                                np.array([8.0, 16.0, 32.0]),
                                sfreq)
        fr_wc.append(float((np.asarray(coh)
                            > np.asarray(lev)[:, None]).mean()))
    rows["wtc_pointwise_rate_q95"] = float(np.mean(fr_wc))

    # --- PAC circular-shift surrogates: pointwise rate ~ alpha -------------
    from ninwavelets_tpu.ops.connectivity import pac_significance
    # N = 1024 (~25 cycles of the slowest phase band): the shift null
    # is only valid with enough cycles — at N=256 (~6 cycles) the FPR
    # measures 0.13, which is the documented validity limit in
    # ops.connectivity.pac_significance, not an honest operating point
    npac = 1024
    bank_ph_c = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(np.array([6.0, 10.0], np.float32)),
        npac, sfreq, True), np.float32))
    bank_am_c = jnp.asarray(np.asarray(make_fft_bank(
        morse._wdef(), jnp.asarray(np.array([40.0, 60.0], np.float32)),
        npac, sfreq, True), np.float32))
    fr_pac = []
    for s in range(40):
        maybe_clear(s)
        r5 = np.random.default_rng(9000 + s)
        sig_p = r5.standard_normal((12, npac)).astype(np.float32)
        _, p = pac_significance(sig_p, bank_ph_c, bank_am_c,
                                interpolate=True, n_surrogates=99,
                                seed=s)
        fr_pac.append(float((np.asarray(p) <= ALPHA).mean()))
    rows["pac_pointwise_rate"] = float(np.mean(fr_pac))

    # --- Granger trial-shuffle surrogates: pointwise rate ~ alpha ----------
    from ninwavelets_tpu.ops.granger import wavelet_granger_significance
    fr_gc = []
    for s in range(25):
        maybe_clear(s)
        r6 = np.random.default_rng(11000 + s)
        sig_g = r6.standard_normal((12, 2, 512)).astype(np.float32)
        _, p = wavelet_granger_significance(
            sig_g, sfreq, n_surrogates=39, seed=s, n_bins=17,
            time_decim=128, n_iter=30)
        pv = np.asarray(p)
        off = ~np.eye(2, dtype=bool)
        fr_gc.append(float((pv[..., off] <= ALPHA).mean()))
    rows["granger_pointwise_rate"] = float(np.mean(fr_gc))

    rows["n_sims"] = N_SIMS
    rows["alpha"] = ALPHA
    rows["elapsed_s"] = round(time.time() - t0, 1)
    rows["device"] = str(jax.devices()[0])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(rows, fh, indent=1)
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
