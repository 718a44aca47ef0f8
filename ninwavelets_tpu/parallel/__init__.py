"""Multi-device scale-out: mesh construction, sharded epoch/frequency
transforms, and sequence-parallel chunked CWT for long recordings.

The reference has no distributed layer (SURVEY §2.2); this package is the
device-mesh replacement for its latent parallel axes — the Python epoch loop
(``mneutils.py:37-40``), the per-frequency bank list (``base.py:275-278``)
and the whole-signal FFT (``base.py:399``) — as ``shard_map`` programs over a
(data, freq, time) ``jax.sharding.Mesh`` with XLA collectives (``pmean`` for
epoch reductions, ``ppermute`` for time-axis halos).
"""
from .api import distributed_itc, distributed_mean_power
from .chunked import (chunk_bank, chunked_abs, chunked_cwt_ri,
                      chunked_power,
                      halo_samples, pow2_halo)
from .mesh import (DATA_AXIS, FREQ_AXIS, TIME_AXIS, auto_mesh, flat_mesh,
                   init_multihost, make_mesh, pad_to_multiple, shard_batch)
from .sharded import (sharded_cluster_null,
                      sharded_cluster_test_independent,
                      sharded_cluster_test_one_sample,
                      sharded_coherence, sharded_coherence_matrix,
                      sharded_cross_power, sharded_cwt_ri,
                      sharded_itc, sharded_mean_power,
                      sharded_mean_power_grad, sharded_nm_plv,
                      sharded_imcoh, sharded_modwt,
                      sharded_multitaper_mean_power,
                      sharded_pac, sharded_phase_lag,
                      sharded_ppc,
                      sharded_plv, sharded_plv_matrix, sharded_power,
                      sharded_psi_matrix,
                      sharded_partial_coherence,
                      sharded_env_corr, sharded_stockwell,
                      sharded_tf_decode,
                      sharded_reassigned_mean_power,
                      sharded_ssq_mean_power, sharded_superlet_mean_power,
                      sharded_wavelet_granger,
                      sharded_hmm_fit, sharded_fastica,
                      sharded_covariance, sharded_csp,
                      sharded_cluster_test_f)
from .online import OnlineCWT
from .streaming import StreamingCWT

__all__ = [
    "DATA_AXIS", "FREQ_AXIS", "TIME_AXIS",
    "make_mesh", "flat_mesh", "auto_mesh", "shard_batch", "pad_to_multiple",
    "init_multihost",
    "sharded_mean_power", "sharded_itc", "sharded_cwt_ri", "sharded_power",
    "sharded_cross_power", "sharded_coherence", "sharded_ssq_mean_power",
    "sharded_reassigned_mean_power",
    "sharded_plv", "sharded_plv_matrix", "sharded_coherence_matrix",
    "sharded_psi_matrix", "sharded_partial_coherence",
    "sharded_pac", "sharded_mean_power_grad", "sharded_nm_plv",
    "sharded_phase_lag", "sharded_ppc",
    "sharded_imcoh", "sharded_modwt",
    "sharded_hmm_fit", "sharded_fastica",
    "sharded_covariance", "sharded_csp",
    "sharded_cluster_null", "sharded_cluster_test_one_sample",
    "sharded_cluster_test_independent", "sharded_cluster_test_f",
    "sharded_superlet_mean_power", "sharded_multitaper_mean_power",
    "sharded_wavelet_granger", "sharded_env_corr", "sharded_stockwell",
    "sharded_tf_decode",
    "distributed_mean_power", "distributed_itc",
    "chunk_bank", "chunked_power", "chunked_abs", "chunked_cwt_ri",
    "halo_samples", "pow2_halo", "StreamingCWT", "OnlineCWT",
]
