"""Dataclass configs mirroring the reference's constructor-kwarg surface.

The reference's only configuration mechanism is constructor kwargs
(``/root/reference/ninwavelets/wavelets.py:38-40, 110-113``); SURVEY §5
commits this build to dataclass configs with the same names and defaults
(``sfreq=1000, b=17.5, r=3, sigma=7, interpolate=False``), plus the engine
knobs this build adds (mesh axes, streaming windows).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MorseConfig:
    """Generalized Morse parameters (reference defaults,
    ``wavelets.py:38``)."""
    sfreq: float = 1000.0
    b: float = 17.5          # beta
    r: float = 3.0           # gamma
    real_wave_length: float = 1.0
    interpolate: bool = False

    def build(self):
        from .models import Morse
        return Morse(self.sfreq, self.b, self.r, self.real_wave_length,
                     self.interpolate)


@dataclass(frozen=True)
class MorletConfig:
    """Morlet/Gabor parameters (reference defaults,
    ``wavelets.py:110-113``)."""
    sfreq: float = 1000.0
    sigma: float = 7.0
    real_wave_length: float = 1.0
    gabor: bool = False
    interpolate: bool = False

    def build(self):
        from .models import Morlet
        return Morlet(self.sfreq, self.sigma, self.real_wave_length,
                      self.gabor, self.interpolate)


@dataclass(frozen=True)
class EngineConfig:
    """Engine knobs (no reference counterpart — the reference's only
    engine switch is the ``cuda`` flag this build ignores)."""
    mesh_shape: Tuple[int, int, int] = (1, 1, 1)   # (data, freq, time)
    streaming_window: int = 65536  # StreamingCWT window, samples
    halo_tol: float = 1e-4         # halo sizing envelope tolerance


@dataclass(frozen=True)
class PipelineConfig:
    """A full analysis pipeline: wavelet + engine + baseline window, plus
    the optional statistics stages (``ops.tc_stats`` / ``ops.ridge``)."""
    wavelet: MorseConfig = field(default_factory=MorseConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    freqs: Tuple[float, float, float] = (1.0, 101.0, 1.0)  # (lo, hi, step) Hz
    baseline: Optional[Tuple[float, float]] = None   # (start_s, stop_s)
    baseline_method: str = "zscore"
    significance: Optional[float] = None   # p-level (e.g. 0.95) -> mask
    global_spectrum: bool = False          # COI-masked time average
    ridge: bool = False                    # per-channel DP ridge (Hz)
    ssq: bool = False                      # epoch-mean synchrosqueezed power
    superlet: Optional[Tuple[int, int]] = None  # (order_min, order_max)
    superlet_sigma: float = 3.0            # base cycle parameter
    connectivity: Optional[str] = None     # None or any subset (comma-sep)
    # of {"plv", "coherence", "wpli", "pli", "dwpli", "ppc", "pcoh",
    # "psi"}; "both" is kept as an alias for "plv,coherence"
    connectivity_window: Optional[Tuple[float, float]] = None  # (start_s, stop_s)
    specparam: bool = False         # FOOOF-style fit of each channel's
    # COI-masked global spectrum (requires ``global_spectrum``)
    specparam_peaks: int = 4
    cluster_test: bool = False      # one-sample cluster permutation test of
    # the baseline-corrected single-trial power against zero (needs
    # ``baseline``); spatio-spectral when ``cluster_adjacency`` is set
    cluster_adjacency: Optional[tuple] = None  # (M, 2) channel edges
    cluster_n_perm: int = 999


def run_pipeline(cfg: PipelineConfig, epochs) -> dict:
    """Execute a configured analysis pipeline over an MNE-style epochs
    container: build the wavelet, compute the all-channel epoch-mean power
    TFR and ITC at ``cfg.freqs`` in one pass over the epochs, and
    optionally baseline-correct the power.

    Returns a dict with ``power`` (C, F, N) and ``itc`` (C, F, N) device
    arrays plus the frequency grid and wavelet instance.  Optional stages
    add: ``significant`` ((C, F, N) bool mask of the UNCORRECTED epoch-mean
    power against each channel's AR(1) background, chi-square 2E DOF),
    ``global_spectrum`` ((C, F), COI-masked time average) with ``coi``
    ((F, N) bool), and ``ridge_hz`` ((C, N) dominant-ridge track).
    """
    import numpy as np

    from .ops.baseline import baseline_tf
    from .ops.cwt import power_itc
    from .utils.mne_adapter import EpochsWavelet

    wavelet = cfg.wavelet.build()
    ew = EpochsWavelet(epochs, wavelet)       # sets wavelet.sfreq
    sfreq = wavelet.sfreq
    freqs = np.arange(*cfg.freqs)
    waves = ew._all_data()
    bank_r, bank_i = ew._bank_for(waves, freqs)
    interp = wavelet.interpolate
    power, itc = power_itc(waves, bank_r, bank_i, interpolate=interp)
    out = {"itc": itc, "freqs": freqs, "wavelet": wavelet}

    if cfg.significance is not None:
        # Per-channel AR(1) fit on the raw epochs; the epoch-mean power is
        # chi-square with 2E DOF against the bank-aware background.
        from .ops import tc_stats
        # AR(1) fitting is host-side numpy: reuse the adapter's host
        # snapshot instead of pulling the device copy back down.
        host = ew._host_data()                        # (E, C, N)
        e_count = host.shape[0]
        masks = []
        for ch in range(host.shape[1]):
            x = host[:, ch, :]
            alpha = float(np.mean([tc_stats.ar1_coefficient(row)
                                   for row in x]))
            var = float(np.mean(np.var(x, axis=-1)))
            masks.append(tc_stats.significant_mask(
                power[ch], bank_r, sfreq, alpha, var,
                p=float(cfg.significance), n_epochs=e_count))
        import jax.numpy as jnp
        out["significant"] = jnp.stack(masks)

    if cfg.ssq:
        # Epoch-mean synchrosqueezed power (extension — ``ops.sst``);
        # reuses the bank already built (real banks only: phase needed).
        if bank_i is not None:
            raise ValueError(
                "ssq needs an analytic (real-bank) wavelet family — "
                "Normal/Twice-mode banks carry no usable phase")
        from .ops.sst import ssq_mean_power
        out["ssq_power"] = ssq_mean_power(waves, bank_r, freqs, sfreq,
                                          interpolate=interp)

    if cfg.superlet is not None:
        # Fractional adaptive superlet power (extension — ``ops.superlets``;
        # its own growing-cycle Morlet member banks, independent of the
        # pipeline wavelet's bank).
        from .ops.superlets import superlet_mean_power
        o_min, o_max = cfg.superlet
        out["superlet_power"] = superlet_mean_power(
            waves, freqs, sfreq, base_sigma=cfg.superlet_sigma,
            order_min=int(o_min), order_max=int(o_max), interpolate=interp)

    if cfg.connectivity is not None:
        # All-pairs (F, C, C) matrices over every channel (extension —
        # ``ops.connectivity``); reuses the bank already built for the TFR.
        from .ops.connectivity import (coherence_matrix,
                                       partial_coherence, plv_matrix,
                                       ppc_matrix, psi_matrix,
                                       wpli_matrix)
        known = ("plv", "coherence", "wpli", "pli", "dwpli", "ppc",
                 "pcoh", "psi")
        asked = ("plv", "coherence") if cfg.connectivity == "both" else \
            tuple(m.strip() for m in cfg.connectivity.split(","))
        bad = [m for m in asked if m not in known]
        if bad:
            raise ValueError(
                f"connectivity must be 'both' or a comma-separated subset "
                f"of {known}, got {cfg.connectivity!r}")
        trange = None
        if cfg.connectivity_window is not None:
            start_s, stop_s = cfg.connectivity_window
            trange = (int(round(start_s * sfreq)),
                      int(round(stop_s * sfreq)))
        if bank_i is not None and set(asked) - {"coherence"}:
            raise ValueError(
                "phase connectivity needs an analytic (real-bank) wavelet "
                "family — Normal/Twice-mode banks carry no usable phase")
        if "plv" in asked:
            out["plv_matrix"] = plv_matrix(
                waves, bank_r, interpolate=interp, time_range=trange)
        if "coherence" in asked:
            out["coherence_matrix"] = coherence_matrix(
                waves, bank_r, bank_i, interpolate=interp, time_range=trange)
        for m in ("pli", "wpli", "dwpli"):
            if m in asked:
                out[f"{m}_matrix"] = wpli_matrix(
                    waves, bank_r, method=m, interpolate=interp,
                    time_range=trange)
        if "ppc" in asked:
            out["ppc_matrix"] = ppc_matrix(
                waves, bank_r, interpolate=interp, time_range=trange)
        if "pcoh" in asked:
            out["partial_coherence"] = partial_coherence(
                waves, bank_r, interpolate=interp, time_range=trange)
        if "psi" in asked:
            # directed (C, C) phase-slope index, jackknife-normalized;
            # adjacent bank rows form the slope, so the grid must
            # ascend — a descending arange would silently NEGATE every
            # direction estimate.
            if len(freqs) < 2 or freqs[1] <= freqs[0]:
                raise ValueError(
                    "connectivity='psi' needs an ascending cfg.freqs "
                    f"grid with >= 2 rows, got {cfg.freqs}")
            out["psi_matrix"] = psi_matrix(
                waves, bank_r, interpolate=interp, time_range=trange)

    if cfg.global_spectrum or cfg.ridge:
        from .ops import tc_stats
        if cfg.global_spectrum:
            tau = tc_stats.efolding_times(wavelet._wdef(), freqs, sfreq)
            coi = tc_stats.coi_mask(power.shape[-1], sfreq, tau)
            import jax.numpy as jnp
            out["coi"] = coi
            out["global_spectrum"] = tc_stats.global_spectrum(
                power, jnp.asarray(coi))
        if cfg.ridge:
            from .ops.ridge import ridge_frequencies
            # power[ch] stays on device (extract_ridge is jitted); only
            # the (N,) track crosses to host — pulling the (F, N) plane
            # would cost seconds over a slow D2H link.
            out["ridge_hz"] = np.stack([
                ridge_frequencies(power[ch], freqs)
                for ch in range(power.shape[0])])

    if cfg.specparam:
        # Aperiodic + peaks parametrization of the global wavelet
        # spectrum (extension — ``ops.specparam``).
        if not cfg.global_spectrum:
            raise ValueError("specparam needs global_spectrum=True "
                             "(it fits the COI-masked global spectrum)")
        from .ops.specparam import specparam as _specfit
        out["specparam"] = _specfit(
            np.asarray(out["global_spectrum"]), freqs,
            max_peaks=int(cfg.specparam_peaks))

    if cfg.cluster_test:
        # Cluster permutation inference (extension — ``ops.cluster``):
        # one-sample sign-flip test of the baseline-corrected single-trial
        # power against zero, across ALL channels (spatio-spectral with
        # ``cluster_adjacency`` edges; empty adjacency still corrects the
        # FWER over every channel).
        if cfg.baseline is None:
            raise ValueError(
                "cluster_test needs baseline=(start, stop) so zero is the "
                "null hypothesis for the single-trial planes")
        from .ops import cluster as _cluster
        from .ops.cwt import power as xla_power
        from .utils.mne_adapter import EpochsWavelet as _EW
        trials = xla_power(waves, bank_r, bank_i, interpolate=interp)
        trials = baseline_tf(trials, sfreq, cfg.baseline[0],
                             cfg.baseline[1], cfg.baseline_method)
        adj = _EW._as_edges(() if cfg.cluster_adjacency is None
                            else cfg.cluster_adjacency)
        out["cluster"] = _cluster.cluster_test_one_sample(
            trials, n_perm=int(cfg.cluster_n_perm), adjacency=adj)

    if cfg.baseline is not None:
        start, stop = cfg.baseline
        power = baseline_tf(power, sfreq, start, stop, cfg.baseline_method)
    out["power"] = power
    return out
