"""MNE epochs ingestion — ``EpochsWavelet`` rebuilt batched & on-device.

Reference: ``/root/reference/ninwavelets/mneutils.py:9-71`` — a Python loop
calling ``wavelet.cwt`` once per epoch for a single channel.  Here the whole
(epochs, channels, time) block is moved to the device once and the CWT +
epoch reductions run as one jitted program with a streaming scan over epochs
(O(C*F*N) memory, not O(E*C*F*N)).

``EpochsWavelet`` keeps the reference per-channel API (``cwt(ch_name,
freqs)``, ``power``, ``itc``) and adds the batched all-channel forms the
reference lacks (``power_all``, ``itc_all``, ``cwt_all``).  The ``epochs``
argument only needs the duck-typed MNE surface the reference touches:
``.info['sfreq']``, ``.ch_names`` and ``.get_data()`` — so it works with
real ``mne.Epochs`` without importing mne.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..ops.cwt import cwt_ri as _cwt_jit
from ..ops.cwt import itc as _itc_jit
from ..ops.cwt import mean_power as _mean_power_jit
from ..ops.signal_utils import pad_to
from ..models.base import Numbers, WaveletBase


def _welch_of(data, ch_names, sfreq, picks, nperseg, band,
              epoch_mean=False):
    """Shared Welch-PSD plumbing for the adapters: pick channels on
    host, clamp ``nperseg`` to the largest power of two that fits the
    record (the FFT's fastest length), optionally band-crop, return host
    numpy."""
    from ..ops.irasa import welch_psd
    if picks is not None:
        data = data[..., [ch_names.index(ch) for ch in picks], :]
    n = data.shape[-1]
    seg = 1 << min(int(nperseg).bit_length() - 1, int(n).bit_length() - 1)
    if seg < 4:
        raise ValueError(f"record too short for Welch PSD (N={n})")
    psd = welch_psd(data, sfreq=float(sfreq), nperseg=seg)
    if epoch_mean and psd.ndim == 3:
        psd = jnp.mean(psd, axis=0)
    freqs = np.arange(seg // 2 + 1) * float(sfreq) / seg
    if band is not None:
        lo, hi = float(band[0]), float(band[1])
        keep = (freqs >= lo) & (freqs <= hi)
        if not keep.any():
            raise ValueError(f"band {band} outside the PSD grid "
                             f"(0..{freqs[-1]:g} Hz)")
        psd = psd[..., keep]
        freqs = freqs[keep]
    return freqs, np.asarray(psd)


class EpochsWavelet:
    """Wavelet transforms over an MNE-style epochs container.

    Parameters
    ----------
    epochs: an ``mne.Epochs``-like object (``.info['sfreq']``, ``.ch_names``,
        ``.get_data() -> (E, C, N)``).
    wavelet: a ``WaveletBase`` instance.  Its ``sfreq`` is overwritten from
        ``epochs.info`` exactly as the reference does (``mneutils.py:24``).
    """

    def __init__(self, epochs, wavelet: WaveletBase) -> None:
        self.epochs = epochs
        self.wavelet = wavelet
        wavelet.sfreq = float(epochs.info['sfreq'])

    # -- internals -------------------------------------------------------

    def _fingerprint(self):
        """Cheap identity of the epochs' current state: the reference
        refetches ``get_data()`` per call; we cache, but invalidate when the
        epochs object is visibly mutated (cropped / decimated / channel-
        picked change len, channel count, or sample count)."""
        try:
            n_times = len(self.epochs.times)
        except (AttributeError, TypeError):
            n_times = None
        return (id(self.epochs), len(self.epochs.ch_names),
                getattr(self.epochs, '__len__', lambda: None)(), n_times)

    def invalidate(self) -> None:
        """Drop the cached ``get_data()`` snapshot (host and device) — call
        after in-place mutations the fingerprint can't see (e.g. filtering
        that keeps every shape identical)."""
        for attr in ('_host', '_data', '_fp'):
            if hasattr(self, attr):
                delattr(self, attr)

    def _host_data(self) -> np.ndarray:
        """Host copy of ``epochs.get_data()``, fetched once per epochs state
        (MNE may load/copy the full array on every call); the cache is keyed
        on a shape/length fingerprint so crops or channel picks refetch."""
        fp = self._fingerprint()
        if getattr(self, '_fp', None) != fp:
            self.invalidate()
            self._fp = fp
        if not hasattr(self, '_host'):
            self._host = np.asarray(self.epochs.get_data()).astype(
                np.float32)
        return self._host

    def _channel_data(self, ch_name: str) -> jnp.ndarray:
        # Slice on host so a single-channel request transfers only (E, N),
        # not the whole (E, C, N) recording.
        idx = self.epochs.ch_names.index(ch_name)
        return jnp.asarray(self._host_data()[:, idx, :])

    def _bank_for(self, waves: jnp.ndarray, freqs: Optional[Numbers]):
        w = self.wavelet
        if not hasattr(w, '_bank_r'):
            if freqs is None:
                raise ValueError("freqs is required when no bank is cached")
            w._build_bank(freqs, waves.shape[-1] / w.sfreq)
        bank_r = pad_to(w._bank_r, waves)
        bank_i = None if w._bank_i is None else pad_to(w._bank_i, waves)
        return bank_r, bank_i

    # -- reference-parity per-channel API ---------------------------------

    def cwt(self, ch_name: str, freqs: Numbers) -> jnp.ndarray:
        """(E, F, N) CWT of one channel (``mneutils.py:26-40``) — the
        reference's per-epoch Python loop collapsed into one batched call.
        """
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        r, i = _cwt_jit(waves, bank[0], bank[1],
                        interpolate=self.wavelet.interpolate)
        return np.asarray(r) + 1j * np.asarray(i)

    @staticmethod
    def _post(tf, sfreq, baseline, baseline_method, decim):
        """Shared epilogue: optional per-row baseline correction (the
        reference's separate ``Baseline`` step folded in, mne-style), then
        time decimation (mne's ``decim`` — plain slicing AFTER the
        transform, so no aliasing of the TFR statistics)."""
        if baseline is not None:
            from ..ops.baseline import baseline_tf
            tf = baseline_tf(tf, sfreq, baseline[0], baseline[1],
                             baseline_method)
        if decim and decim != 1:
            tf = tf[..., ::int(decim)]
        return tf

    def power(self, ch_name: str, freqs: Numbers,
              baseline=None, baseline_method: str = "zscore",
              decim: int = 1) -> jnp.ndarray:
        """(F, N) epoch-mean power TFR (``mneutils.py:42-55``), with the
        |cwt|^2 + mean fused on device.

        Extensions over the reference (mne-style conveniences):
        ``baseline=(start_s, stop_s)`` applies the per-row correction of
        ``ops.baseline.baseline_tf`` in the same device program;
        ``decim`` slices the time axis of the RESULT by that factor.
        """
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        tf = _mean_power_jit(waves[:, None, :], bank[0], bank[1],
                             interpolate=self.wavelet.interpolate)[0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def itc(self, ch_name: str, freqs: Numbers) -> jnp.ndarray:
        """(F, N) inter-trial coherence (``mneutils.py:57-71``)."""
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        return _itc_jit(waves[:, None, :], bank[0], bank[1],
                        interpolate=self.wavelet.interpolate)[0]

    # -- batched extensions (all channels in one device program) ---------

    def _all_data(self) -> jnp.ndarray:
        """Device copy of the full (E, C, N) block for the ``*_all``
        methods (cached; invalidated with the host snapshot)."""
        host = self._host_data()   # refreshes the fingerprint/cache first
        if not hasattr(self, '_data'):
            self._data = jnp.asarray(host)
        return self._data

    def cwt_all(self, freqs: Numbers) -> jnp.ndarray:
        """(E, C, F, N) CWT of every channel and epoch in one program.
        Memory scales with the full coefficient tensor — prefer the epoch
        reductions below for large batches.
        """
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        r, i = _cwt_jit(waves, bank[0], bank[1],
                        interpolate=self.wavelet.interpolate)
        return np.asarray(r) + 1j * np.asarray(i)

    def power_all(self, freqs: Numbers, baseline=None,
                  baseline_method: str = "zscore",
                  decim: int = 1) -> jnp.ndarray:
        """(C, F, N) epoch-mean power for ALL channels, one device program.
        Same ``baseline``/``decim`` conveniences as ``power``."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        tf = _mean_power_jit(waves, bank[0], bank[1],
                             interpolate=self.wavelet.interpolate)
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def itc_all(self, freqs: Numbers) -> jnp.ndarray:
        """(C, F, N) inter-trial coherence for ALL channels."""
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        return _itc_jit(waves, bank[0], bank[1],
                        interpolate=self.wavelet.interpolate)

    def power_itc_all(self, freqs: Numbers):
        """((C, F, N), (C, F, N)) epoch-mean power AND inter-trial
        coherence for all channels in ONE pass over the epochs (extension —
        ``ops.cwt.power_itc``: each epoch's coefficients feed both
        reductions)."""
        from ..ops.cwt import power_itc
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        return power_itc(waves, bank[0], bank[1],
                         interpolate=self.wavelet.interpolate)

    def _ssq_bank(self, waves, freqs):
        bank_r, bank_i = self._bank_for(waves, freqs)
        if bank_i is not None:
            raise ValueError(
                "synchrosqueezing needs an analytic (real-bank) family — "
                "Normal/Twice-mode banks carry no usable phase")
        return bank_r

    def ssq_power(self, ch_name: str, freqs: Numbers,
                  rel_threshold: float = 1e-6) -> jnp.ndarray:
        """(F, N) epoch-mean SYNCHROSQUEEZED power of one channel
        (extension — ``ops.sst``): each epoch's scalogram energy is
        reassigned to its instantaneous-frequency row before the epoch
        mean, sharpening evoked ridges the plain ``power`` smears over the
        wavelet bandwidth.  Epochs stream through a scan (O(F*N) memory).
        """
        from ..ops.sst import ssq_mean_power as _ssq_mean
        waves = self._channel_data(ch_name)
        bank_r = self._ssq_bank(waves, freqs)
        return _ssq_mean(waves[:, None, :], bank_r,
                         self.wavelet._bank_freqs, self.wavelet.sfreq,
                         interpolate=self.wavelet.interpolate,
                         rel_threshold=rel_threshold)[0]

    def ssq_power_all(self, freqs: Numbers,
                      rel_threshold: float = 1e-6) -> jnp.ndarray:
        """(C, F, N) epoch-mean synchrosqueezed power for ALL channels."""
        from ..ops.sst import ssq_mean_power as _ssq_mean
        waves = self._all_data()
        bank_r = self._ssq_bank(waves, freqs)
        return _ssq_mean(waves, bank_r, self.wavelet._bank_freqs,
                         self.wavelet.sfreq,
                         interpolate=self.wavelet.interpolate,
                         rel_threshold=rel_threshold)

    def reassigned_power(self, ch_name: str, freqs: Numbers,
                         rel_threshold: float = 1e-6,
                         t_decim: int = 16) -> jnp.ndarray:
        """(F, ceil(N/t_decim)) epoch-mean REASSIGNED scalogram of one
        channel (extension — ``ops.reassign``, Auger & Flandrin 1995):
        2-D reassignment moves each cell's energy to its local centroid
        in BOTH time and frequency (synchrosqueezing sharpens frequency
        only), per trial, then averages.  Analytic families only."""
        from ..ops.reassign import reassigned_mean_power as _ra
        waves = self._channel_data(ch_name)
        bank_r = self._ssq_bank(waves, freqs)
        return _ra(waves, bank_r, self.wavelet._bank_freqs,
                   self.wavelet.sfreq,
                   interpolate=self.wavelet.interpolate,
                   rel_threshold=rel_threshold, t_decim=t_decim)

    def tfr_power2d(self, ch_name: str, freqs: Numbers,
                    img_freqs=(0.02, 0.05, 0.1, 0.2), thetas=None,
                    log_power: bool = True):
        """Directional 2-D wavelet analysis OF the epoch-mean TFR plane
        (extension — ``ops.cwt2d``, the reference roadmap's "2D wavelet",
        ``README.md:524``): the (F, N) spectro-temporal map is treated as
        an image and decomposed over oriented 2-D Morlets, so horizontal
        ridges (sustained rhythms), vertical edges (broadband events) and
        oblique structure (chirps / frequency sweeps) land in different
        orientation channels.

        Returns ``(power, (F, N))``: power is (F2, T, Fp, Np) over the
        pow2-padded plane, the tuple is the crop for the original sizes.
        ``img_freqs`` are cycles/pixel of the TFR image; ``log_power``
        applies log1p first (the usual variance stabilization before
        image analysis)."""
        from ..ops.cwt2d import pow2_pad2, power2d
        plane = self.power(ch_name, freqs)           # (F, N)
        if log_power:
            plane = jnp.log1p(plane)
        padded, crop = pow2_pad2(plane)
        return power2d(padded, img_freqs, thetas), crop

    def superlet_power(self, ch_name: str, freqs: Numbers,
                       sigma: float = 3.0, order_min: int = 1,
                       order_max: int = 8,
                       adaptive: bool = True) -> jnp.ndarray:
        """(F, N) epoch-mean SUPERLET power of one channel (extension —
        ``ops.superlets``, Moca 2021): the fractional adaptive
        superresolution estimator, with its own growing-cycle Morlet
        member banks (independent of this wavelet's bank; the wavelet
        object only contributes ``sfreq``/``interpolate``)."""
        from ..ops.superlets import superlet_mean_power
        waves = self._channel_data(ch_name)
        return superlet_mean_power(
            waves[:, None, :], np.asarray(freqs, np.float32),
            self.wavelet.sfreq, base_sigma=sigma, order_min=order_min,
            order_max=order_max, adaptive=adaptive,
            interpolate=self.wavelet.interpolate)[0]

    def multitaper_power(self, ch_name: str, freqs: Numbers,
                         n_tapers: int = 3, b=None, r=None) -> jnp.ndarray:
        """(F, N) epoch-mean MULTITAPER Morse power of one channel
        (extension — ``ops.multitaper``, Olhede & Walden 2002): the mean
        over ``n_tapers`` orthogonal Morse orders, ~1/K the single-taper
        estimator variance.  ``b``/``r`` default to this wavelet's Morse
        parameters when it has them (taper 0 then matches ``power``)."""
        from ..ops.multitaper import multitaper_mean_power
        waves = self._channel_data(ch_name)
        return multitaper_mean_power(
            waves[:, None, :], np.asarray(freqs, np.float32),
            self.wavelet.sfreq,
            b=float(getattr(self.wavelet, "b", 17.5) if b is None else b),
            r=float(getattr(self.wavelet, "r", 3.0) if r is None else r),
            n_tapers=n_tapers, interpolate=self.wavelet.interpolate)[0]

    def induced_power(self, ch_name: str, freqs: Numbers,
                      baseline=None, baseline_method: str = "zscore",
                      decim: int = 1) -> jnp.ndarray:
        """(F, N) INDUCED power: the evoked (phase-locked epoch-mean)
        response is subtracted from every epoch before the TFR, leaving
        non-phase-locked oscillatory power (standard event-related
        practice; extension — the reference computes total power only)."""
        waves = self._channel_data(ch_name)
        waves = waves - jnp.mean(waves, axis=0, keepdims=True)
        bank = self._bank_for(waves, freqs)
        tf = _mean_power_jit(waves[:, None, :], bank[0], bank[1],
                             interpolate=self.wavelet.interpolate)[0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def evoked_power(self, ch_name: str, freqs: Numbers,
                     baseline=None, baseline_method: str = "zscore",
                     decim: int = 1) -> jnp.ndarray:
        """(F, N) EVOKED power: the TFR of the epoch-mean (phase-locked)
        response itself."""
        waves = jnp.mean(self._channel_data(ch_name), axis=0)
        bank = self._bank_for(waves, freqs)
        tf = _mean_power_jit(waves[None, None, :], bank[0], bank[1],
                             interpolate=self.wavelet.interpolate)[0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def single_trial_power(self, ch_name: str, freqs: Numbers,
                           baseline=None, baseline_method: str = "zscore",
                           decim: int = 1) -> jnp.ndarray:
        """(E, F, N) per-epoch power planes — the single-trial input of
        the cluster permutation tests (extension; the reference only
        exposes the epoch MEAN, ``mneutils.py:53-55``)."""
        from ..ops.cwt import power as _power
        waves = self._channel_data(ch_name)
        bank = self._bank_for(waves, freqs)
        tf = _power(waves[:, None, :], bank[0], bank[1],
                    interpolate=self.wavelet.interpolate)[:, 0]
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def single_trial_power_all(self, freqs: Numbers, baseline=None,
                               baseline_method: str = "zscore",
                               decim: int = 1) -> jnp.ndarray:
        """(E, C, F, N) per-epoch power planes for ALL channels — the
        input of the spatio-spectral cluster tests."""
        from ..ops.cwt import power as _power
        waves = self._all_data()
        bank = self._bank_for(waves, freqs)
        tf = _power(waves, bank[0], bank[1],
                    interpolate=self.wavelet.interpolate)
        return self._post(tf, self.wavelet.sfreq, baseline,
                          baseline_method, decim)

    def cluster_test_all(self, freqs: Numbers, other=None, *,
                         adjacency=(), paired: bool = False, baseline=None,
                         baseline_method: str = "zscore", decim: int = 1,
                         n_perm: int = 999, threshold=None,
                         alpha: float = 0.05, seed: int = 0, mesh=None):
        """Spatio-spectral cluster permutation test over ALL channels
        (extension — the MNE ``spatio_temporal_cluster_test`` analog):
        clusters live in (channel, frequency, time) with 4-connectivity
        in the TF plane plus same-pixel links between ``adjacency``
        channel edges ((M, 2) ints, or an (C, C) boolean matrix; the
        default empty adjacency keeps channels independent but still
        corrects across all of them).  Other arguments as
        :meth:`cluster_test`.
        """
        from ..ops import cluster as _cl
        adjacency = self._as_edges(adjacency)
        if other is None and baseline is None:
            # validate BEFORE the expensive all-channel transform
            raise ValueError(
                "one-sample cluster test needs baseline=(start, stop) "
                "so zero is the null hypothesis for the trial planes")
        x = self.single_trial_power_all(freqs, baseline, baseline_method,
                                        decim)
        if other is None:
            y = None
        elif isinstance(other, EpochsWavelet):
            y = other.single_trial_power_all(freqs, baseline,
                                             baseline_method, decim)
        else:
            y = jnp.asarray(other, jnp.float32)
        if y is not None and paired:
            x, y = x - y, None
        if mesh is not None:
            from ..parallel.sharded import (
                sharded_cluster_test_independent,
                sharded_cluster_test_one_sample)
            if y is None:
                return sharded_cluster_test_one_sample(
                    x, mesh=mesh, n_perm=n_perm, threshold=threshold,
                    alpha=alpha, seed=seed, adjacency=adjacency)
            return sharded_cluster_test_independent(
                x, y, mesh=mesh, n_perm=n_perm, threshold=threshold,
                alpha=alpha, seed=seed, adjacency=adjacency)
        if y is None:
            return _cl.cluster_test_one_sample(
                x, n_perm=n_perm, threshold=threshold, alpha=alpha,
                seed=seed, adjacency=adjacency)
        return _cl.cluster_test_independent(
            x, y, n_perm=n_perm, threshold=threshold, alpha=alpha,
            seed=seed, adjacency=adjacency)

    @staticmethod
    def _as_edges(adjacency) -> np.ndarray:
        """Normalize a channel adjacency to an (M, 2) int edge array:
        accepts an edge list/array or a square boolean/0-1 matrix (upper
        triangle taken, diagonal ignored)."""
        adjacency = np.asarray(adjacency)
        if adjacency.size == 0:
            return np.zeros((0, 2), np.int32)
        if adjacency.ndim == 2 and adjacency.shape[0] == adjacency.shape[1] \
                and (adjacency.shape[1] != 2 or adjacency.dtype == bool):
            iu, ju = np.triu_indices(adjacency.shape[0], k=1)
            keep = adjacency[iu, ju] != 0
            return np.stack([iu[keep], ju[keep]], -1).astype(np.int32)
        return adjacency.reshape(-1, 2).astype(np.int32)

    def cluster_regression(self, ch_name: str, freqs: Numbers,
                           covariate, *, baseline=None,
                           baseline_method: str = "zscore",
                           decim: int = 1, n_perm: int = 999,
                           threshold=None, alpha: float = 0.05,
                           seed: int = 0):
        """Cluster permutation test of a CONTINUOUS per-trial covariate
        (reaction time, intensity, dose...) against this channel's
        single-trial power (extension — ``ops.cluster_test_regression``):
        pixelwise regression t, covariate shuffled across trials for the
        null.  Baseline correction optional (the regression centers the
        planes itself)."""
        from ..ops import cluster as _cl
        x = self.single_trial_power(ch_name, freqs, baseline,
                                    baseline_method, decim)
        return _cl.cluster_test_regression(
            x, np.asarray(covariate, np.float32), n_perm=n_perm,
            threshold=threshold, alpha=alpha, seed=seed)

    def cluster_f(self, ch_name: str, freqs: Numbers, others, *,
                  baseline=None, baseline_method: str = "zscore",
                  decim: int = 1, n_perm: int = 999, threshold=None,
                  alpha: float = 0.05, seed: int = 0, mesh=None):
        """One-way-ANOVA cluster permutation test across G >= 2
        conditions of this channel's single-trial power (extension —
        ``ops.cluster.cluster_test_f``): this adapter is condition 1;
        ``others`` is a sequence of ``EpochsWavelet`` adapters (same
        channel/freqs computed there) or precomputed (E_g, F, N) arrays
        for the remaining conditions.  ``mesh`` shards the relabeling
        null over its ``data`` axis (same seed -> identical result)."""
        from ..ops import cluster as _cl
        groups = [self.single_trial_power(ch_name, freqs, baseline,
                                          baseline_method, decim)]
        for o in others:
            if isinstance(o, EpochsWavelet):
                groups.append(o.single_trial_power(
                    ch_name, freqs, baseline, baseline_method, decim))
            else:
                groups.append(jnp.asarray(o, jnp.float32))
        if mesh is not None:
            from ..parallel.sharded import sharded_cluster_test_f
            return sharded_cluster_test_f(
                groups, mesh=mesh, n_perm=n_perm, threshold=threshold,
                alpha=alpha, seed=seed)
        return _cl.cluster_test_f(groups, n_perm=n_perm,
                                  threshold=threshold, alpha=alpha,
                                  seed=seed)

    def cluster_test(self, ch_name: str, freqs: Numbers, other=None, *,
                     paired: bool = False, baseline=None,
                     baseline_method: str = "zscore", decim: int = 1,
                     n_perm: int = 999, threshold=None, alpha: float = 0.05,
                     seed: int = 0, mesh=None):
        """Cluster-based permutation test (Maris & Oostenveld 2007) on
        this channel's single-trial power planes (extension —
        ``ops.cluster``).

        ``other=None`` runs the one-sample sign-flip test of the
        baseline-corrected power against zero (``baseline`` is REQUIRED:
        raw power has no meaningful zero).  ``other`` may be another
        ``EpochsWavelet`` (same channel/freqs computed there) or a
        precomputed (E, F, N) array; ``paired=True`` tests the per-epoch
        difference, else the independent-groups relabeling null.
        ``mesh`` shards the permutation null over its ``data`` axis
        (same seed -> identical result to the single-device path).
        """
        from ..ops import cluster as _cl
        x = self.single_trial_power(ch_name, freqs, baseline,
                                    baseline_method, decim)
        if other is None:
            if baseline is None:
                raise ValueError(
                    "one-sample cluster test needs baseline=(start, stop) "
                    "so zero is the null hypothesis for the trial planes")
            if mesh is not None:
                from ..parallel.sharded import \
                    sharded_cluster_test_one_sample
                return sharded_cluster_test_one_sample(
                    x, mesh=mesh, n_perm=n_perm, threshold=threshold,
                    alpha=alpha, seed=seed)
            return _cl.cluster_test_one_sample(
                x, n_perm=n_perm, threshold=threshold, alpha=alpha,
                seed=seed)
        if isinstance(other, EpochsWavelet):
            y = other.single_trial_power(ch_name, freqs, baseline,
                                         baseline_method, decim)
        else:
            y = jnp.asarray(other, jnp.float32)
        if paired:
            if mesh is not None:
                from ..parallel.sharded import \
                    sharded_cluster_test_one_sample
                return sharded_cluster_test_one_sample(
                    x - y, mesh=mesh, n_perm=n_perm, threshold=threshold,
                    alpha=alpha, seed=seed)
            return _cl.cluster_test_paired(
                x, y, n_perm=n_perm, threshold=threshold, alpha=alpha,
                seed=seed)
        if mesh is not None:
            from ..parallel.sharded import \
                sharded_cluster_test_independent
            return sharded_cluster_test_independent(
                x, y, mesh=mesh, n_perm=n_perm, threshold=threshold,
                alpha=alpha, seed=seed)
        return _cl.cluster_test_independent(
            x, y, n_perm=n_perm, threshold=threshold, alpha=alpha,
            seed=seed)

    # -- connectivity extensions ------------------------------------------

    def _conn_bank(self, n: int, freqs: Numbers, need_phase: bool = True):
        """Signal-length bank for the connectivity metrics, built directly
        (NOT via the wavelet's cached bank — connectivity runs at the
        epochs' sample count and must not stomp the cwt/power cache)."""
        from ..ops import bank as _bank
        w = self.wavelet
        arr = w._check_freqs(freqs)
        br, bi = _bank.make_fft_bank_ri(w._wdef(), arr, int(n), w.sfreq,
                                        w.interpolate, w.real_wave_length)
        if need_phase and bi is not None:
            raise ValueError(
                "phase metrics need an analytic (real-bank) family — "
                "Normal/Twice-mode banks carry no usable phase")
        return br, bi

    def plv(self, ch_a: str, ch_b: str, freqs: Numbers,
            eps: float = 0.0) -> jnp.ndarray:
        """(F, N) phase-locking value between two channels across epochs
        (extension — ``ops.connectivity.plv``): the cross-channel analog
        of ``itc``."""
        from ..ops.connectivity import plv as _plv
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        br, _ = self._conn_bank(sa.shape[-1], freqs)
        return _plv(sa, sb, br, interpolate=self.wavelet.interpolate,
                    eps=eps)

    def coherence(self, ch_a: str, ch_b: str, freqs: Numbers,
                  eps: float = 1e-12) -> jnp.ndarray:
        """(F, N) epoch-wise wavelet coherence between two channels
        (extension — ``ops.extensions.epoch_coherence``)."""
        from ..ops.extensions import epoch_coherence as _coh
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        br, bi = self._conn_bank(sa.shape[-1], freqs, need_phase=False)
        return _coh(sa, sb, br, bi, interpolate=self.wavelet.interpolate,
                    eps=eps)

    def phase_lag(self, ch_a: str, ch_b: str, freqs: Numbers,
                  method: str = "wpli", eps: float = 0.0) -> jnp.ndarray:
        """(F, N) phase-lag connectivity between two channels across
        epochs (extension — ``ops.connectivity.phase_lag``):
        ``method="pli"`` (phase-lag index), ``"wpli"`` (weighted PLI) or
        ``"dwpli"`` (debiased wPLI-square).  All three see only the
        IMAGINARY cross-spectrum, so zero-lag volume-conduction coupling
        — which inflates ``plv``/``coherence`` — contributes nothing."""
        from ..ops.connectivity import phase_lag as _pl
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        br, _ = self._conn_bank(sa.shape[-1], freqs)
        return _pl(sa, sb, br, method=method,
                   interpolate=self.wavelet.interpolate, eps=eps)

    def pli(self, ch_a: str, ch_b: str, freqs: Numbers,
            eps: float = 0.0) -> jnp.ndarray:
        """(F, N) phase-lag index (``phase_lag(method="pli")``)."""
        return self.phase_lag(ch_a, ch_b, freqs, "pli", eps)

    def wpli(self, ch_a: str, ch_b: str, freqs: Numbers,
             eps: float = 0.0) -> jnp.ndarray:
        """(F, N) weighted phase-lag index (``phase_lag(method="wpli")``)."""
        return self.phase_lag(ch_a, ch_b, freqs, "wpli", eps)

    def ppc(self, ch_a: str, ch_b: str, freqs: Numbers,
            eps: float = 0.0) -> jnp.ndarray:
        """(F, N) pairwise phase consistency between two channels across
        epochs (extension — ``ops.connectivity.ppc``): the bias-free
        counterpart of ``plv``-squared, comparable across different epoch
        counts.  Needs at least 2 epochs."""
        from ..ops.connectivity import ppc as _ppc
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        br, _ = self._conn_bank(sa.shape[-1], freqs)
        return _ppc(sa, sb, br, interpolate=self.wavelet.interpolate,
                    eps=eps)

    def imcoh(self, ch_a: str, ch_b: str, freqs: Numbers,
              eps: float = 1e-12) -> jnp.ndarray:
        """(F, N) imaginary coherency between two channels across epochs
        (extension — ``ops.extensions.imcoh``): the signed,
        amplitude-weighted volume-conduction-robust companion of
        ``coherence``."""
        from ..ops.extensions import imcoh as _imcoh
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        br, bi = self._conn_bank(sa.shape[-1], freqs, need_phase=False)
        return _imcoh(sa, sb, br, bi,
                      interpolate=self.wavelet.interpolate, eps=eps)

    def psi(self, ch_a: str, ch_b: str, freqs: Numbers,
            band=None, eps: float = 1e-12) -> jnp.ndarray:
        """(N,) time-resolved phase slope index between two channels
        (extension — ``ops.extensions.psi``): DIRECTED coupling, positive
        where ``ch_a`` leads ``ch_b``.  ``freqs`` must ascend; ``band``
        optionally restricts the slope to a (lo, hi) row-index slice."""
        from ..ops.extensions import psi as _psi
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        arr = np.asarray(freqs, np.float64)
        if arr.size < 2 or np.any(np.diff(arr) <= 0):
            raise ValueError("psi needs >= 2 strictly ascending freqs")
        br, bi = self._conn_bank(sa.shape[-1], freqs, need_phase=False)
        return _psi(sa, sb, br, bi, band=band,
                    interpolate=self.wavelet.interpolate, eps=eps)

    def wpli_matrix(self, freqs: Numbers, method: str = "wpli",
                    time_range=None, eps: float = 0.0) -> jnp.ndarray:
        """(F, C, C) all-pairs phase-lag matrix over every channel,
        time-averaged (extension — ``ops.connectivity.wpli_matrix``;
        ``method`` picks pli/wpli/dwpli).  The diagonal is NaN at
        ``eps = 0`` by convention (a channel has no lag against
        itself)."""
        from ..ops.connectivity import wpli_matrix as _wpli_m
        waves = self._all_data()
        br, _ = self._conn_bank(waves.shape[-1], freqs)
        return _wpli_m(waves, br, method=method,
                       interpolate=self.wavelet.interpolate,
                       eps=eps, time_range=self._samples(time_range))

    def ppc_matrix(self, freqs: Numbers, time_range=None,
                   eps: float = 0.0) -> jnp.ndarray:
        """(F, C, C) all-pairs pairwise-phase-consistency matrix,
        time-averaged (extension — ``ops.connectivity.ppc_matrix``)."""
        from ..ops.connectivity import ppc_matrix as _ppc_m
        waves = self._all_data()
        br, _ = self._conn_bank(waves.shape[-1], freqs)
        return _ppc_m(waves, br, interpolate=self.wavelet.interpolate,
                      eps=eps, time_range=self._samples(time_range))

    def plv_matrix(self, freqs: Numbers, time_range=None,
                   eps: float = 0.0) -> jnp.ndarray:
        """(F, C, C) all-pairs phase-locking matrix over every channel,
        time-averaged (extension — ``ops.connectivity.plv_matrix``).
        ``time_range=(start_s, stop_s)`` windows the average in SECONDS
        (converted to samples here, mne-style)."""
        from ..ops.connectivity import plv_matrix as _plv_m
        waves = self._all_data()
        br, _ = self._conn_bank(waves.shape[-1], freqs)
        return _plv_m(waves, br, interpolate=self.wavelet.interpolate,
                      eps=eps, time_range=self._samples(time_range))

    def coherence_matrix(self, freqs: Numbers, time_range=None,
                         eps: float = 1e-12) -> jnp.ndarray:
        """(F, C, C) all-pairs epoch-wise coherence matrix, time-averaged
        (extension — ``ops.connectivity.coherence_matrix``)."""
        from ..ops.connectivity import coherence_matrix as _coh_m
        waves = self._all_data()
        br, bi = self._conn_bank(waves.shape[-1], freqs, need_phase=False)
        return _coh_m(waves, br, bi, interpolate=self.wavelet.interpolate,
                      eps=eps, time_range=self._samples(time_range))

    def multitaper_coherence_matrix(self, freqs: Numbers,
                                    n_tapers: int = 3,
                                    time_range=None) -> jnp.ndarray:
        """(F, C, C) all-pairs MULTITAPER coherence (extension —
        ``ops.multitaper.multitaper_coherence_matrix``): the K Morse
        tapers fold into the epoch axis, so low trial counts (even a
        single epoch) still yield a stable estimate."""
        from ..ops.multitaper import multitaper_coherence_matrix as _m
        waves = self._all_data()
        return _m(waves, np.asarray(list(freqs), np.float64),
                  self.wavelet.sfreq, n_tapers=n_tapers,
                  interpolate=self.wavelet.interpolate,
                  time_range=self._samples(time_range))

    def multitaper_partial_coherence(self, freqs: Numbers,
                                     n_tapers: int = 3,
                                     lam: float = 1e-5,
                                     time_range=None) -> jnp.ndarray:
        """(F, C, C) multitaper PARTIAL coherence (extension —
        ``ops.multitaper.multitaper_partial_coherence``): the
        conditioning inverse runs on taper-augmented cross-spectra, so
        it stays well-posed at trial counts where
        :meth:`partial_coherence` is rank-starved."""
        from ..ops.multitaper import multitaper_partial_coherence as _m
        waves = self._all_data()
        return _m(waves, np.asarray(list(freqs), np.float64),
                  self.wavelet.sfreq, n_tapers=n_tapers, lam=lam,
                  interpolate=self.wavelet.interpolate,
                  time_range=self._samples(time_range))

    def kuramoto_order(self, freqs: Numbers,
                       mean_epochs: bool = True) -> jnp.ndarray:
        """(F, N) global phase-synchrony time course across ALL
        channels (extension — ``ops.connectivity.kuramoto_order``):
        the Kuramoto order parameter R, 1 = whole-head phase lock,
        ~1/sqrt(C) under independence.  ``mean_epochs=False`` keeps the
        (E, F, N) per-trial courses."""
        from ..ops.connectivity import kuramoto_order as _ko
        waves = self._all_data()
        br, _ = self._conn_bank(waves.shape[-1], freqs)
        return _ko(waves, br, interpolate=self.wavelet.interpolate,
                   mean_epochs=mean_epochs)

    def partial_coherence(self, freqs: Numbers, time_range=None,
                          lam: float = 1e-5) -> jnp.ndarray:
        """(F, C, C) all-pairs PARTIAL coherence — each pair conditioned
        on every other channel via the inverse cross-spectral matrix
        (extension — ``ops.connectivity.partial_coherence``): purely
        mediated coupling that :meth:`coherence_matrix` reports drops
        to ~0 here."""
        from ..ops.connectivity import partial_coherence as _pcoh
        waves = self._all_data()
        br, _ = self._conn_bank(waves.shape[-1], freqs)
        return _pcoh(waves, br, interpolate=self.wavelet.interpolate,
                     lam=lam, time_range=self._samples(time_range))

    def psi_matrix(self, freqs: Numbers, time_range=None,
                   normalize: bool = True) -> jnp.ndarray:
        """(C, C) phase-slope index over every channel pair (extension —
        ``ops.connectivity.psi_matrix``, Nolte 2008; the all-pairs
        jackknife-normalized form of :meth:`psi`): positive ``[a, b]`` means
        channel ``a`` temporally leads ``b`` across the band spanned by
        ``freqs`` (sorted ascending here — adjacent frequencies form the
        slope).  ``normalize=True`` divides by the jackknife standard
        error (z-like; |PSI| > 2 is the conventional threshold)."""
        from ..ops.connectivity import psi_matrix as _psi_m
        waves = self._all_data()
        freqs = np.sort(np.asarray(list(freqs), np.float64))
        br, _ = self._conn_bank(waves.shape[-1], freqs)
        return _psi_m(waves, br, interpolate=self.wavelet.interpolate,
                      time_range=self._samples(time_range),
                      normalize=normalize)

    def network(self, freqs: Numbers, method: str = "wpli",
                time_range=None, n_nulls: int = 0) -> dict:
        """Graph-theoretic summary of the all-pairs connectivity at each
        frequency (extension — ``ops.graph`` over the ``*_matrix``
        estimators): dict with the (F, C, C) ``matrix`` plus per-node
        ``strength`` (F, C), ``clustering`` (F, C), and per-frequency
        ``efficiency`` / ``path_length`` (F,), and Newman
        leading-eigenvector ``communities`` (F, C) with per-frequency
        ``modularity`` (F,); ``n_nulls > 0`` adds ``small_world``
        sigma against weight-shuffled nulls.  ``method`` also accepts
        ``"pcoh"`` (partial coherence)."""
        from ..ops import graph as _g
        fn = {"wpli": self.wpli_matrix, "plv": self.plv_matrix,
              "coherence": self.coherence_matrix,
              "ppc": self.ppc_matrix,
              "pcoh": self.partial_coherence}.get(method)
        if fn is None:
            raise ValueError("method must be one of wpli/plv/coherence/"
                             "ppc/pcoh, got %r" % (method,))
        m = fn(freqs, time_range=time_range)
        labels, q = _g.modularity_communities(m)     # batched over F
        out = {"matrix": m,
               "strength": _g.strength(m),
               "clustering": _g.clustering_onnela(m),
               "efficiency": _g.global_efficiency(m),
               "path_length": _g.char_path_length(m),
               "communities": np.asarray(labels),
               "modularity": np.asarray(q)}
        if n_nulls:
            out["small_world"] = _g.small_worldness(m, n_nulls=n_nulls)
        return out

    def nm_plv(self, ch_a: str, ch_b: str, freqs: Numbers, n: int = 1,
               m: int = 1, eps: float = 0.0) -> jnp.ndarray:
        """(F, N) n:m cross-frequency phase-locking between two channels
        (extension — ``ops.connectivity.nm_plv``): row k tests the lock of
        ``n * phase(ch_a at freqs[k])`` against
        ``m * phase(ch_b at (n/m) * freqs[k])`` (so each pair satisfies
        the ``n f_a = m f_b`` resonance).  ``ch_a == ch_b`` measures
        harmonic self-locking."""
        from ..ops.connectivity import nm_plv as _nm
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        ba, _ = self._conn_bank(sa.shape[-1], freqs)
        scaled = np.asarray(freqs, np.float64) * (float(n) / float(m))
        bb, _ = self._conn_bank(sa.shape[-1], scaled)
        return _nm(sa, sb, ba, bb, n=n, m=m,
                   interpolate=self.wavelet.interpolate, eps=eps)

    def plv_significance(self, ch_a: str, ch_b: str, freqs: Numbers,
                         n_surrogates: int = 199, seed: int = 0,
                         eps: float = 0.0):
        """((F, N) plv, (F, N) p-values) with circular-shift surrogate
        significance (extension — ``ops.connectivity.plv_significance``;
        cost is ``n_surrogates + 1`` PLV passes)."""
        from ..ops.connectivity import plv_significance as _sig
        sa = self._channel_data(ch_a)
        sb = self._channel_data(ch_b)
        br, _ = self._conn_bank(sa.shape[-1], freqs)
        return _sig(sa, sb, br, interpolate=self.wavelet.interpolate,
                    eps=eps, n_surrogates=n_surrogates, seed=seed)

    def pac(self, ch_name: str, freqs_phase: Numbers, freqs_amp: Numbers,
            method: str = "mvl", n_bins: int = 18, ch_amp=None,
            significance: int = 0, seed: int = 0):
        """(F_phase, F_amp) epoch-mean phase-amplitude comodulogram
        (extension — ``ops.connectivity.pac``).  ``ch_amp`` takes the
        amplitude from a DIFFERENT channel (cross-channel PAC);
        ``significance=S`` also returns circular-shift surrogate
        p-values (same-channel only): ``(pac, p)``."""
        cross = ch_amp is not None and ch_amp != ch_name
        if significance and cross:
            # validate BEFORE fetching data / building banks
            raise ValueError("significance is same-channel only "
                             "(the surrogate rolls the amplitude "
                             "copy of the SAME signal)")
        waves = self._channel_data(ch_name)
        bp, _ = self._conn_bank(waves.shape[-1], freqs_phase)
        ba, _ = self._conn_bank(waves.shape[-1], freqs_amp)
        interp = self.wavelet.interpolate
        if significance:
            from ..ops.connectivity import pac_significance
            return pac_significance(waves, bp, ba, interpolate=interp,
                                    method=method, n_bins=n_bins,
                                    n_surrogates=int(significance),
                                    seed=seed)
        if cross:
            from ..ops.connectivity import pac_pair
            amp_waves = self._channel_data(ch_amp)
            return pac_pair(waves, amp_waves, bp, ba,
                            interpolate=interp, method=method,
                            n_bins=n_bins)
        from ..ops.connectivity import pac as _pac
        return _pac(waves, bp, ba, interpolate=interp,
                    method=method, n_bins=n_bins, mean_epochs=True)

    def decode(self, other, freqs: Numbers, n_folds: int = 5,
               lam: float = 1e-3, log_power: bool = True,
               baseline=None, baseline_method: str = "zscore",
               decim: int = 1) -> jnp.ndarray:
        """(F, N) cross-validated decoding AUC between this epochs
        object's trials and ``other``'s, from the all-channel power
        pattern at every TF pixel (extension — ``ops.decoding``; the
        MNE SlidingEstimator analog).  ``log_power`` applies log1p to
        tame heavy-tailed power before the diagonal-LDA fit."""
        from ..ops.decoding import tf_decode
        # log BEFORE baseline correction: zscore/percent-corrected power
        # goes below -1, where log1p is NaN and would zero the AUC map
        xa = self.single_trial_power_all(freqs, None, decim=decim)
        xb = other.single_trial_power_all(freqs, None, decim=decim)
        if log_power:
            xa = jnp.log1p(xa)
            xb = jnp.log1p(xb)
        if baseline is not None:
            from ..ops.baseline import baseline_tf
            sf = self.wavelet.sfreq / max(int(decim), 1)
            xa = baseline_tf(xa, sf, baseline[0], baseline[1],
                             baseline_method)
            xb = baseline_tf(xb, sf, baseline[0], baseline[1],
                             baseline_method)
        return tf_decode(xa, xb, n_folds=n_folds, lam=lam)

    def decode_generalization(self, other, freqs: Numbers,
                              n_folds: int = 5, lam: float = 1e-3,
                              decim: int = 4,
                              log_power: bool = True) -> jnp.ndarray:
        """(T, T) temporal generalization matrix (King & Dehaene) from
        the band-mean power per channel: decoders trained at each
        (decimated) time tested at every other — diagonal = sequential
        code, square block = sustained code."""
        from ..ops.decoding import temporal_generalization
        xa = self.single_trial_power_all(freqs, decim=decim).mean(-2)
        xb = other.single_trial_power_all(freqs, decim=decim).mean(-2)
        if log_power:
            xa, xb = jnp.log1p(xa), jnp.log1p(xb)
        return temporal_generalization(xa, xb, n_folds=n_folds, lam=lam)

    def specparam(self, ch_name: str, freqs: Numbers,
                  max_peaks: int = 4, fit_knee: bool = False, **kw):
        """FOOOF-style spectral fit of the channel's time-averaged
        epoch-mean wavelet power (extension — ``ops.specparam``):
        aperiodic offset/knee/exponent + oscillatory peaks."""
        from ..ops.specparam import specparam as _fit
        power = np.asarray(self.power(ch_name, freqs)).mean(-1)
        return _fit(power, np.asarray(freqs, np.float64),
                    max_peaks=max_peaks, fit_knee=fit_knee, **kw)

    def psd(self, picks=None, nperseg: int = 1024, band=None,
            average: bool = True):
        """``(freqs, psd)`` — Welch power spectral density (extension —
        ``ops.irasa.welch_psd``; Hamming window, 50% overlap, density
        scaling, scipy-oracled).  ``psd`` is the (C, F) epoch mean
        (``average=True``) or per-epoch (E, C, F); ``band=(lo, hi)`` Hz
        crops the frequency axis.  The segment length is clamped to the
        largest power of two that fits the epoch (the FFT's fastest
        length)."""
        return _welch_of(self._host_data(), self.epochs.ch_names,
                         self.wavelet.sfreq, picks, nperseg, band,
                         epoch_mean=average)

    def wavelet_entropy(self, ch_name: str, freqs: Numbers,
                        normalized: bool = True) -> jnp.ndarray:
        """(N,) time-resolved wavelet entropy of the channel's
        epoch-mean power (extension — ``ops.wavelet_entropy``, Rosso):
        how evenly the energy spreads across the analysis bands."""
        from ..ops.extensions import wavelet_entropy
        return wavelet_entropy(self.power(ch_name, freqs), normalized)

    def evoked(self) -> jnp.ndarray:
        """(C, N) trial-average (ERP) waveform of every channel
        (extension — ``ops.erp.evoked``); the time-domain counterpart
        of :meth:`evoked_power`."""
        from ..ops.erp import evoked
        return evoked(self._all_data())

    def fit_dipole(self, elec_pos, **kw) -> dict:
        """Equivalent-current-dipole model of the evoked response
        (extension — ``ops.fit_dipole_evoked`` on :meth:`evoked`,
        mne's ``fit_dipole``): position fitted at the peak-GFP sample
        of the trial average, moment time course in closed form.
        ``elec_pos`` is (C, 3) electrode coordinates in this adapter's
        channel order; ``radius=`` / ``n_terms=`` / ``spacing=`` pass
        through."""
        from ..ops.leadfield import fit_dipole_evoked
        ev = np.asarray(self.evoked())
        if np.asarray(elec_pos).shape != (ev.shape[0], 3):
            raise ValueError("elec_pos must be (C, 3) matching "
                             "ch_names")
        return fit_dipole_evoked(ev, elec_pos, **kw)

    def _event_window(self, window):
        """(start_s, stop_s) EVENT-relative seconds -> sample window.
        Honors the epochs' time axis when the object carries one (mne
        epochs start at tmin, usually negative — a (0.25, 0.35) window
        must NOT mean samples 62..88 of a tmin=-0.2 epoch); falls back
        to epoch-start-relative seconds otherwise."""
        if window is None:
            return None
        times = getattr(self.epochs, "times", None)
        if times is not None:
            t = np.asarray(times, np.float64)
            lo = int(np.searchsorted(t, float(window[0]), side="left"))
            hi = int(np.searchsorted(t, float(window[1]), side="right"))
            return (lo, hi)
        return self._samples(window)

    def erp_peak(self, window=None, polarity: int = 1):
        """Windowed ERP peak of every channel's evoked waveform
        (extension — ``ops.erp.peak_measures``): a ``PeakResult`` of
        (C,) latencies and amplitudes.  ``window`` is a (start_s,
        stop_s) SECONDS pair relative to the EVENT when the epochs
        carry a ``times`` axis (mne-style tmin honored), else relative
        to the epoch start.  Latencies are SAMPLES from the epoch
        start — map to event time via ``epochs.times[latency]``.
        ``polarity`` +1/-1 for positive/negative components."""
        from ..ops.erp import evoked, peak_measures
        return peak_measures(evoked(self._all_data()),
                             self._event_window(window), polarity)

    def erp_onset(self, window, criterion: float = 0.5,
                  polarity: int = 1):
        """Jackknife component-onset latency per channel (extension —
        ``ops.erp.jackknife_onsets``, Miller-Ulrich): returns
        ``(onsets, mean, se)`` with the corrected standard error.
        Latencies in SAMPLES from the epoch start; ``window`` in
        SECONDS, event-relative when the epochs carry ``times`` (see
        :meth:`erp_peak`)."""
        from ..ops.erp import jackknife_onsets
        return jackknife_onsets(self._all_data(),
                                self._event_window(window), criterion,
                                polarity)

    def ssvep(self, stim_freqs, n_harmonics: int = 3):
        """CCA-based SSVEP frequency recognition per trial (extension —
        ``ops.decoding.ssvep_cca``, Lin 2006): returns ``(labels (E,)
        indices into stim_freqs, rho (E, F) canonical correlations)``
        — the standard BCI-speller decoder."""
        from ..ops.decoding import ssvep_cca
        return ssvep_cca(self._all_data(), list(stim_freqs),
                         self.wavelet.sfreq, n_harmonics=n_harmonics)

    def riemann_decode(self, other: "EpochsWavelet",
                       method: str = "tangent", n_folds: int = 5,
                       shrink: float = 0.05, **kw) -> float:
        """Cross-validated Riemannian covariance decoding between this
        adapter's trials and ``other``'s (extension — ``ops.riemann``,
        the pyRiemann workflow): ``method="tangent"`` (tangent-space
        LDA, returns AUC) or ``"mdm"`` (minimum distance to the
        Karcher mean, returns accuracy).  The geometry-respecting
        alternative to :meth:`csp_decode`."""
        from ..ops.riemann import mdm_decode, tangent_decode
        fn = {"tangent": tangent_decode, "mdm": mdm_decode}.get(method)
        if fn is None:
            raise ValueError("method must be 'tangent' or 'mdm'")
        return fn(self._all_data(), other._all_data(),
                  n_folds=n_folds, shrink=shrink, **kw)

    def sample_entropy(self, m: int = 2, r: float = 0.2) -> jnp.ndarray:
        """(E, C) sample entropy of every epoch and channel (extension —
        ``ops.complexity.sample_entropy``, Richman-Moorman; tolerance
        ``r * std`` per trace).  Higher = less regular."""
        from ..ops.complexity import sample_entropy
        return sample_entropy(self._all_data(), m=m, r=r)

    def permutation_entropy(self, m: int = 3, tau: int = 1,
                            normalized: bool = True) -> jnp.ndarray:
        """(E, C) permutation entropy of every epoch and channel
        (extension — ``ops.complexity.permutation_entropy``,
        Bandt-Pompe; normalized to [0, 1] by default)."""
        from ..ops.complexity import permutation_entropy
        return permutation_entropy(self._all_data(), m=m, tau=tau,
                                   normalized=normalized)

    def multiscale_entropy(self, m: int = 2, r: float = 0.2,
                           scales=10) -> jnp.ndarray:
        """(E, C, S) multiscale-entropy profile of every epoch and
        channel (extension — ``ops.complexity.multiscale_entropy``,
        Costa 2002; tolerance fixed from the scale-1 std)."""
        from ..ops.complexity import multiscale_entropy
        return multiscale_entropy(self._all_data(), m=m, r=r,
                                  scales=scales)

    def cycles(self, ch_name: str, f_range, **kw):
        """Cycle-by-cycle waveform features of one channel (extension —
        ``ops.cycles``, the bycycle method of Cole & Voytek 2019): a
        ``CycleTable`` of per-epoch padded (E, K) shape features
        (period, rise-decay / peak-trough asymmetry, amplitude,
        monotonicity) plus burst flags.  ``f_range=(f_lo, f_hi)`` sets
        the segmentation band; thresholds pass through to
        ``ops.cycles.cycle_features``."""
        from ..ops.cycles import cycle_features
        return cycle_features(self._channel_data(ch_name),
                              self.wavelet.sfreq, f_range, **kw)

    def cp_power(self, freqs: Numbers, rank: int, tensor: str = "cfn",
                 ch_name: Optional[str] = None,
                 nonneg: Optional[bool] = None,
                 n_iter: int = 100, seed: int = 0, baseline=None,
                 baseline_method: str = "zscore", decim: int = 1):
        """Rank-R PARAFAC model of a power tensor (extension —
        ``ops.cpd``, the ERPWAVELAB multiway workflow): each component
        is an outer product of mode signatures.  ``tensor`` picks the
        modes: ``"cfn"`` (channel x freq x time of the epoch-mean
        power — spatial/spectral/temporal signatures), ``"efn"`` (epoch
        x freq x time of ONE channel, ``ch_name`` required — trial
        loadings), or ``"ecfn"`` (4-way single-trial).  Returns
        ``(weights, factors, fit)`` with unit-norm factor columns;
        ``nonneg`` defaults True for raw power (nonnegative by
        construction) and False when a ``baseline`` correction is
        applied (zscore/logratio tensors are signed — HALS would
        silently clamp half the data); passing ``nonneg=True`` together
        with a baseline raises."""
        from ..ops.cpd import cp_decompose
        if nonneg is None:
            nonneg = baseline is None
        elif nonneg and baseline is not None:
            raise ValueError(
                "nonneg=True with a baseline correction: baselined "
                "power is signed and HALS would clamp the negative "
                "half; pass nonneg=False (or drop the baseline)")
        if tensor == "cfn":
            x = self.power_all(freqs, baseline, baseline_method, decim)
        elif tensor == "efn":
            if ch_name is None:
                raise ValueError("tensor='efn' needs ch_name")
            x = self.single_trial_power(ch_name, freqs, baseline,
                                        baseline_method, decim)
        elif tensor == "ecfn":
            x = self.single_trial_power_all(freqs, baseline,
                                            baseline_method, decim)
        else:
            raise ValueError("tensor must be 'cfn', 'efn' or 'ecfn'")
        return cp_decompose(x, rank, n_iter=n_iter, nonneg=nonneg,
                            seed=seed)

    def bursts(self, ch_name: str, freqs: Numbers, factor: float = 6.0,
               min_area: int = 1, threshold=None, table: bool = False):
        """Oscillatory burst statistics of one channel's single-trial
        power (extension — ``ops.bursts``, Shin et al. 2017): per-epoch
        ``BurstSummary`` (count/rate/duration/span/peak), or the host
        burst listing with ``table=True``.  ``freqs`` must be uniformly
        spaced (the span unit is its step)."""
        from ..ops.bursts import burst_summary, burst_table
        freqs = np.asarray(freqs, np.float32)
        step = float(freqs[1] - freqs[0]) if freqs.size > 1 else 1.0
        if freqs.size > 2 and not np.allclose(np.diff(freqs), step,
                                              rtol=1e-5):
            raise ValueError(
                "bursts needs a uniformly spaced freqs grid (the Hz "
                "span unit is its step); got non-uniform spacing")
        trials = self.single_trial_power(ch_name, freqs)
        if table:
            return burst_table(np.asarray(trials), threshold,
                               self.wavelet.sfreq, freqs, factor,
                               min_area)
        return burst_summary(trials, threshold, self.wavelet.sfreq,
                             step, factor, min_area)

    def matching_pursuit(self, ch_name: str, n_atoms: int = 20,
                         scales_s=None, freqs=None):
        """Per-epoch greedy Gabor decomposition of one channel
        (extension — ``ops.mp``, Mallat & Zhang 1993; Durka's EEG MP):
        an ``MPResult`` whose fields are (E, n_atoms) — amplitude,
        phase, scale [s], center time [s], carrier [Hz], energy — plus
        the (E, N) residuals.  The spindle workflow: threshold
        ``freq_hz``/``scale_s``/``amplitude`` per atom instead of
        eyeballing a TFR; render with ``ops.mp_tfr``."""
        from ..ops.mp import matching_pursuit as _mp
        waves = self._channel_data(ch_name)
        return _mp(waves, n_atoms, self.wavelet.sfreq,
                   scales_s=scales_s, freqs=freqs)

    def modwt_var(self, ch_name: str, wavelet: str = "db4",
                  level=None, mean: bool = True) -> jnp.ndarray:
        """Wavelet variance by octave scale of one channel (extension —
        ``ops.dwt.modwt_var``): per-epoch MODWT variance, averaged over
        epochs (``mean=True``, the (J,) event-locked analog of
        ``RawWavelet.modwt_var``) or per epoch ((E, J), for
        across-epoch statistics).  Epoch lengths are reflect-padded to
        a power of two on device (the FFT's fastest length)."""
        from ..ops.dwt import modwt_var as _var
        from ..ops.dwt import pow2_pad
        waves = self._channel_data(ch_name)
        padded, _ = pow2_pad(waves)
        out = _var(padded, wavelet, level)
        return jnp.mean(out, axis=0) if mean else out

    def modwt_denoise(self, wavelet: str = "db4", level=None,
                      mode: str = "soft") -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` over MODWT-shrinkage-denoised copies
        of every epoch/channel (extension — ``ops.dwt.modwt_denoise``,
        level-dependent universal thresholding), so any downstream
        transform (``power``/``itc``/connectivity/...) runs on the
        cleaned trials.  Composable: the returned adapter carries the
        same channel names, sfreq, and wavelet object."""
        from ..ops.dwt import modwt_denoise as _denoise
        data = self._host_data()                    # (E, C, N)
        den = np.asarray(_denoise(data.reshape(-1, data.shape[-1]),
                                  wavelet, level, mode,
                                  pad_pow2=True)).reshape(data.shape)
        times = getattr(self.epochs, "times", None)
        return self._carry_codes(EpochsWavelet(
            ArrayEpochs(den, self.wavelet.sfreq,
                        list(self.epochs.ch_names), times=times),
            self.wavelet))

    def _carry_codes(self, out: "EpochsWavelet", sel=None
                     ) -> "EpochsWavelet":
        """Propagate ``event_codes`` onto a rebuilt adapter (``sel``
        filters trials; None = all trials kept) — every composable
        transform that returns a new ``EpochsWavelet`` calls this so
        ``split()`` keeps working down the chain."""
        codes = getattr(self, "event_codes", None)
        if codes is not None:
            codes = np.asarray(codes)
            out.event_codes = codes if sel is None else codes[sel]
        return out

    def subset(self, sel) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` over a trial subset (extension):
        ``sel`` is a boolean mask or integer indices over epochs.
        Composable like :meth:`drop_bad` — the standard way to carve
        condition groups for :meth:`cluster_test`, :meth:`csp_decode`,
        :meth:`riemann_decode`, ..."""
        # host cache, NOT the device copy — np.asarray(_all_data())
        # would re-fetch the whole block from the device
        data = self._host_data()
        sel = np.asarray(sel)
        sub = data[sel]
        if sub.ndim != 3 or sub.shape[0] == 0:
            raise ValueError("selection keeps no trials")
        times = getattr(self.epochs, "times", None)
        out = EpochsWavelet(
            ArrayEpochs(sub, self.wavelet.sfreq,
                        list(self.epochs.ch_names), times=times),
            self.wavelet)
        return self._carry_codes(out, sel)

    def split(self, labels=None) -> dict:
        """Partition trials by a per-epoch label array (extension):
        ``{label: EpochsWavelet}`` — e.g.
        ``groups = ew.split(events[:, 2])`` then
        ``groups[1].csp_decode(groups[2])``.  With no argument, uses the
        ``event_codes`` carried over from ``RawWavelet.epochs`` when the
        events had an mne-style id column."""
        if labels is None:
            labels = getattr(self, "event_codes", None)
            if labels is None:
                raise ValueError(
                    "no labels given and this adapter carries no "
                    "event_codes — pass (E,) labels, or build the "
                    "epochs from (E, 3) mne-style events")
        labels = np.asarray(labels)
        # count epochs off the data, not len(epochs) — duck-typed
        # containers need only the get_data() surface
        if labels.shape[0] != self._host_data().shape[0]:
            raise ValueError("labels must have one entry per epoch")
        return {lab: self.subset(labels == lab)
                for lab in np.unique(labels)}

    def regress_out(self, ref_names) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` with the listed reference channels
        (EOG/ECG) regressed out of every other channel per epoch
        (extension — ``ops.reject.regress_out``, the Gratton-Coles
        correction) and the references themselves dropped.  Composable
        like :meth:`drop_bad`."""
        from ..ops.reject import regress_out as _ro
        names = list(self.epochs.ch_names)
        ref_idx = []
        for ch in ref_names:
            if ch not in names:
                raise ValueError(f"channel {ch!r} not in ch_names")
            ref_idx.append(names.index(ch))
        keep_idx = [i for i in range(len(names)) if i not in ref_idx]
        if not keep_idx:
            raise ValueError("no data channels left after removing refs")
        data = self._host_data()                    # (E, C, N)
        cleaned = np.asarray(_ro(data[:, keep_idx], data[:, ref_idx]))
        times = getattr(self.epochs, "times", None)
        return self._carry_codes(EpochsWavelet(
            ArrayEpochs(cleaned, self.wavelet.sfreq,
                        [names[i] for i in keep_idx], times=times),
            self.wavelet))

    def drop_bad(self, threshold: Optional[float] = None,
                 **kw) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` with bad trials dropped (extension —
        ``ops.reject``): trials whose worst-channel peak-to-peak
        exceeds ``threshold`` are removed.  With ``threshold=None`` the
        threshold is chosen by cross-validation
        (``ops.reject.autoreject_global``, Jas 2017; ``n_folds=`` /
        ``n_candidates=`` / ``seed=`` pass through), and the result is
        attached as ``.reject_result`` on the returned adapter.
        Composable like :meth:`modwt_denoise`; raises if every trial
        would be dropped."""
        from ..ops import reject as _rej
        data = self._host_data()                     # (E, C, N), cached
        res = None
        if threshold is None:
            res = _rej.autoreject_global(data, **kw)
            mask = np.asarray(res.drop_mask)
        else:
            mask = np.asarray(_rej.ptp_reject(data, float(threshold)))
        if mask.all():
            raise ValueError("drop_bad would reject every trial — "
                             "threshold too low for this data")
        times = getattr(self.epochs, "times", None)
        out = EpochsWavelet(
            ArrayEpochs(data[~mask], self.wavelet.sfreq,
                        list(self.epochs.ch_names), times=times),
            self.wavelet)
        out.reject_result = res
        return self._carry_codes(out, ~mask)

    def csd(self, positions, **kw) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` over the current-source-density
        transform of every trial (extension — ``ops.csd``, Perrin 1989
        spherical splines): reference-free, volume-conduction-
        suppressed topographies, the standard step before connectivity.
        ``positions`` is (C, 3) electrode coordinates in this adapter's
        channel order; ``stiffness=`` / ``lam=`` / ``head_radius=``
        pass through.  Composable like :meth:`drop_bad`."""
        from ..ops.csd import csd as _csd
        data = self._host_data()                    # (E, C, N)
        if np.asarray(positions).shape[0] != data.shape[1]:
            raise ValueError("positions must match the channel count")
        out = np.asarray(_csd(data, positions, **kw))
        times = getattr(self.epochs, "times", None)
        return self._carry_codes(EpochsWavelet(
            ArrayEpochs(out, self.wavelet.sfreq,
                        list(self.epochs.ch_names), times=times),
            self.wavelet))

    def interpolate_bads(self, positions, bads, **kw) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` with the listed channels replaced by
        spherical-spline interpolations from the good ones (extension —
        ``ops.csd.interpolate_channels``; mne's ``interpolate_bads``).
        ``bads`` is a list of channel NAMES; ``positions`` is (C, 3) in
        this adapter's channel order."""
        from ..ops.csd import interpolate_channels
        names = list(self.epochs.ch_names)
        idx = []
        for ch in bads:
            if ch not in names:
                raise ValueError(f"channel {ch!r} not in ch_names")
            idx.append(names.index(ch))
        data = self._host_data()
        out = np.asarray(interpolate_channels(data, positions, idx, **kw))
        times = getattr(self.epochs, "times", None)
        return self._carry_codes(EpochsWavelet(
            ArrayEpochs(out, self.wavelet.sfreq, names, times=times),
            self.wavelet))

    def lagged_coherence(self, ch_name: str, freqs: Numbers,
                         n_cycles: float = 3.0, lag=None) -> jnp.ndarray:
        """(F,) rhythmicity of one channel (extension —
        ``ops.connectivity.lagged_coherence_morse``, after Fransen et
        al. 2015): wavelet coefficients sampled ``lag`` windows apart,
        pair sums POOLED over epochs.  ~1 for sustained rhythms, low
        for noise or one-off transients.  Delegates to the public
        ops-level entry so the too-short-signal validation and the
        beta/gamma derivation live in exactly one place."""
        from ..ops.connectivity import lagged_coherence_morse
        waves = self._channel_data(ch_name)
        return lagged_coherence_morse(waves, freqs, self.wavelet.sfreq,
                                      n_cycles=n_cycles, lag=lag,
                                      pooled=True)

    # -- spatial filtering (extension — ops.spatial) -----------------------

    def csp(self, labels, n_components: int = 4,
            f_lo: Optional[float] = None, f_hi: Optional[float] = None,
            shrink: float = 0.01):
        """Common spatial patterns over all channels (extension —
        ``ops.spatial.csp``): ``labels`` is a length-E two-class vector
        (class A = the smaller label).  Returns a ``SpatialResult``;
        feed it to :meth:`spatial_epochs` to analyze component time
        series, or ``ops.spatial.csp_features`` for decoding."""
        from ..ops import spatial as _sp
        data = self._all_data()
        y = np.asarray(labels)
        if y.shape != (data.shape[0],):
            raise ValueError("labels must be one value per epoch")
        classes = np.unique(y)
        if classes.size != 2:
            raise ValueError(f"need exactly 2 classes, got {classes}")
        return _sp.csp(data[y == classes[0]], data[y == classes[1]],
                       n_components=n_components, f_lo=f_lo, f_hi=f_hi,
                       sfreq=self.wavelet.sfreq, shrink=shrink)

    def csp_decode(self, labels, n_folds: int = 5,
                   n_components: int = 4,
                   f_lo: Optional[float] = None,
                   f_hi: Optional[float] = None, **kw):
        """Scalar cross-validated CSP+LDA decoding AUC between the two
        classes in ``labels`` (extension — ``ops.decoding.csp_decode``;
        the classic motor-imagery pipeline)."""
        from ..ops.decoding import csp_decode as _cd
        data = self._all_data()
        y = np.asarray(labels)
        if y.shape != (data.shape[0],):
            raise ValueError("labels must be one value per epoch")
        classes = np.unique(y)
        if classes.size != 2:
            raise ValueError(f"need exactly 2 classes, got {classes}")
        return _cd(data[y == classes[0]], data[y == classes[1]],
                   n_folds=n_folds, n_components=n_components,
                   f_lo=f_lo, f_hi=f_hi, sfreq=self.wavelet.sfreq, **kw)

    def ged(self, f_lo: float, f_hi: float,
            n_components: Optional[int] = None, shrink: float = 0.01):
        """Narrowband-vs-broadband GED over all channels (extension —
        ``ops.spatial.ged``, Cohen 2022): components maximize
        [f_lo, f_hi] power relative to the raw recording."""
        from ..ops import filtering as _ft
        from ..ops import spatial as _sp
        data = self._all_data()
        xs = _ft.bandpass(data, self.wavelet.sfreq, f_lo, f_hi)
        return _sp.ged(_sp.covariance(xs), _sp.covariance(data),
                       n_components=n_components, shrink=shrink)

    def ssd(self, f_lo: float, f_hi: float,
            n_components: Optional[int] = None, flank: float = 2.0,
            gap: float = 1.0, shrink: float = 0.01):
        """Spatio-spectral decomposition over all channels (extension —
        ``ops.spatial.ssd``, Nikulin 2011): band power against its
        flanking noise bands."""
        from ..ops import spatial as _sp
        return _sp.ssd(self._all_data(), self.wavelet.sfreq, f_lo, f_hi,
                       n_components=n_components, flank=flank, gap=gap,
                       shrink=shrink)

    def spatial_epochs(self, result,
                       n_components: Optional[int] = None
                       ) -> "EpochsWavelet":
        """A NEW ``EpochsWavelet`` over the spatially filtered component
        time series (channels become ``comp0, comp1, ...``), so any
        downstream transform runs on high-SNR components instead of raw
        sensors.  Composable like :meth:`modwt_denoise`."""
        from ..ops import spatial as _sp
        filters = result.filters if hasattr(result, "filters") else result
        if n_components is not None:
            filters = filters[:, :n_components]
        src = np.asarray(_sp.spatial_apply(self._all_data(), filters))
        names = [f"comp{k}" for k in range(src.shape[1])]
        times = getattr(self.epochs, "times", None)
        return self._carry_codes(EpochsWavelet(
            ArrayEpochs(src, self.wavelet.sfreq, names, times=times),
            self.wavelet))

    def env_corr(self, freqs: Numbers, orthogonalize: bool = True,
                 log: bool = True, time_range=None) -> jnp.ndarray:
        """(F, C, C) power-envelope correlation matrices over ALL
        channels (extension — ``ops.envelope``, Hipp et al. 2012):
        ``orthogonalize=True`` projects out the zero-lag source-leakage
        component before correlating (volume-conduction-robust resting-
        state coupling); ``time_range`` is a seconds pair."""
        from ..ops.envelope import env_corr_matrix
        waves = self._all_data()
        br, bi = self._conn_bank(waves.shape[-1], freqs)
        return env_corr_matrix(
            waves, br, orthogonalize=orthogonalize,
            interpolate=self.wavelet.interpolate, log=log,
            time_range=self._samples(time_range))

    def granger(self, picks=None, n_bins: int = 65, time_decim: int = 16,
                n_iter: int = 60, conditional: bool = False) -> jnp.ndarray:
        """(T', K, C, C) time-resolved pairwise spectral Granger
        causality over channels (extension — ``ops.granger``, Dhamala et
        al. 2008): ``out[t, k, i, j]`` is the influence j -> i at the
        ``k``-th uniform frequency bin (``ops.granger.uniform_freqs(
        n_bins, sfreq)``) and every ``time_decim``-th sample.  ``picks``
        restricts to a channel-name subset (order kept).  Uses its own
        energy-normalized uniform-grid Morse bank, independent of this
        wavelet's bank.  ``conditional=True`` switches to the
        multivariate conditional estimator (needs >= 3 channels;
        indirect routes suppressed)."""
        from ..ops.granger import (wavelet_conditional_granger,
                                   wavelet_granger)
        waves = np.asarray(self._host_data())
        if picks is not None:
            idx = [self.epochs.ch_names.index(ch) for ch in picks]
            waves = waves[:, idx, :]
        fn = wavelet_conditional_granger if conditional else wavelet_granger
        return fn(waves, self.wavelet.sfreq, n_bins=n_bins,
                  time_decim=time_decim, n_iter=n_iter)

    def cfd(self, ch_name: str, freqs_slow: Numbers,
            freqs_fast: Numbers, band=None) -> jnp.ndarray:
        """(N,) cross-frequency directionality of one channel
        (extension — ``ops.cfd``, Jiang 2015): positive where the slow
        phase LEADS the fast amplitude envelope (phase drives
        amplitude), negative for the reverse."""
        from ..ops.extensions import cfd as _cfd
        waves = self._channel_data(ch_name)
        bs, _ = self._conn_bank(waves.shape[-1], freqs_slow)
        bf, _ = self._conn_bank(waves.shape[-1], freqs_fast)
        return _cfd(waves, bs, bf, band=band,
                    interpolate=self.wavelet.interpolate)

    def erpac(self, ch_name: str, freqs_phase: Numbers,
              freqs_amp: Numbers) -> jnp.ndarray:
        """(Fp, Fa, N) event-related PAC of one channel (extension —
        ``ops.connectivity.erpac``, Voytek 2013): circular-linear
        phase-amplitude correlation ACROSS trials at every time point —
        WHEN does coupling appear relative to the event."""
        from ..ops.connectivity import erpac as _erpac
        waves = self._channel_data(ch_name)
        bp, _ = self._conn_bank(waves.shape[-1], freqs_phase)
        ba, _ = self._conn_bank(waves.shape[-1], freqs_amp)
        return _erpac(waves, bp, ba,
                      interpolate=self.wavelet.interpolate)

    def bicoherence(self, ch_name: str, freqs1: Numbers,
                    freqs2: Numbers = None,
                    eps: float = 1e-12) -> jnp.ndarray:
        """(F1, F2) magnitude-squared wavelet bicoherence of one channel
        across epochs (extension — ``ops.extensions.bicoherence``):
        quadratic phase coupling, ~1 where the ``f1 + f2`` oscillation
        carries the phase SUM of the ``f1``/``f2`` components.
        ``freqs2`` defaults to ``freqs1`` (auto-bicoherence).  Every
        pairwise sum must stay below Nyquist."""
        from ..ops.extensions import bicoherence as _bic
        waves = self._channel_data(ch_name)[:, None, :]
        f1 = np.asarray(freqs1, np.float64)
        f2 = f1 if freqs2 is None else np.asarray(freqs2, np.float64)
        sums = (f1[:, None] + f2[None, :]).ravel()
        nyq = self.wavelet.sfreq / 2.0
        if sums.max() >= nyq:
            raise ValueError(
                f"f1 + f2 reaches {sums.max():g} Hz >= Nyquist {nyq:g} — "
                "shrink the grids")
        n = waves.shape[-1]
        b1, _ = self._conn_bank(n, f1)
        b2, _ = self._conn_bank(n, f2)
        b12, _ = self._conn_bank(n, sums)
        return _bic(waves, b1, b2, b12,
                    interpolate=self.wavelet.interpolate, eps=eps)[0]

    def _samples(self, time_range):
        """(start_s, stop_s) -> integer sample window, or None."""
        if time_range is None:
            return None
        sf = self.wavelet.sfreq
        return (int(round(time_range[0] * sf)),
                int(round(time_range[1] * sf)))


class RawWavelet:
    """Wavelet power over a CONTINUOUS MNE-style raw recording (extension —
    the reference has no Raw adapter; its only MNE surface is epochs).

    Wraps ``parallel.StreamingCWT``: the recording is processed in
    fixed-size overlap-discard windows (one compiled program reused
    throughout, O(window) device memory regardless of length), with every
    channel riding the device batch alongside the windows.

    Parameters
    ----------
    raw: an ``mne.io.Raw``-like object (``.info['sfreq']``, ``.ch_names``,
        ``.get_data() -> (C, N)``).
    wavelet: a ``WaveletBase`` instance; its ``sfreq`` is overwritten from
        ``raw.info`` (the EpochsWavelet convention, ``mneutils.py:24``).
    window / halo: see ``StreamingCWT`` (halo defaults from the wavelet's
        envelope decay at the lowest analysis frequency; the extended
        window is rounded to a power of two).
    """

    def __init__(self, raw, wavelet: WaveletBase, window: int = 16384,
                 halo=None, batch: int = 8) -> None:
        self.raw = raw
        self.wavelet = wavelet
        wavelet.sfreq = float(raw.info['sfreq'])
        self._window = int(window)
        self._halo = halo
        self._batch = int(batch)

    @classmethod
    def from_edf(cls, path, wavelet: WaveletBase, picks=None,
                 **kw) -> "RawWavelet":
        """Open an EDF recording directly (``io.EDFRaw`` under the
        hood): ``power``/``power_channel`` then stream window batches
        straight off the file mmap via the native gather kernels — the
        recording is never materialized in host memory."""
        from ..io.edf import EDFRaw
        return cls(EDFRaw(path, picks=picks), wavelet, **kw)

    @classmethod
    def from_bdf(cls, path, wavelet: WaveletBase, picks=None,
                 **kw) -> "RawWavelet":
        """Open a BioSemi BDF recording (24-bit; ``io.BDFRaw``).
        Trigger events live on the ``Status`` channel — extract them
        with ``io.status_events(rw.raw.reader.get_data(["Status"])[0])``
        (the underlying ``BDFReader`` takes channel-name picks)."""
        from ..io.bdf import BDFRaw
        return cls(BDFRaw(path, picks=picks), wavelet, **kw)

    @classmethod
    def from_brainvision(cls, vhdr_path, wavelet: WaveletBase,
                         picks=None, **kw) -> "RawWavelet":
        """Open a BrainVision recording (.vhdr) directly
        (``io.BVRaw``); markers are at ``.raw.reader.markers`` —
        feed them to :meth:`epochs` for stimulus-locked epoching
        straight off the file."""
        from ..io.brainvision import BVRaw
        return cls(BVRaw(vhdr_path, picks=picks), wavelet, **kw)

    def invalidate(self) -> None:
        """Drop the cached ``get_data()`` snapshot and streams — call after
        mutating the raw object (crop/filter), like
        ``EpochsWavelet.invalidate``."""
        for attr in ('_host', '_streams'):
            if hasattr(self, attr):
                delattr(self, attr)

    def _host_data(self) -> np.ndarray:
        """Host copy of ``raw.get_data()``, fetched once (a realistic Raw
        is hundreds of MB and MNE may load/copy per call)."""
        if not hasattr(self, '_host'):
            self._host = np.asarray(self.raw.get_data(), np.float32)
        return self._host

    def _file_source(self, picks=None):
        """An ``io.stream`` source gathering straight off the file mmap
        when the raw object is EDF-backed (``io.EDFRaw``), else None.
        File-backed recordings then stream into the device without a
        host snapshot (SURVEY §7.3's input-pipeline requirement)."""
        reader = getattr(self.raw, "reader", None)
        if reader is None or not hasattr(reader, "gather"):
            return None
        from ..io.stream import EDFSource
        if picks is not None:
            # Same contract as the snapshot path: picks resolve against
            # THIS adapter's channel list (which honors any construction-
            # time subset), never against the full file.
            for ch in picks:
                if ch not in self.raw.ch_names:
                    raise ValueError(f"channel {ch!r} not in raw.ch_names")
            names = list(picks)
        else:
            names = getattr(self.raw, "_picks", None)
        return EDFSource(reader, picks=names)

    def _stream_for(self, freqs: Numbers):
        # One StreamingCWT (bank synthesis + halo derivation + compiled
        # window program) per frequency grid, cached.
        from ..parallel.streaming import StreamingCWT
        w = self.wavelet
        arr = np.asarray(w._check_freqs(freqs), np.float32)
        key = (tuple(arr.tolist()), w.sfreq, w.interpolate)
        streams = getattr(self, '_streams', None)
        if streams is None:
            streams = self._streams = {}
        if key not in streams:
            streams[key] = StreamingCWT(
                w._wdef(), arr, w.sfreq, window=self._window,
                halo=self._halo, interpolate=w.interpolate,
                batch=self._batch)
        return streams[key]

    def power(self, freqs: Numbers, picks=None):
        """(C, F, N) power TFR of the whole recording, assembled ON DEVICE
        (fetching it to host is the caller's choice — the plane is the
        largest tensor in the pipeline).  ``picks``: optional list of
        channel names."""
        source = self._file_source(picks)
        if source is not None:
            return self._stream_for(freqs).power_device_source(source)
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        return self._stream_for(freqs).power_device(data)

    def power_channel(self, ch_name: str, freqs: Numbers):
        """(F, N) power TFR of one channel (sliced on host — only that
        channel's samples ride the stream)."""
        source = self._file_source([ch_name])
        if source is not None:
            return self._stream_for(freqs).power_device_source(source)[0]
        data = self._host_data()[self.raw.ch_names.index(ch_name)]
        return self._stream_for(freqs).power_device(data)

    def ssq_power(self, freqs: Numbers, picks=None,
                  rel_threshold: float = 1e-6):
        """(C, F, N) SYNCHROSQUEEZED power of the whole recording,
        streamed windowwise (see ``StreamingCWT.ssq_power_device`` for
        the per-window noise-gate semantics).  Real banks only."""
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        return self._stream_for(freqs).ssq_power_device(
            data, rel_threshold=rel_threshold)

    def irasa(self, band=(1.0, 40.0), picks=None, hset=None,
              nperseg: int = 1024):
        """Fractal/oscillatory split of each channel's Welch spectrum
        (extension — ``ops.irasa``, Wen & Liu 2016): IrasaResult with
        (C, Fb) components; pair with ``ops.aperiodic_fit`` for the
        model-free 1/f exponent (vs ``specparam``'s parametric fit)."""
        from ..ops.irasa import irasa as _irasa
        data = self._host_data()
        if picks is not None:
            data = data[[self.raw.ch_names.index(ch) for ch in picks]]
        return _irasa(data, self.wavelet.sfreq, band=band, hset=hset,
                      nperseg=nperseg)

    def interpolate_bads(self, positions, bads) -> np.ndarray:
        """(C, N) copy of the recording with the listed channel NAMES
        replaced by spherical-spline interpolations from the good ones
        (extension — ``ops.csd.interpolate_channels``; the repair step
        for :meth:`find_bad_channels`).  Wrap the result in a new
        ``RawWavelet`` for downstream analysis."""
        from ..ops.csd import interpolate_channels
        names = self.raw.ch_names
        idx = []
        for ch in bads:
            if ch not in names:
                raise ValueError(f"channel {ch!r} not in ch_names")
            idx.append(names.index(ch))
        return np.asarray(interpolate_channels(
            self._host_data(), positions, idx))

    def find_bad_channels(self, **kw) -> dict:
        """Channel QC of the recording (extension —
        ``ops.reject.find_bad_channels``, PREP-style): flat / noisy /
        high-frequency / uncorrelated channels and bridged pairs, as
        channel NAMES (the ``bads`` list feeds
        ``EpochsWavelet.interpolate_bads`` or a picks subset).  Keyword
        knobs pass through (``z_thresh``, ``hf_hz``, ``corr_thresh``,
        ``bridge_thresh``, ``flat_tol``)."""
        from ..ops.reject import find_bad_channels as _fbc
        r = _fbc(self._host_data(), self.wavelet.sfreq, **kw)
        names = self.raw.ch_names
        out = {k: [names[i] for i in v] for k, v in r.items()
               if k != "bridged"}
        out["bridged"] = [(names[i], names[j]) for i, j in r["bridged"]]
        return out

    def psd(self, picks=None, nperseg: int = 1024, band=None):
        """``(freqs, psd)`` — (C, F) Welch power spectral density of the
        recording (extension — ``ops.irasa.welch_psd``; Hamming window,
        50% overlap, density scaling, scipy-oracled; mne's
        ``compute_psd``).  ``band=(lo, hi)`` Hz crops the frequency
        axis; the segment length is clamped to a power of two (the FFT's
        fastest length)."""
        return _welch_of(self._host_data(), self.raw.ch_names,
                         self.wavelet.sfreq, picks, nperseg, band)

    def filter(self, f_lo: Optional[float] = None,
               f_hi: Optional[float] = None, notch_hz=None,
               picks=None) -> np.ndarray:
        """(C, N) zero-phase filtered copy of the recording (extension —
        ``ops.filtering``): band/low/highpass from whichever of
        ``f_lo``/``f_hi`` is given, plus optional ``notch_hz`` (a line
        frequency or list of them).  Wrap the result in a new
        ``RawWavelet`` for downstream analysis."""
        from ..ops import filtering as flt
        data = self._host_data()
        if picks is not None:
            data = data[[self.raw.ch_names.index(ch) for ch in picks]]
        sfreq = self.wavelet.sfreq
        out = jnp.asarray(data)
        if f_lo is not None and f_hi is not None:
            out = flt.bandpass(out, sfreq, f_lo, f_hi)
        elif f_hi is not None:
            out = flt.lowpass(out, sfreq, f_hi)
        elif f_lo is not None:
            out = flt.highpass(out, sfreq, f_lo)
        if notch_hz is not None:
            for f0 in np.atleast_1d(notch_hz):
                out = flt.notch(out, sfreq, float(f0))
        return np.asarray(out)

    def resample(self, new_sfreq: float, picks=None):
        """``(data, new_sfreq)`` — FFT-resampled copy of the recording
        (extension — ``ops.resample``; pow2 rate ratios are exact
        spectrum truncation, anything else anti-aliased + cubic)."""
        from ..ops.filtering import resample as _resample
        data = self._host_data()
        if picks is not None:
            data = data[[self.raw.ch_names.index(ch) for ch in picks]]
        y, sf = _resample(data, self.wavelet.sfreq, new_sfreq)
        return np.asarray(y), sf

    def ica(self, n_components: Optional[int] = None, picks=None, **kw):
        """FastICA decomposition of the recording (extension —
        ``ops.ica``): an ``ICAResult`` with variance-sorted, sign-fixed
        components.  Inspect ``result.sources`` / ``result.mixing`` to
        flag artifact components, then reconstruct without them via
        ``ica_clean``."""
        from ..ops.ica import fastica
        data = self._host_data()
        if picks is not None:
            data = data[[self.raw.ch_names.index(ch) for ch in picks]]
        return fastica(data, n_components, **kw)

    def ica_clean(self, result, exclude, picks=None) -> np.ndarray:
        """(C, N) copy of the recording with the ``exclude``d ICA
        components removed (mne's ``ica.apply`` step).  ``picks`` must
        match the ``picks`` the model was fitted with — those channels
        are reconstructed, the rest pass through untouched.  Wrap the
        result in a new ``RawWavelet`` to run any downstream analysis
        on the cleaned recording."""
        from ..ops.ica import ica_remove
        data = self._host_data()
        if picks is None:
            return np.asarray(ica_remove(data, result, exclude))
        idx = [self.raw.ch_names.index(ch) for ch in picks]
        out = np.array(data, copy=True)
        out[idx] = np.asarray(ica_remove(data[idx], result, exclude))
        return out

    def ica_find_bads(self, result, ref=None, threshold: float = 3.0,
                      measure: str = "zscore"):
        """``(bad_indices, scores)`` — automatic artifact-component
        selection (extension — ``ops.ica.ica_find_bads``, mne's
        ``find_bads_eog``/``find_bads_ecg`` correlation criterion).
        ``ref`` is a channel NAME (or list of names) whose trace the
        components are correlated against — the EOG/ECG electrode; with
        ``ref=None`` the unsupervised excess-kurtosis criterion flags
        spiky components instead."""
        from ..ops.ica import ica_find_bads
        trace = None
        if ref is not None:
            names = [ref] if isinstance(ref, str) else list(ref)
            data = self._host_data()
            trace = data[[self.raw.ch_names.index(ch) for ch in names]]
        return ica_find_bads(result, trace, threshold=float(threshold),
                             measure=measure)

    def states(self, n_states: int = 4,
               bands=((1.0, 4.0), (4.0, 8.0), (8.0, 13.0), (13.0, 30.0)),
               picks=None, decim: Optional[int] = None,
               n_iter: int = 50, stickiness: float = 0.9,
               seed: int = 0):
        """Recurring spectral states of the recording (extension —
        ``ops.hmm``, the osl-dynamics/Vidaurre HMM workflow): per-channel
        log band-power envelopes (``bands``, default the canonical
        delta/theta/alpha/beta) are z-scored and segmented by a K-state
        Gaussian HMM.  Returns the ``HMMResult``; its ``means`` rows are
        the state spectral profiles over the (channel x band) feature
        grid, ``states``/``gamma`` the decoded time course at the
        decimated envelope rate (``decim`` defaults to ~20 Hz)."""
        from ..ops.hmm import hmm_fit
        bands = [(float(lo), float(hi)) for lo, hi in bands]
        rows = 4                       # freq rows averaged per band
        freqs = np.concatenate([np.linspace(lo, hi, rows)
                                for lo, hi in bands]).astype(np.float32)
        p = self.power(freqs, picks)                     # (C, F, N)
        c, f, n = p.shape
        if decim is None:
            decim = max(1, int(self.wavelet.sfreq // 20))
        nt = n // decim
        p = p[:, :, :nt * decim].reshape(c, len(bands), rows, nt, decim)
        p = jnp.mean(p, axis=(2, 4))                     # (C, B, nt)
        feats = jnp.log(p + 1e-12).reshape(c * len(bands), nt).T
        feats = ((feats - jnp.mean(feats, 0))
                 / (jnp.std(feats, 0) + 1e-6))
        return hmm_fit(feats, n_states, n_iter=n_iter,
                       stickiness=stickiness, seed=seed)

    def trf(self, stim, tmin_s: float = 0.0, tmax_s: float = 0.25,
            lams=(1e-4, 1e-3, 1e-2, 1e-1, 1.0), n_folds: int = 5,
            picks=None):
        """Cross-validated temporal response function from a continuous
        stimulus to this recording (extension — ``ops.trf``, the
        mTRF-Toolbox/Crosse workflow; e.g. speech-envelope tracking).
        ``stim`` is (N,) or (K, N) aligned with the recording; the lag
        window runs ``tmin_s``..``tmax_s`` SECONDS (positive = response
        follows stimulus).  Returns ``(TRFResult, r, best_lam)`` with
        per-channel held-out Pearson r (contiguous folds)."""
        from ..ops.trf import trf_cv
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        sf = self.wavelet.sfreq
        lags = range(int(round(tmin_s * sf)),
                     int(round(tmax_s * sf)) + 1)
        return trf_cv(stim, data, lags, lams=lams, n_folds=n_folds)

    def asr_clean(self, cutoff: float = 5.0, win_s: float = 0.5,
                  calib_frac: float = 0.25, return_keep: bool = False):
        """(C, N) ASR-cleaned copy of the recording (extension —
        ``ops.asr``, Mullen 2015): the model calibrates on the
        ``calib_frac`` cleanest windows (lowest worst-channel
        peak-to-peak — automatic baseline selection), then every
        50%-overlapped window's high-variance components are
        reconstructed from it.  ``return_keep=True`` also returns the
        (W, C) per-window component survival flags."""
        from ..ops.asr import asr_calibrate, asr_process
        from ..ops.reject import ptp
        import jax.numpy as _jnp
        data = self._host_data()
        sfreq = self.wavelet.sfreq
        win = max(2, int(round(win_s * sfreq)))
        nw_ = data.shape[-1] // win
        frames = data[:, :nw_ * win].reshape(data.shape[0], nw_, win)
        score = np.asarray(ptp(_jnp.asarray(frames))).max(0)   # (W,)
        n_keep = max(4, int(round(calib_frac * nw_)))
        order = np.argsort(score)[:n_keep]
        calib = frames[:, np.sort(order), :].reshape(data.shape[0], -1)
        model = asr_calibrate(calib, sfreq, cutoff=cutoff, win_s=win_s)
        cleaned, keep = asr_process(data, sfreq, model, win_s=win_s)
        return (cleaned, keep) if return_keep else cleaned

    def dfa(self, ch_name: str, freq: float, scales=None,
            decim: int = 4, **kw):
        """Long-range temporal correlation of one channel's band
        amplitude envelope (extension — the Linkenkaer-Hansen 2001
        workflow): the wavelet amplitude at ``freq`` Hz (streamed, so
        any recording length works), decimated by ``decim``, through
        ``ops.complexity.dfa``.  Returns ``(alpha, fluctuations)``;
        ``scales`` are in DECIMATED samples (default log-spaced).
        Healthy resting alpha envelopes run alpha ~ 0.6-0.9."""
        from ..ops.complexity import dfa as _dfa
        import jax.numpy as _jnp
        p = self.power_channel(ch_name, [float(freq)])    # (1, N)
        env = _jnp.sqrt(_jnp.maximum(p[0], 0.0))[::int(decim)]
        return _dfa(env, scales=scales, **kw)

    def spindles(self, picks=None, **kw):
        """Sleep-spindle detection over the recording's channels
        (extension — ``ops.sleep.detect_spindles``, YASA-style
        sigma-envelope rule): an ``EventTable`` with leading channel
        dim; ``freq_range=`` / ``thresh=`` / ``duration=`` pass
        through."""
        from ..ops.sleep import detect_spindles
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        return detect_spindles(data, self.wavelet.sfreq, **kw)

    def slow_oscillations(self, picks=None, **kw):
        """Slow-oscillation detection (extension —
        ``ops.sleep.detect_slow_oscillations``, Massimini criteria with
        adaptive robust-sigma thresholds by default)."""
        from ..ops.sleep import detect_slow_oscillations
        data = self._host_data()
        if picks is not None:
            idx = [self.raw.ch_names.index(ch) for ch in picks]
            data = data[idx]
        return detect_slow_oscillations(data, self.wavelet.sfreq, **kw)

    def microstates(self, n_states: int = 4, peaks_only: bool = True,
                    n_init: int = 8, n_iter: int = 40, seed: int = 0):
        """EEG microstate decomposition of the recording (extension —
        ``ops.microstates``, Pascual-Marqui et al. 1995): polarity-
        invariant topographic clustering into ``n_states`` maps (the
        canonical A/B/C/D at the default 4), fitted on GFP peaks and
        backfitted to every sample.  The broadband complement of
        :meth:`states` (spectral HMM).  Returns ``(result, stats)``:
        a ``MicrostateResult`` and the coverage / duration / occurrence
        / transition statistics dict."""
        from ..ops.microstates import microstate_fit, microstate_stats
        data = self._host_data()                       # (C, N)
        res = microstate_fit(data, n_states, peaks_only=peaks_only,
                             n_init=n_init, n_iter=n_iter, seed=seed)
        stats = microstate_stats(res.labels, int(n_states),
                                 self.wavelet.sfreq)
        return res, stats

    def coherence(self, ch_a: str, ch_b: str, freqs: Numbers,
                  cycles: float = 1.0, scale_width: float = 0.6,
                  eps: float = 1e-12, return_phase: bool = False,
                  significance: int = 0, seed: int = 0):
        """(F, N) SINGLE-TRIAL smoothed wavelet coherence between two
        channels of the continuous recording (extension —
        ``ops.extensions.wavelet_coherence``: Torrence–Webster time/scale
        smoothing; without repeated trials the smoothing plays the role
        the epoch ensemble plays in ``EpochsWavelet.coherence``).

        Runs the WHOLE recording in one program — O(F*N) device memory;
        for multi-hour streams, epoch the recording first
        (``self.epochs``) or window it on the caller side."""
        from ..ops import bank as _bank
        from ..ops.extensions import wavelet_coherence
        w = self.wavelet
        data = self._host_data()
        ia = self.raw.ch_names.index(ch_a)
        ib = self.raw.ch_names.index(ch_b)
        arr = np.asarray(w._check_freqs(freqs), np.float32)
        br, bi = _bank.make_fft_bank_ri(w._wdef(), arr, data.shape[-1],
                                        w.sfreq, w.interpolate,
                                        w.real_wave_length)
        out = wavelet_coherence(jnp.asarray(data[ia]),
                                 jnp.asarray(data[ib]), br, arr, w.sfreq,
                                 bank_i=bi, interpolate=w.interpolate,
                                 cycles=cycles, scale_width=scale_width,
                                 eps=eps, return_phase=return_phase)
        if significance:
            if bi is not None:
                raise ValueError(
                    "significance levels need an analytic (real-bank) "
                    "family — the AR(1) null is built on the real bank "
                    "and would not match a Normal/Twice-mode estimator")
            # Grinsted AR(1) Monte-Carlo levels: (F,) per-row threshold
            from ..ops.extensions import wtc_significance
            thr = wtc_significance(
                data[ia], data[ib], br, arr, w.sfreq,
                n_surrogates=int(significance), seed=seed,
                interpolate=w.interpolate, cycles=cycles,
                scale_width=scale_width, eps=eps)
            return (*(out if return_phase else (out,)), thr)
        return out

    # -- event-locked epoching ---------------------------------------------

    def specparam(self, freqs: Numbers, picks=None, max_peaks: int = 4,
                  fit_knee: bool = False, **kw):
        """FOOOF-style spectral fit of the recording's time-averaged
        wavelet power, batched over channels (extension —
        ``ops.specparam``; resting-state aperiodic slope + oscillatory
        peaks is THE standard use).  Returns a ``SpectralFit`` whose
        leading axis is the picked channels."""
        from ..ops.specparam import specparam as _fit
        # reduce ON DEVICE: only the (C, F) mean crosses to the host
        power = np.asarray(self.power(freqs, picks=picks).mean(-1))
        return _fit(power, np.asarray(freqs, np.float64),
                    max_peaks=max_peaks, fit_knee=fit_knee, **kw)

    def modwt_denoise(self, picks=None, wavelet: str = "db4",
                      level=None, mode: str = "soft") -> np.ndarray:
        """(C, N) MODWT-shrinkage-denoised copy of the recording
        (extension — ``ops.dwt.modwt_denoise``): per-channel
        level-dependent universal thresholding.  Arbitrary lengths are
        reflect-padded to a power of two on device and cropped (the FFT's
        fastest length), so this works on real (non-pow2) recordings."""
        from ..ops.dwt import modwt_denoise as _denoise
        data = self._host_data()
        if picks is not None:
            data = data[[self.raw.ch_names.index(ch) for ch in picks]]
        return np.asarray(_denoise(data, wavelet, level, mode,
                                   pad_pow2=True))

    def modwt_var(self, ch_name: str, wavelet: str = "db4",
                  level=None) -> np.ndarray:
        """(J,) wavelet variance by scale of one channel (extension —
        ``ops.dwt.modwt_var``; level-j entry is the portion of the sample
        variance in the ``[sfreq/2^{j+1}, sfreq/2^j]`` Hz octave).
        Arbitrary lengths are reflect-padded to a power of two."""
        from ..ops.dwt import modwt_var as _var
        from ..ops.dwt import pow2_pad
        data = self._host_data()[self.raw.ch_names.index(ch_name)]
        padded, _ = pow2_pad(jnp.asarray(data))
        return np.asarray(_var(padded, wavelet, level))

    def epochs_from_markers(self, tmin: float, tmax: float,
                            description=None, kind=None,
                            picks=None) -> "EpochsWavelet":
        """Event-locked epochs from the recording's embedded markers
        (extension — BrainVision .vmrk via ``io.BVReader.markers``):
        filter by marker ``description`` (e.g. ``"S  1"``) and/or
        ``kind`` (e.g. ``"Stimulus"``), then slice like
        :meth:`epochs`."""
        reader = getattr(self.raw, "reader", None)
        markers = getattr(reader, "markers", None)
        if not markers:
            raise ValueError(
                "this recording carries no markers (open a BrainVision "
                "file with a .vmrk via RawWavelet.from_brainvision)")
        hits = [(s, d) for (s, k, d) in markers
                if (kind is None or k == kind)
                and (description is None or d == description)]
        if not hits:
            raise ValueError(
                f"no markers match kind={kind!r} "
                f"description={description!r}")
        ev = np.asarray([s for s, _ in hits], np.int64)
        # marker descriptions ride along as event_codes, so
        # .split() partitions by stimulus type directly
        return self.epochs(ev, tmin, tmax, picks=picks,
                           codes=np.asarray([d for _, d in hits]))

    def _bad_spans(self, prefix: str):
        """[(onset_s, duration_s), ...] of annotations whose text starts
        with ``prefix`` (case-insensitive — mne's "bad" convention).
        Needs a reader with ``read_annotations`` (EDF+)."""
        reader = getattr(self.raw, "reader", None)
        read = getattr(reader, "read_annotations", None)
        if read is None:
            raise ValueError(
                "this recording carries no annotation spans (open an "
                "EDF+ file via RawWavelet.from_edf, or pass explicit "
                "reject_spans=[(onset_s, duration_s), ...])")
        p = prefix.lower()
        return [(o, d) for (o, d, txt) in read()
                if txt.lower().startswith(p)]

    def epochs(self, events, tmin: float, tmax: float,
               picks=None, reject_spans=None,
               reject_annotations: Optional[str] = None,
               codes=None) -> "EpochsWavelet":
        """Slice event-locked windows out of the recording and return an
        ``EpochsWavelet`` over them (extension — the reference has no Raw
        surface at all; this mirrors the ``mne.Epochs(raw, events)``
        workflow without requiring mne).

        Every epochs-level transform — ``power``/``itc``/``ssq_power``/
        ``plv``/``pac``/... — then runs on the event-locked batch through
        the same fused device programs as a real ``mne.Epochs`` input.

        Parameters
        ----------
        events: either an ``(E,)`` array of event sample indices, or an
            MNE-style ``(E, 3)`` int array whose FIRST column is the sample
            index; the THIRD (event-id) column, when present, survives on
            the result as ``.event_codes`` (filtered alongside the kept
            events) so ``ew.split()`` partitions by condition directly.
            The duration column is ignored, as ``mne.Epochs`` does.
        tmin / tmax: window extent in seconds relative to each event; both
            endpoint samples are included (mne's convention:
            ``n = round((tmax - tmin) * sfreq) + 1``).
        picks: optional channel-name list (window extraction then copies
            only those rows).
        reject_spans: optional ``[(onset_s, duration_s), ...]`` — events
            whose window OVERLAPS any span are dropped (mne's
            reject-by-annotation semantics).
        reject_annotations: optional text prefix (e.g. ``"bad"``,
            case-insensitive) — pulls the spans from the recording's
            EDF+ annotations instead.  Combines with ``reject_spans``.

        Events whose window would cross either recording edge are dropped,
        like mne's "too close to the edge" rejection.
        """
        ev = np.asarray(events)
        codes = None if codes is None else np.asarray(codes)
        if ev.ndim == 2:
            if codes is None and ev.shape[1] >= 3:
                codes = ev[:, 2].copy()      # mne event-id column
            ev = ev[:, 0]
        if codes is not None and codes.shape[0] != ev.shape[0]:
            raise ValueError("codes must have one entry per event")
        ev = ev.astype(np.int64)
        sf = self.wavelet.sfreq
        start = int(round(tmin * sf))
        n_win = int(round((tmax - tmin) * sf)) + 1
        ch_names = (list(picks) if picks is not None
                    else list(self.raw.ch_names))
        source = self._file_source(picks)
        if source is not None:
            n = int(source.n_samples)
        else:
            data = self._host_data()
            if picks is not None:
                idx = [self.raw.ch_names.index(ch) for ch in picks]
                data = data[idx]
            n = data.shape[-1]
        keep = (ev + start >= 0) & (ev + start + n_win <= n)
        spans = list(reject_spans) if reject_spans else []
        if reject_annotations is not None:
            spans += self._bad_spans(reject_annotations)
        if spans:
            lo = ev + start                       # window [lo, hi)
            hi = lo + n_win
            for onset_s, dur_s in spans:
                s0 = int(np.floor(float(onset_s) * sf))
                s1 = int(np.ceil((float(onset_s) + float(dur_s)) * sf))
                keep &= (hi <= s0) | (lo >= max(s1, s0 + 1))
        ev = ev[keep]
        if codes is not None:
            codes = codes[keep]
        if ev.size == 0:
            raise ValueError(
                "no event window fits inside the recording "
                f"(N={n}, window={n_win} samples at offset {start}"
                + (", after bad-span rejection" if spans else "") + ")")
        # One native gather builds the (E, C, Nw) batch — straight off
        # the file mmap for EDF-backed recordings (no host snapshot),
        # off the cached snapshot otherwise (halo=0: every kept window
        # is interior, so no zero-padding can occur).
        if source is not None:
            windows = source.gather(ev + start, n_win, 0)
        else:
            from ..io.native import f32_gather
            flat = data.reshape(-1, n)
            windows = f32_gather(flat, ev + start, n_win, 0).reshape(
                (len(ev),) + data.shape[:-1] + (n_win,))
        times = tmin + np.arange(n_win) / sf
        out = EpochsWavelet(
            ArrayEpochs(windows, sf, ch_names, times=times), self.wavelet)
        if codes is not None:
            # the surviving events' id column — ready for
            # out.split(out.event_codes)
            out.event_codes = codes
        return out

    def itc(self, freqs: Numbers, events, tmin: float, tmax: float,
            picks=None) -> jnp.ndarray:
        """(C, F, Nw) inter-trial coherence locked to ``events``
        (convenience over ``self.epochs(...).itc_all``) — ITC is only
        defined ACROSS repeated trials, so on a continuous recording it
        needs event markers."""
        return self.epochs(events, tmin, tmax, picks=picks).itc_all(freqs)

    def epoch_power(self, freqs: Numbers, events, tmin: float, tmax: float,
                    picks=None, **kw) -> jnp.ndarray:
        """(C, F, Nw) event-locked epoch-mean power (convenience over
        ``self.epochs(...).power_all``; same ``baseline``/``decim``
        keywords)."""
        return self.epochs(events, tmin, tmax, picks=picks).power_all(
            freqs, **kw)


class ArrayEpochs:
    """Minimal epochs container over a plain ``(E, C, N)`` array — the
    duck-typed MNE surface ``EpochsWavelet`` needs (``.info['sfreq']``,
    ``.ch_names``, ``.get_data()``, ``len``, ``.times``) without importing
    mne.  Use it to feed raw numpy trial data straight into the epochs
    pipeline, or get one from ``RawWavelet.epochs`` for event-locked
    windows of a continuous recording."""

    def __init__(self, data, sfreq: float, ch_names=None, times=None):
        data = np.asarray(data)
        if data.ndim != 3:
            raise ValueError(f"expected (E, C, N), got {data.shape}")
        self._data = data
        self.info = {'sfreq': float(sfreq)}
        self.ch_names = (list(ch_names) if ch_names is not None
                         else [f"ch{c}" for c in range(data.shape[1])])
        if len(self.ch_names) != data.shape[1]:
            raise ValueError("ch_names length != channel axis")
        self.times = (np.asarray(times) if times is not None
                      else np.arange(data.shape[2]) / float(sfreq))

    def __len__(self) -> int:
        return self._data.shape[0]

    def get_data(self) -> np.ndarray:
        return self._data
