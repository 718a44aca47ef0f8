"""Single-device streaming CWT for recordings too long for one FFT.

BASELINE config 4 is a 10-minute 1 kHz recording (600k samples): the
reference would run one 600k-point host FFT per frequency-batch
(``/root/reference/ninwavelets/base.py:399``); the multi-device path shards
time across a mesh (``parallel.chunked``).  This module is the *sequential*
counterpart for one device / host pipelines: overlap-discard convolution over
fixed-size windows, one compiled program reused for every window, O(window)
device memory regardless of recording length.

Same math as ``parallel.chunked``: each window is extended by ``halo``
samples of real signal on both sides, convolved against a bank synthesized
at the extended length, and the halo regions are discarded — interiors match
the whole-signal transform to float32 for any wavelet whose time support
fits in the halo (see ``halo_samples``).
"""
from __future__ import annotations

from functools import partial
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bank import WaveletDef, make_fft_bank_ri
from ..ops.cwt import _as_bank
from ..ops.grids import analytic_mask
from .chunked import halo_samples, pow2_halo


@partial(jax.jit, static_argnames=("halo", "interpolate"))
def _window_power(ext_window, bank_r, bank_i=None, *, halo: int,
                  interpolate: bool = False):
    """|cwt|^2 of one extended window, halos discarded: (..., L+2h) -> (..., F, L)."""
    bank = _as_bank(bank_r, bank_i)
    spec = jnp.fft.fft(ext_window.astype(jnp.complex64))
    if interpolate:
        spec = spec * analytic_mask(ext_window.shape[-1], jnp.float32)
    c = jnp.fft.ifft(spec[..., None, :] * bank)
    p = jnp.square(c.real) + jnp.square(c.imag)
    return p[..., halo:p.shape[-1] - halo]


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("halo", "interpolate"))
def _paste_batch(buf, ext_batch, bank_r, bank_i, start, *, halo: int,
                 interpolate: bool):
    """Window-batch power pasted into the on-device (F, N_padded) plane.
    The batch's windows are time-contiguous, so the (W, F, window) block
    transposes to one (F, W*window) slab and lands in a single
    ``dynamic_update_slice`` at a traced start offset (one compile total).
    ``buf`` is donated: the update happens in place instead of copying the
    full (F, N) plane every batch.
    """
    block = _window_power(ext_batch, bank_r, bank_i, halo=halo,
                          interpolate=interpolate)
    # block: (W, ..., F, window) — windows leading, any channel dims in
    # the middle.  Slab: (..., F, W*window), windows contiguous in time.
    w_count = block.shape[0]
    lead = block.shape[1:-2]
    n_f, w_len = block.shape[-2:]
    perm = tuple(range(1, block.ndim - 1)) + (0, block.ndim - 1)
    slab = jnp.transpose(block, perm).reshape(
        lead + (n_f, w_count * w_len))
    idx = (jnp.int32(0),) * (slab.ndim - 1) + (start,)
    return jax.lax.dynamic_update_slice(buf, slab, idx)


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("halo", "sfreq", "interpolate", "rel_threshold",
                          "uniform_grid"))
def _paste_ssq_batch(buf, ext_batch, bank_r, f_grid, start, *, halo: int,
                     sfreq: float, interpolate: bool, rel_threshold: float,
                     uniform_grid):
    """Window-batch SYNCHROSQUEEZED power pasted into the on-device plane
    (the ssq sibling of ``_paste_batch`` — same slab/update layout)."""
    from ..ops.sst import _reassigned_power

    block = _reassigned_power(ext_batch, bank_r, f_grid, sfreq,
                              interpolate, rel_threshold,
                              uniform_grid=uniform_grid)
    block = block[..., halo:block.shape[-1] - halo]
    w_count = block.shape[0]
    lead = block.shape[1:-2]
    n_f, w_len = block.shape[-2:]
    perm = tuple(range(1, block.ndim - 1)) + (0, block.ndim - 1)
    slab = jnp.transpose(block, perm).reshape(
        lead + (n_f, w_count * w_len))
    idx = (jnp.int32(0),) * (slab.ndim - 1) + (start,)
    return jax.lax.dynamic_update_slice(buf, slab, idx)


class StreamingCWT:
    """Overlap-discard streaming power TFR over an arbitrarily long signal.

    Parameters
    ----------
    wdef: the wavelet definition (``WaveletBase._wdef()`` or a raw
        ``WaveletDef``) — must be a Reverse/Both-mode family.
    freqs: analysis frequencies (Hz).
    sfreq: sampling frequency (Hz).
    window: window length in samples (compiled once; power of two keeps the
        FFT fast).
    halo: overlap in samples; default derives it from the wavelet's envelope
        decay at the lowest analysis frequency.  Either way the halo is then
        rounded UP so the extended window is a power of two, the FFT
        length with the fewest passes.
    interpolate: the reference's analytic / Nyquist-alias trick.
    batch: windows per device call, amortizing dispatch overhead for
        single-channel recordings.
    """

    def __init__(self, wdef: WaveletDef, freqs, sfreq: float,
                 window: int = 65536, halo: Optional[int] = None,
                 interpolate: bool = False, halo_tol: float = 1e-4,
                 batch: int = 8) -> None:
        self.wdef = wdef
        self.freqs = np.asarray(freqs, dtype=np.float32)
        self.sfreq = float(sfreq)
        self.window = int(window)
        if halo is None:
            halo = halo_samples(wdef, float(self.freqs.min()), self.sfreq,
                                tol=halo_tol)
        if halo >= self.window:
            raise ValueError(f"halo {halo} must be smaller than the window "
                             f"{self.window}; raise `window` or `halo_tol`")
        halo = pow2_halo(self.window, int(halo))
        self.halo = int(halo)
        self.interpolate = interpolate
        self.batch = max(int(batch), 1)
        self._bank = make_fft_bank_ri(wdef, jnp.asarray(self.freqs),
                                      self.window + 2 * self.halo, self.sfreq,
                                      interpolate)

    def _device_power(self, ext_batch: np.ndarray) -> np.ndarray:
        """(W, ext) -> (W, F, window) on device."""
        out = _window_power(jnp.asarray(ext_batch), self._bank[0],
                            self._bank[1], halo=self.halo,
                            interpolate=self.interpolate)
        return np.asarray(out)

    def blocks(self, signal: np.ndarray) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start_sample, (F, block_len) power)`` blocks in order.

        The signal is consumed ``batch`` windows at a time (one device call
        per batch); edges are zero-padded (linear convolution at the global
        boundary, like the chunked mesh path).  The final block may be
        shorter than ``window``.
        """
        signal = np.asarray(signal, dtype=np.float32)
        n = signal.shape[-1]
        for batch_starts, ext in self._ext_batches(signal):
            block = self._device_power(ext)
            for row, start in enumerate(batch_starts):
                stop = min(start + self.window, n)
                yield start, block[row][..., :stop - start]

    def _ext_batches(self, signal: np.ndarray):
        """Yield ``(batch_starts, (batch, window + 2*halo) ext array)``
        groups (consumed by both ``blocks`` and ``power_device``).

        The extraction arithmetic lives in :mod:`ninwavelets_tpu.io`:
        the native gather kernel fills each batch in one GIL-free C
        call, and a worker thread prepares batch ``i+1`` while the
        device consumes batch ``i``.  Always the full (batch, ext)
        shape — a ragged tail batch would be a second compiled program;
        unused rows stay zero.
        """
        from ..io.stream import ArraySource
        return self._source_batches(ArraySource(signal))

    def _source_batches(self, source):
        """``(batch_starts, ext)`` groups from any ``io.stream`` source
        (in-memory array, mmap'd EDF file, ...)."""
        from ..io.stream import iter_ext_batches
        return iter_ext_batches(source, self.window, self.halo, self.batch)

    def ssq_power_device(self, signal: np.ndarray,
                         rel_threshold: float = 1e-6):
        """(..., F, N) SYNCHROSQUEEZED power of an arbitrarily long
        recording, assembled on device — frequency reassignment is local
        in time, so the overlap-discard windows apply exactly as for
        ``power_device``.

        Semantics note: the noise-gate floor (``rel_threshold`` x peak
        power) is evaluated PER WINDOW, not over the whole recording —
        windows with no strong activity keep their energy in place
        (matching ``ops.sst``'s behavior applied windowwise).  Real banks
        only (phase needed).
        """
        import jax.numpy as jnp

        from ..ops.sst import _reassigned_power, uniform_grid_hint

        if self._bank[1] is not None:
            raise ValueError(
                "synchrosqueezing needs an analytic (real-bank) family")
        signal = np.asarray(signal, dtype=np.float32)
        n = signal.shape[-1]
        span = self.batch * self.window
        n_batches = -(-n // span)
        buf = jnp.zeros(signal.shape[:-1]
                        + (self.freqs.shape[0], n_batches * span),
                        jnp.float32)
        hint = uniform_grid_hint(self.freqs)
        f_grid = jnp.asarray(self.freqs)
        for batch_starts, ext in self._ext_batches(signal):
            buf = _paste_ssq_batch(buf, jnp.asarray(ext), self._bank[0],
                                   f_grid, jnp.int32(batch_starts[0]),
                                   halo=self.halo, sfreq=self.sfreq,
                                   interpolate=self.interpolate,
                                   rel_threshold=float(rel_threshold),
                                   uniform_grid=hint)
        return buf[..., :n]

    def power(self, signal: np.ndarray) -> np.ndarray:
        """Full (..., F, N) power TFR assembled on host from streamed
        blocks (``signal`` may carry leading channel dims — they ride the
        device batch alongside the windows)."""
        signal = np.asarray(signal, dtype=np.float32)
        out = np.empty(signal.shape[:-1]
                       + (self.freqs.shape[0], signal.shape[-1]),
                       dtype=np.float32)
        for start, block in self.blocks(signal):
            out[..., start:start + block.shape[-1]] = block
        return out

    def power_device(self, signal: np.ndarray):
        """Full (F, N) power TFR assembled ON DEVICE (one
        ``dynamic_update_slice`` per window batch; a batch's windows are
        contiguous in time, so each batch is a single update).

        Use this when the TFR feeds further on-device work (baseline
        correction, reductions, plotting decimation): the (F, N) plane is
        the largest tensor in the pipeline, and fetching it to host can
        cost more than computing it.
        """
        from ..io.stream import ArraySource
        return self.power_device_source(ArraySource(signal))

    def power_device_source(self, source):
        """``power_device`` over any :mod:`ninwavelets_tpu.io` source —
        e.g. ``io.EDFSource(path)`` streams a recording straight off the
        file mmap onto the device, window batch by window batch,
        without ever materializing the recording in host memory
        (SURVEY §7.3's input-pipeline requirement); the native gather
        for batch ``i+1`` runs on a worker thread while the device
        computes batch ``i``."""
        n = int(source.n_samples)
        lead = tuple(source.lead)
        span = self.batch * self.window
        n_batches = -(-n // span)
        buf = jnp.zeros(lead + (self.freqs.shape[0], n_batches * span),
                        jnp.float32)
        for batch_starts, ext in self._source_batches(source):
            buf = _paste_batch(buf, jnp.asarray(ext), self._bank[0],
                               self._bank[1],
                               jnp.int32(batch_starts[0]), halo=self.halo,
                               interpolate=self.interpolate)
        return buf[..., :n]
