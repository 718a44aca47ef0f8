"""Online (incremental) CWT for unbounded real-time streams.

:class:`OnlineCWT` is the push-based sibling of
:class:`~ninwavelets_tpu.parallel.streaming.StreamingCWT`: samples
arrive in arbitrarily sized chunks (a BCI amplifier callback, a socket,
a file tail) and finished TFR blocks come back as soon as enough future
context exists — overlap-discard needs ``halo`` samples on each side of
a window, so a window covering ``[s, s+w)`` is emitted once the stream
has reached ``s + w + halo``.  Output is BIT-IDENTICAL to running
``StreamingCWT.power`` over the concatenated stream (same extended
windows, same compiled device program — the jitted window kernels are
module-level and shared), regardless of how the input was chunked;
``flush()`` zero-pads the open tail exactly like the offline edge.

Latency/memory contract: emission lag is ``window + halo`` samples
past a window's start; retained history is O(window + 2*halo) per
channel (plus the unprocessed residue), independent of stream length.

Reference parity: net-new — the reference computes one whole-signal
host FFT per call (base.py:399) and has no incremental surface.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .streaming import StreamingCWT

__all__ = ["OnlineCWT"]


class OnlineCWT:
    """Push-based incremental CWT over an unbounded stream.

    Parameters are :class:`StreamingCWT`'s (one is built internally and
    its compiled window programs are reused); leading channel dims are
    fixed by the first ``push``.

    Usage::

        oc = OnlineCWT(wdef, freqs, sfreq, window=8192, halo=4096)
        for chunk in amplifier:          # any chunk sizes, any lead dims
            for start, block in oc.push(chunk):
                ...                      # (F, window) power, t0 = start
        for start, block in oc.flush():  # zero-padded open tail
            ...
    """

    def __init__(self, wdef, freqs, sfreq: float, window: int = 65536,
                 halo: Optional[int] = None, **kw) -> None:
        # batch=1 default: a real-time consumer wants each window the
        # moment its context closes, not after `batch` of them queue up
        # — and single-window batches make the output BIT-identical to
        # ``StreamingCWT(batch=1)`` under any chunking.  With batch>1
        # (throughput tuning) the parity contract weakens to float32
        # rounding (~1e-7): XLA's CPU rFFT packs row PAIRS into one
        # complex transform, so a window's rounding depends on which
        # rows share its batch.
        kw.setdefault("batch", 1)
        self._s = StreamingCWT(wdef, freqs, sfreq, window=window,
                               halo=halo, **kw)
        self.window = self._s.window
        self.halo = self._s.halo
        self.freqs = self._s.freqs
        self.sfreq = self._s.sfreq
        self._lead: Optional[tuple] = None
        self._hist: Optional[np.ndarray] = None   # lead + (kept,)
        self._base = 0            # absolute sample index of _hist[..., 0]
        self._next = 0            # start of the next unemitted window
        self._total = 0           # absolute samples pushed so far
        self._flushed = False

    # ------------------------------------------------------------ state
    @property
    def n_pushed(self) -> int:
        """Total samples pushed so far (per channel)."""
        return self._total

    def _append(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk, np.float32)
        lead = chunk.shape[:-1]
        if self._lead is None:
            self._lead = lead
            self._hist = np.zeros(lead + (0,), np.float32)
        elif lead != self._lead:
            raise ValueError(f"chunk lead dims {lead} != stream "
                             f"lead dims {self._lead}")
        self._hist = np.concatenate([self._hist, chunk], axis=-1)
        self._total += chunk.shape[-1]

    def _trim(self) -> None:
        # Keep the halo context before the next unemitted window.
        keep_from = max(self._next - self.halo, 0)
        if keep_from > self._base:
            self._hist = self._hist[..., keep_from - self._base:]
            self._base = keep_from

    def _emit(self, starts: List[int],
              tail_pad: bool) -> List[Tuple[int, np.ndarray]]:
        """Compute the windows at ``starts`` off the retained history
        and advance the cursor.

        Each window sits at the SAME batch row it would occupy offline
        (``(start // window) % batch``): XLA's batched CPU FFT rounds
        differently per row position (verified: content of OTHER rows
        does not matter, position does), so pinning the row makes the
        online output BIT-IDENTICAL to ``StreamingCWT.power`` no matter
        how the stream was chunked.  Unfilled rows stay zero.
        """
        from ..io.native import f32_gather
        s = self._s
        flat = self._hist.reshape(-1, self._hist.shape[-1])
        rel = np.asarray(starts, np.int64) - self._base
        ext = f32_gather(flat, rel, s.window, s.halo).reshape(
            (len(starts),) + self._lead + (s.window + 2 * s.halo,))
        batch = s.batch
        out: List[Tuple[int, np.ndarray]] = []
        i = 0
        while i < len(starts):
            gid = (starts[i] // s.window) // batch
            j = i
            while j < len(starts) and (starts[j] // s.window) // batch == gid:
                j += 1
            blk = np.zeros((batch,) + ext.shape[1:], np.float32)
            rows = [(starts[k] // s.window) % batch for k in range(i, j)]
            blk[rows] = ext[i:j]
            power = s._device_power(blk)
            for row, start in zip(rows, starts[i:j]):
                stop = (min(start + s.window, self._total)
                        if tail_pad else start + s.window)
                out.append((start, power[row][..., :stop - start]))
            i = j
        self._next = starts[-1] + s.window
        self._trim()
        return out

    # ------------------------------------------------------------ API
    def push(self, chunk) -> List[Tuple[int, np.ndarray]]:
        """Feed a ``(..., k)`` chunk; return ``(start_sample,
        (..., F, window) power)`` blocks for every window whose full
        halo context arrived (possibly none, possibly several)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        self._append(chunk)
        ready: List[int] = []
        nxt = self._next
        while nxt + self.window + self.halo <= self._total:
            ready.append(nxt)
            nxt += self.window
        if not ready:
            return []
        return self._emit(ready, tail_pad=False)

    def flush(self) -> List[Tuple[int, np.ndarray]]:
        """Close the stream: process every remaining window with the
        future side zero-padded (offline edge semantics).  The final
        block may be shorter than ``window``."""
        if self._flushed:
            return []
        self._flushed = True
        if self._lead is None or self._next >= self._total:
            return []
        starts = list(range(self._next, self._total, self.window))
        return self._emit(starts, tail_pad=True)
