"""Window sources + prefetching batch iterator for streamed analysis.

A *source* abstracts "something a halo-padded window batch can be cut
from": an in-memory array (:class:`ArraySource`) or an EDF file on disk
(:class:`EDFSource`).  ``iter_ext_batches`` turns a source into the
``(batch_starts, ext)`` groups :class:`parallel.streaming.StreamingCWT`
consumes, double-buffered: while the device chews on batch *i*, a
worker thread gathers batch *i+1* (the native gather kernels release
the GIL for the whole call, so the overlap is real parallelism, not
time-slicing).

Geometry contract (shared with ``StreamingCWT._ext_batches``): batch
row ``w`` covers samples ``[starts[w]-halo, starts[w]+window+halo)``
zero-padded outside ``[0, n_samples)``; a ragged final group keeps the
full batch shape with all-zero unused rows (a second compiled program
for one partial batch would cost a second compile).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from . import native

__all__ = ["ArraySource", "EDFSource", "iter_ext_batches"]


class ArraySource:
    """Source over an in-memory ``(..., N)`` float array (any leading
    channel dims ride along, matching ``StreamingCWT``'s batching)."""

    def __init__(self, signal: np.ndarray) -> None:
        self.signal = np.ascontiguousarray(signal, np.float32)
        self.lead = self.signal.shape[:-1]
        self.n_samples = int(self.signal.shape[-1])

    def gather(self, starts: Sequence[int], window: int,
               halo: int) -> np.ndarray:
        flat = self.signal.reshape(-1, self.n_samples)
        out = native.f32_gather(flat, starts, window, halo)
        return out.reshape((len(starts),) + self.lead + (out.shape[-1],))


class EDFSource:
    """Source over an EDF file: windows are gathered straight off the
    mmap per batch — the recording is never materialized in host
    memory (SURVEY §7.3)."""

    def __init__(self, reader, picks: Optional[Sequence] = None) -> None:
        # reader: EDFReader, EDFPick, or a path
        if isinstance(reader, (str, bytes)) or hasattr(reader, "__fspath__"):
            from .edf import EDFReader
            reader = EDFReader(reader)
        self.reader = reader
        self._picks = picks
        if picks is not None and not hasattr(reader, "pick"):
            raise ValueError(
                f"{type(reader).__name__} cannot re-pick channels; pass "
                "picks to EDFReader.pick()/EDFSource(EDFReader(...)) "
                "instead of wrapping an already-picked view")
        if picks is not None:
            src = reader.pick(picks)
            self.sfreq = float(src.sfreq)
            self.n_samples = int(src.n_samples)
            self.lead = (len(src.ch_names),)
            self._gather = src.gather
        else:
            self.sfreq = float(reader.sfreq)
            self.n_samples = int(reader.n_samples)
            self.lead = (len(reader.ch_names),)
            self._gather = reader.gather

    def gather(self, starts: Sequence[int], window: int,
               halo: int) -> np.ndarray:
        return self._gather(starts, window, halo)


def iter_ext_batches(source, window: int, halo: int, batch: int,
                     prefetch: bool = True,
                     ) -> Iterator[Tuple[list, np.ndarray]]:
    """Yield ``(batch_starts, (batch,) + lead + (window+2*halo,) ext)``
    groups covering ``[0, source.n_samples)`` in ``window`` steps.

    With ``prefetch`` (default), group ``i+1`` is gathered on a worker
    thread while group ``i`` is consumed — IO/gather time hides behind
    the consumer's device work.
    """
    n = int(source.n_samples)
    lead = tuple(source.lead)
    ext_len = window + 2 * halo
    starts = list(range(0, n, window))
    groups = [starts[g:g + batch] for g in range(0, len(starts), batch)]

    def make(group: list) -> np.ndarray:
        got = source.gather(group, window, halo)
        if len(group) == batch:
            return np.ascontiguousarray(got, np.float32)
        ext = np.zeros((batch,) + lead + (ext_len,), np.float32)
        ext[:len(group)] = got
        return ext

    if not prefetch or len(groups) <= 1:
        for group in groups:
            yield group, make(group)
        return

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(make, groups[0])
        for i, group in enumerate(groups):
            ext = fut.result()
            if i + 1 < len(groups):
                fut = pool.submit(make, groups[i + 1])
            yield group, ext
