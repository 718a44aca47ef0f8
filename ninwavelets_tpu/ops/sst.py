"""Synchrosqueezed CWT: frequency-reassigned scalograms.

No reference counterpart — synchrosqueezing (Daubechies, Lu & Wu 2011) is
the standard modern sharpening of the CWT: each (f, t) cell's energy is
moved to the analysis row nearest its INSTANTANEOUS frequency

    omega(f, t) = Im[ dW/dt / W ] / (2 pi),

collapsing the wavelet's frequency smear onto the true ridge.  The time
derivative costs one extra bank multiply (the spectrum times ``i 2 pi
nu``), so the whole transform is two CWTs plus an elementwise phase
transform and a reassignment pass — all inside one jitted program.

The reassignment avoids XLA scatter-add and ``jnp.searchsorted``: it
counts bin edges below omega (a left-bisect, or its closed form on a
regular grid) and accumulates row-wise selects — exact f32, every step a
dense elementwise pass.  Which of scatter and select-reduce is faster on a
given device is an open measurement (ROADMAP S5).  Works for any monotone
analysis-frequency grid.
Boundaries are float-only as everywhere in this package (complex exists
only inside the program).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .cwt import analytic_spectrum

__all__ = ["ssq_power_from_bank", "ssq_power", "ssq_mean_power_from_bank",
           "ssq_mean_power", "uniform_grid_hint"]


def _bin_nu(n: int, sfreq: float) -> jnp.ndarray:
    """Signed physical frequency of each FFT bin (Hz): k*sfreq/n for the
    lower half, negative mirror for the upper half."""
    k = jnp.arange(n)
    return jnp.where(k < (n + 1) // 2, k, k - n) * (sfreq / n)


def uniform_grid_hint(freqs):
    """Closed-form row-mapping hint for (piecewise-)regular grids, else None.

    The edge-count scan that maps instantaneous frequencies to target
    rows re-reads the whole omega plane once per edge block; for regular
    grids the left-bisect count collapses to one closed form:

    * arithmetic (uniform) grids -> ``("lin", edges0, df)``:
      ``idx = ceil((omega - edges0) / df)``
    * geometric (log-spaced, the standard wavelet spacing) grids ->
      ``("log", log(edges0), log(ratio))``: the midpoint edges
      ``e_k = f0 r^k (1+r)/2`` are uniform in log, so
      ``idx = ceil((log omega - log e0) / log r)`` (omega <= 0 maps to
      row 0 — it is below every edge).
    * PIECEWISE-regular grids (e.g. two concatenated linear ranges at
      different resolutions, or a log sweep joined to a linear tail) ->
      ``("pw", ((kind, p0, step, m), ...))``: the row edges are greedily
      split into maximal arithmetic/geometric runs and the per-segment
      closed-form counts (each clipped to its run length ``m``) SUM to
      the global left-bisect count — S elementwise passes over the omega
      plane instead of ``ceil(F/8)`` scan steps.  Only returned when
      that is a strict win (``8*S < n_edges``); truly irregular grids
      fall back to the blocked scan (``None``).

    Detected on HOST frequencies by the public wrappers and threaded down
    as a STATIC hint (a traced grid cannot be inspected); ascending only
    (a constant/descending grid would break the bisect direction).
    """
    f = np.asarray(freqs, np.float64)
    if f.size < 2 or f[0] <= 0 or np.any(np.diff(f) <= 0):
        return None
    d = np.diff(f)
    if np.allclose(d, d[0], rtol=1e-6, atol=0.0):
        return ("lin", float((f[0] + f[1]) / 2.0), float(d[0]))
    r = f[1:] / f[:-1]
    if r[0] > 1 and np.allclose(r, r[0], rtol=1e-6, atol=0.0):
        e0 = f[0] * (1.0 + r[0]) / 2.0
        return ("log", float(np.log(e0)), float(np.log(r[0])))
    edges = 0.5 * (f[1:] + f[:-1])
    segs = _edge_segments(edges)
    if segs is not None and 8 * len(segs) < edges.size:
        return ("pw", segs)
    return None


def _edge_segments(edges: np.ndarray, rtol: float = 1e-6):
    """Greedy maximal arithmetic/geometric runs over the (ascending) row
    edges, as ``((kind, p0, step, m), ...)`` with ``p0``/``step`` in log
    space for geometric runs.  At each position the longer of the two run
    types wins (ties -> arithmetic: cheaper on device, no log)."""
    m = edges.size
    segs = []
    i = 0
    while i < m:
        if i == m - 1:
            segs.append(("lin", float(edges[i]), 1.0, 1))
            break
        d = edges[i + 1] - edges[i]
        j_lin = i + 1
        while (j_lin + 1 < m
               and abs(edges[j_lin + 1] - edges[j_lin] - d) <= rtol * d):
            j_lin += 1
        j_log = i
        ratio = edges[i + 1] / edges[i]
        if edges[i] > 0 and ratio > 1:
            j_log = i + 1
            while (j_log + 1 < m
                   and abs(edges[j_log + 1] / edges[j_log] - ratio)
                   <= rtol * ratio):
                j_log += 1
        if j_log > j_lin:
            segs.append(("log", float(np.log(edges[i])),
                         float(np.log(ratio)), j_log - i + 1))
            i = j_log + 1
        else:
            segs.append(("lin", float(edges[i]), float(d), j_lin - i + 1))
            i = j_lin + 1
    assert sum(s[3] for s in segs) == m
    return tuple(segs)


def _reassigned_power(signal, bank, f_grid, sfreq: float, interpolate: bool,
                      rel_threshold: float, row_offset: int = 0,
                      n_rows_out: int | None = None,
                      freq_axis: str | None = None,
                      vma_axes=(), uniform_grid=None) -> jnp.ndarray:
    """Core reassignment: (..., N) x (F_local, N) -> (..., F_out, N).

    ``bank`` may be a SLICE of the full bank (rows [row_offset,
    row_offset + F_local) of the grid ``f_grid``); the scatter targets the
    full ``n_rows_out`` rows regardless — that is what makes the sharded
    variant work: each frequency shard reassigns its own source rows into
    a full-height partial plane and a ``psum`` over ``freq_axis``
    completes it.  When ``freq_axis`` is set the noise-gate floor is
    ``pmax``-reduced so every shard gates against the GLOBAL power peak.
    """
    n = signal.shape[-1]
    n_f_local = bank.shape[0]
    n_out = int(n_rows_out) if n_rows_out is not None else n_f_local

    spec = analytic_spectrum(signal, interpolate)
    w = jnp.fft.ifft(spec[..., None, :] * bank)
    dw = jnp.fft.ifft(spec[..., None, :]
                      * (bank * (1j * 2.0 * jnp.pi
                                 * _bin_nu(n, sfreq))))
    power = jnp.square(w.real) + jnp.square(w.imag)

    # omega = Im(dW / W) / 2pi, computed as Im(dW * conj(W)) / (2pi |W|^2)
    # to keep the division real and guarded.
    num = dw.imag * w.real - dw.real * w.imag
    omega = num / (2.0 * jnp.pi * jnp.maximum(power, 1e-30))

    # Row edges: midpoints of the monotone analysis grid map each
    # instantaneous frequency to its nearest row.  Counting edges below
    # omega under a scan is the same left-bisect result as
    # jnp.searchsorted (bitwise-identical), as one dense compare per edge.
    n_edges = f_grid.shape[0] - 1
    if uniform_grid is not None:
        # Regular grid: the left-bisect count has a closed form (same
        # result as the scan up to float rounding AT an edge — measure
        # zero for real data).
        if uniform_grid[0] == "pw":
            # Piecewise-regular grid: the global count is the sum of the
            # per-segment closed forms, each clipped to its run length.
            cnt = jnp.zeros(omega.shape, jnp.float32)
            logw = None
            for seg_kind, p0, step, m in uniform_grid[1]:
                if seg_kind == "log":
                    if logw is None:
                        logw = jnp.log(jnp.maximum(omega, 1e-30))
                    c = jnp.where(omega > 0.0,
                                  jnp.ceil((logw - p0) / step), 0.0)
                else:
                    c = jnp.ceil((omega - p0) / step)
                cnt = cnt + jnp.clip(c, 0.0, float(m))
        else:
            kind, e0, step = uniform_grid
            if kind == "log":
                # log of a nonpositive omega is undefined; those cells are
                # below every (positive) edge -> row 0.
                safe = jnp.log(jnp.maximum(omega, 1e-30))
                cnt = jnp.where(omega > 0.0,
                                jnp.ceil((safe - e0) / step), 0.0)
            else:
                cnt = jnp.ceil((omega - e0) / step)
        idx = jnp.clip(cnt, 0, n_edges).astype(jnp.int32)
    else:
        # Block K edges per scan step: one read of the omega plane serves
        # K compares (the scan is bound by re-reading the plane).
        k_blk = 8
        pad_e = (-n_edges) % k_blk
        edges = 0.5 * (f_grid[1:] + f_grid[:-1])
        if pad_e:
            edges = jnp.concatenate([edges, jnp.full((pad_e,), jnp.inf,
                                                     f_grid.dtype)])
        edge_blocks = edges.reshape(-1, k_blk)
        zero_i = jnp.zeros(omega.shape, jnp.int32)
        if vma_axes:
            # Inside shard_map the scan body output varies over the mesh
            # axes; the zero init must carry the same varying-axes type.
            zero_i = lax.pcast(zero_i, tuple(vma_axes), to="varying")

        def count_block(acc, eb):
            for k in range(k_blk):
                acc = acc + (omega > eb[k]).astype(jnp.int32)
            return acc, None

        idx, _ = lax.scan(count_block, zero_i, edge_blocks)

    # Noise gate: keep weak cells where they are (their phase is noise).
    floor = rel_threshold * jnp.max(power, axis=(-2, -1), keepdims=True)
    if freq_axis is not None:
        floor = lax.pmax(floor, freq_axis)
    keep = power >= floor
    src = jnp.broadcast_to(row_offset + jnp.arange(n_f_local)[:, None],
                           omega.shape)
    idx = jnp.where(keep, idx, src)

    # Reassignment "scatter" as a row-wise compare-accumulate: for every
    # OUTPUT row o, sum the sources whose target index equals o — a dense
    # select+reduce (exact f32, same values as a scatter-add up to
    # summation order).  The scan keeps the (F_out, F_local, N) one-hot
    # implicit.
    lead = power.shape[:-2]
    p_flat = power.reshape((-1,) + power.shape[-2:])
    i_flat = idx.reshape(p_flat.shape)

    # K output rows per scan step: one read of the (idx, p) planes serves
    # K selects+reduces (the scan is bound by re-reading the plane, not
    # by the selects).
    k_blk = 8
    n_out_pad = -(-n_out // k_blk) * k_blk

    def out_block(o0, _):
        rows = jnp.stack([
            jnp.sum(jnp.where(i_flat == o0 + k, p_flat, 0.0), axis=-2)
            for k in range(k_blk)])
        return o0 + k_blk, rows

    _, blocks = lax.scan(out_block, 0, None, length=n_out_pad // k_blk)
    rows = blocks.reshape((n_out_pad,) + p_flat.shape[:-2]
                          + (n,))[:n_out]                # (F_out, B, N)
    out = jnp.moveaxis(rows, 0, -2)
    return out.reshape(lead + (n_out, n))


def ssq_power_from_bank(signal: jnp.ndarray, bank: jnp.ndarray, freqs,
                        sfreq: float, interpolate: bool = True,
                        rel_threshold: float = 1e-6,
                        uniform_grid=None) -> jnp.ndarray:
    """Synchrosqueezed power: (..., N) -> (..., F, N) with the energy of
    each scalogram cell reassigned to the analysis row nearest its
    instantaneous frequency.

    Args:
      signal: (..., N) real.
      bank: (F, N) frequency-domain bank (real — analytic families).
      freqs: the F analysis frequencies (Hz), monotone increasing; both
        the source rows and the reassignment target grid.
      rel_threshold: cells with power below ``rel_threshold * max power``
        (per leading batch element) keep their energy IN PLACE rather than
        trusting a noise-dominated phase estimate.

    Returns:
      (..., F, N) float32; total energy equals the plain scalogram's
      (reassignment only moves energy between rows).
    """
    f_grid = jnp.asarray(freqs, jnp.float32)
    return _reassigned_power(signal, bank, f_grid, sfreq, interpolate,
                             rel_threshold, uniform_grid=uniform_grid)


def ssq_mean_power_from_bank(signals: jnp.ndarray, bank: jnp.ndarray, freqs,
                             sfreq: float, interpolate: bool = True,
                             rel_threshold: float = 1e-6,
                             vma_axes=(), uniform_grid=None) -> jnp.ndarray:
    """Epoch-mean synchrosqueezed power: (E, ..., N) -> (..., F, N).

    The epochs analog of ``ops.cwt.mean_power`` for the reassigned
    scalogram (reference epochs semantics: ``mneutils.py:42-55``, with the
    per-epoch TFR replaced by its synchrosqueezed counterpart).  Epochs
    are streamed through a ``lax.scan`` so memory stays O(C*F*N)
    independent of E — the per-epoch complex CWT + derivative planes never
    coexist.  The noise gate is applied PER EPOCH (each epoch's floor is
    relative to its own peak), matching ``mean of ssq_power`` exactly.
    """
    f_grid = jnp.asarray(freqs, jnp.float32)
    e = signals.shape[0]
    # Stream epoch CHUNKS, not single epochs: the scan exists only to
    # bound memory (the w/dw complex planes are ~210 MB per epoch at the
    # bench config), and one-epoch steps leave the device latency-bound
    # on many small sequential reassignments.  The noise-gate floor is per
    # (epoch, channel) (axis (-2,-1) reduce), so chunking is exact; the
    # zero-padded tail epochs contribute only power-0 cells to the sum.
    block = min(int(e), _epoch_block(signals.shape, bank.shape[0]))
    pad = (-e) % block
    if pad:
        signals = jnp.concatenate(
            [signals, jnp.zeros((pad,) + signals.shape[1:],
                                signals.dtype)], axis=0)
    chunks = signals.reshape((signals.shape[0] // block, block)
                             + signals.shape[1:])
    zero = jnp.zeros(signals.shape[1:-1] + (bank.shape[0],
                                            signals.shape[-1]), jnp.float32)
    if vma_axes:
        zero = lax.pcast(zero, tuple(vma_axes), to="varying")

    def step(acc, sig):
        # vma_axes forwarded: the edge-count scan inside _reassigned_power
        # zero-inits its own carry, which must match shard_map's
        # varying-axes type too.
        part = _reassigned_power(sig, bank, f_grid, sfreq, interpolate,
                                 rel_threshold, vma_axes=vma_axes,
                                 uniform_grid=uniform_grid)
        return acc + jnp.sum(part, axis=0), None

    total = lax.scan(step, zero, chunks)[0]
    return total / e


def _epoch_block(signals_shape, n_rows, budget_bytes=2 << 30) -> int:
    """Epochs per scan step such that the two complex CWT planes of a
    step stay under ``budget_bytes`` (~2 GB — leaves room for the
    power/omega/count planes XLA materializes alongside)."""
    inner = 1
    for s in signals_shape[1:-1]:
        inner *= int(s)
    per_epoch = 2 * 8 * inner * int(n_rows) * int(signals_shape[-1])
    return max(1, budget_bytes // max(per_epoch, 1))


@partial(jax.jit, static_argnames=("sfreq", "interpolate", "rel_threshold",
                                   "uniform_grid"))
def _ssq_jit(signal_r, bank_r, f_grid, *, sfreq, interpolate, rel_threshold,
             uniform_grid):
    return ssq_power_from_bank(signal_r, bank_r, f_grid, sfreq, interpolate,
                               rel_threshold, uniform_grid)


def ssq_power(signal_r, bank_r, freqs, sfreq: float,
              interpolate: bool = True, rel_threshold: float = 1e-6):
    """Jitted float-boundary wrapper for ``ssq_power_from_bank`` (the
    uniform-grid closed-form row mapping is detected here, on host
    frequencies)."""
    freqs = np.asarray(freqs, np.float32)
    return _ssq_jit(signal_r, bank_r, jnp.asarray(freqs),
                    sfreq=float(sfreq), interpolate=interpolate,
                    rel_threshold=float(rel_threshold),
                    uniform_grid=uniform_grid_hint(freqs))


@partial(jax.jit, static_argnames=("sfreq", "interpolate", "rel_threshold",
                                   "uniform_grid"))
def _ssq_mean_jit(signals_r, bank_r, f_grid, *, sfreq, interpolate,
                  rel_threshold, uniform_grid):
    return ssq_mean_power_from_bank(signals_r, bank_r, f_grid, sfreq,
                                    interpolate, rel_threshold,
                                    uniform_grid=uniform_grid)


def ssq_mean_power(signals_r, bank_r, freqs, sfreq: float,
                   interpolate: bool = True, rel_threshold: float = 1e-6):
    """Jitted float-boundary wrapper for ``ssq_mean_power_from_bank``
    (uniform-grid mapping detected on host frequencies)."""
    freqs = np.asarray(freqs, np.float32)
    hint = uniform_grid_hint(freqs)
    signals_r = jnp.asarray(signals_r, jnp.float32)
    bank_arr = jnp.asarray(bank_r)
    return _ssq_mean_jit(signals_r, bank_arr, jnp.asarray(freqs),
                         sfreq=float(sfreq), interpolate=interpolate,
                         rel_threshold=float(rel_threshold),
                         uniform_grid=hint)
