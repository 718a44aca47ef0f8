"""Maximal-overlap wavelet packet transform (MODWPT) and best-basis
selection.

No reference counterpart (the reference is CWT-only); completes the
discrete subsystem (`ops/dwt.py`) with the full dyadic packet tree:
where the MODWT only ever re-splits the LOWPASS branch, the packet
transform splits every node, tiling the frequency axis into 2^j equal
bands at level j — the right tool when the interesting structure sits in
a narrow high-frequency band an octave decomposition smears out.

Same device formulation as ``ops/dwt.py``: each packet node's
transfer function is a product of a-trous-upsampled base-filter DFTs
built once on host (Percival & Walden ch. 6 — their g/h assignment rule
``n mod 4 in {0, 3} -> g`` bakes the sequency (frequency) ordering into
the tree), and a whole level is ONE ``ifft(bank * fft(x))`` pass.  Every
level is a tight frame (each split preserves ``|G|^2 + |H|^2 = 1``), so
per-level inversion is the conjugate bank, exact to round-off.

Best-basis selection (Coifman–Wickerhauser) runs on HOST over the packet
tables: the additive cost of every node is compared bottom-up and each
parent keeps either itself or its children's best cover — a
data-dependent tree prune that has no business inside a compiled
program.  The transform passes (the heavy part) stay on device.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .dwt import wavelet_filter

__all__ = ["modwpt_bank", "modwpt", "imodwpt", "best_basis",
           "best_basis_reconstruct", "node_band"]


@functools.lru_cache(maxsize=32)
def modwpt_bank(name: str, level: int, n: int):
    """(2^level, n) frequency-domain MODWPT bank for one level, as a
    float32 numpy (real, imag) pair.  Node ``b`` is FREQUENCY-ordered:
    its transfer function concentrates on ``[b, b+1] / 2^{level+1}``
    cycles/sample (P&W sequency rule).  Cached NUMPY per the jit-boundary
    rule."""
    if level < 1:
        raise ValueError("level must be >= 1")
    if 2 ** level > n:
        raise ValueError(f"level {level} needs 2^level <= N, got N={n}")
    g, h = wavelet_filter(name)
    gt, ht = g / np.sqrt(2.0), h / np.sqrt(2.0)
    k = np.arange(n)
    tw = np.exp(-2j * np.pi * np.outer(k, np.arange(g.size)) / n)
    G, H = tw @ gt, tw @ ht
    rows = [np.ones(n, np.complex128)]
    for j in range(1, level + 1):
        nxt = []
        for b in range(2 ** j):
            base = G if b % 4 in (0, 3) else H        # sequency ordering
            nxt.append(rows[b // 2] * base[(2 ** (j - 1) * k) % n])
        rows = nxt
    bank = np.stack(rows)
    return (np.ascontiguousarray(bank.real, np.float32),
            np.ascontiguousarray(bank.imag, np.float32))


@functools.partial(jax.jit, static_argnames=("inverse",))
def _apply(x, br, bi, *, inverse: bool):
    bank = jax.lax.complex(br, bi)
    spec = jnp.fft.fft(x.astype(jnp.complex64))
    if not inverse:
        w = jnp.fft.ifft(spec[..., None, :] * bank)
        return jnp.real(w).astype(jnp.float32)
    acc = jnp.sum(jnp.conj(bank) * spec, axis=-2)
    return jnp.real(jnp.fft.ifft(acc)).astype(jnp.float32)


def modwpt(x, wavelet: str = "db4", level: int = 3):
    """Level-``level`` MODWPT packet table: (..., N) ->
    (..., 2^level, N) float32.  Row ``b`` carries the band
    ``[b, b+1] / 2^{level+1}`` cycles/sample; rows are shift-invariant
    and the table preserves energy (tight frame)."""
    x = jnp.asarray(x, jnp.float32)
    br, bi = modwpt_bank(wavelet, int(level), x.shape[-1])
    return _apply(x, jnp.asarray(br), jnp.asarray(bi), inverse=False)


def imodwpt(w, wavelet: str = "db4"):
    """Exact inverse of ``modwpt``: (..., 2^level, N) -> (..., N)."""
    w = jnp.asarray(w, jnp.float32)
    level = int(np.log2(w.shape[-2]))
    if 2 ** level != w.shape[-2]:
        raise ValueError(f"packet axis must be 2^level, got {w.shape[-2]}")
    br, bi = modwpt_bank(wavelet, level, w.shape[-1])
    return _apply(w, jnp.asarray(br), jnp.asarray(bi), inverse=True)


def node_band(level: int, b: int):
    """Frequency band (lo, hi) in cycles/sample covered by packet node
    ``(level, b)`` under the sequency ordering."""
    return b / 2.0 ** (level + 1), (b + 1) / 2.0 ** (level + 1)


def _cost(c: np.ndarray, kind: str) -> float:
    """Additive node cost over coefficients ``c`` (flattened)."""
    e = float(np.sum(c * c))
    if kind == "energy_log":
        v = c[c != 0.0]
        return float(np.sum(np.log(v * v))) if v.size else 0.0
    if kind == "shannon":
        # -sum p log p against the NODE energy is not additive across a
        # split; the standard CW functional uses -sum c^2 log c^2.
        v = c[c != 0.0].astype(np.float64)
        v2 = v * v
        return float(-np.sum(v2 * np.log(v2)))
    if kind == "threshold":
        return float(np.count_nonzero(np.abs(c) > 1.0))
    raise ValueError(f"cost must be 'shannon', 'energy_log' or "
                     f"'threshold', got {kind!r}")


def best_basis(x, wavelet: str = "db4", max_level: int = 4,
               cost: str = "shannon"):
    """Coifman–Wickerhauser best basis over the MODWPT tree.

    Computes the packet tables for levels 1..``max_level`` (device), then
    prunes bottom-up on host: a parent node is kept when its additive
    ``cost`` does not exceed its children's combined best cover.

    Returns ``(nodes, coeffs)``: ``nodes`` is a list of ``(level, b)``
    pairs whose bands tile ``[0, 1/2)`` cycles/sample exactly, and
    ``coeffs`` maps each node to its (..., N) float32 coefficient array.
    ``best_basis_reconstruct`` inverts the selection.

    Costs: ``"shannon"`` (the CW ``-sum c^2 log c^2`` functional,
    default), ``"energy_log"``, ``"threshold"`` (count above 1 — scale
    the signal accordingly).
    """
    x = jnp.asarray(x, jnp.float32)
    tables = {j: np.asarray(modwpt(x, wavelet, j))
              for j in range(1, int(max_level) + 1)}
    tables[0] = np.asarray(x)[..., None, :]

    best_cost: dict = {}
    best_cover: dict = {}
    for j in range(int(max_level), -1, -1):
        for b in range(2 ** j):
            # Emulate the DECIMATED node this redundant node stands for:
            # its N/2^j orthonormal coefficients are a subsample of the
            # MODWPT row scaled by 2^{j/2}, so score the scaled row and
            # weight by 2^{-j} (the subsampling fraction).  Without both
            # factors the additive costs are level-degenerate (children
            # double-count) and the prune collapses to the root.
            c = _cost(2.0 ** (j / 2.0)
                      * np.ravel(tables[j][..., b, :]), cost)
            c = c / 2.0 ** j
            if j == int(max_level):
                best_cost[(j, b)] = c
                best_cover[(j, b)] = [(j, b)]
            else:
                child = (best_cost[(j + 1, 2 * b)]
                         + best_cost[(j + 1, 2 * b + 1)])
                if c <= child:
                    best_cost[(j, b)] = c
                    best_cover[(j, b)] = [(j, b)]
                else:
                    best_cost[(j, b)] = child
                    best_cover[(j, b)] = (best_cover[(j + 1, 2 * b)]
                                          + best_cover[(j + 1, 2 * b + 1)])
    nodes = sorted(best_cover[(0, 0)],
                   key=lambda jb: node_band(jb[0], jb[1])[0])
    coeffs = {jb: tables[jb[0]][..., jb[1], :] for jb in nodes}
    return nodes, coeffs


def best_basis_reconstruct(nodes, coeffs, wavelet: str = "db4",
                           keep=None):
    """Invert a ``best_basis`` selection: synthesize each node through its
    conjugate transfer and sum.  ``keep``: optional subset of nodes to
    reconstruct from (band-selective filtering — drop the rest).

    A degenerate selection ``[(0, 0)]`` returns the signal itself.
    """
    keep = set(nodes if keep is None else keep)
    out = None
    for (j, b) in nodes:
        if (j, b) not in keep:
            continue
        c = jnp.asarray(coeffs[(j, b)], jnp.float32)
        if j == 0:
            part = c
        else:
            br, bi = modwpt_bank(wavelet, j, c.shape[-1])
            spec = jnp.fft.fft(c.astype(jnp.complex64))
            tr = jax.lax.complex(jnp.asarray(br[b]), jnp.asarray(bi[b]))
            part = jnp.real(jnp.fft.ifft(jnp.conj(tr) * spec)).astype(
                jnp.float32)
        out = part if out is None else out + part
    if out is None:
        raise ValueError("keep selects no nodes")
    return out
