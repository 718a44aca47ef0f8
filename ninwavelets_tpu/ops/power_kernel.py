"""Epoch-mean power TFR as one Pallas kernel through the Triton route.

Why: the XLA path (``ops.cwt.mean_power_from_bank``) is bound by device
memory — per epoch it writes the (C, F, N) complex bank x spectrum
product, reads it into the batched iFFT, writes the coefficients and reads
them again for |.|^2, about four passes over a tensor needed once.  This
kernel keeps that tensor on the SM: device memory sees the analytic
half-spectra in and one float32 power plane out.

Layout: one block per (channel, frequency row), a loop over epochs inside
the block.  Each epoch multiplies the row of the bank into the N/2 nonzero
bins of the analytic spectrum, held as a (K1, N2) tile Z, and runs the
length-N inverse DFT as a four-step factorization N = N1 * N2
(k = N2 k1 + k2, n = n1 + N1 n2):

    x[n1 + N1 n2] = (1/N) sum_k2 W2[k2, n2] T[n1, k2] sum_k1 W1[n1, k1] Z[k1, k2]

stage 1 a (N1 x K1) @ (K1 x N2) complex product, the twiddle T
elementwise, stage 2 a (N1 x N2) @ (N2 x N2) complex product in three real
dots (the Karatsuba form), then |x|^2 summed in registers.  N2 is 64 where
N allows it; K1 = N1 / 2 >= 16 and N2 >= 16 keep every dot at or above
Triton's smallest tile, so N runs over the powers of two from 512 up to
the shared-memory limit.  The dots run at ``TF32_TF32_F32_X3`` (three TF32
passes, float32-level products): plain TF32 keeps ~3 decimal digits and
fails the 90 dB parity gate.

Served: (E, C, N) float32 epochs, a real (F, N) bank, the analytic path,
N a power of two in [MIN_N, MAX_N]; ``ops.cwt`` routes every other
workload, and every other platform, to the XLA path.  The reference
computes this pipeline as per-frequency numpy loops
(``ninwavelets/base.py:378-443``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: Epoch lengths served (powers of two).  512 is the smallest whose stage-1
#: contraction (K1 = 16) fits a Triton dot; at 8192 the block asks for
#: 320 KiB of shared memory, more than an H100 SM has (PERF.md).
MIN_N = 512
MAX_N = 4096
#: Measured on an H100 (PERF.md): 4 warps beat 8 by 25-30 % at N = 2048 and
#: by 2.3x at N = 4096; 2 pipeline stages beat 1 by ~12 % at N = 2048.
NUM_WARPS = 4
NUM_STAGES = 2


def geometry(n: int):
    """The four-step split of a length-``n`` inverse DFT: (N1, N2, K1)."""
    n2 = min(64, n // 32)
    n1 = n // n2
    return n1, n2, n1 // 2


def supports(signals_shape, signals_dtype, bank, interpolate: bool) -> bool:
    """True when the kernel serves this workload: (E, C, N) float32
    epochs, a real (F, N) float32 bank, the analytic path, N a power of
    two in [MIN_N, MAX_N]."""
    n = signals_shape[-1]
    return (bool(interpolate) and len(signals_shape) == 3
            and MIN_N <= n <= MAX_N and n & (n - 1) == 0
            and signals_dtype == jnp.float32
            and bank.ndim == 2 and bank.shape[-1] == n
            and bank.dtype == jnp.float32)


@functools.lru_cache(maxsize=None)
def _constants(n: int):
    """Host float32 DFT factors for length ``n``: W1 (N1, K1), twiddle T
    (N1, N2), and W2's real, imaginary and real+imaginary parts (N2, N2)."""
    n1, n2, k1 = geometry(n)
    a1 = np.arange(n1)
    a2 = np.arange(n2)
    w1 = np.exp(2j * np.pi * np.outer(a1, np.arange(k1)) / n1)
    tw = np.exp(2j * np.pi * np.outer(a1, a2) / n)
    w2 = np.exp(2j * np.pi * np.outer(a2, a2) / n2)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return (f32(w1.real), f32(w1.imag), f32(tw.real), f32(tw.imag),
            f32(w2.real), f32(w2.imag), f32(w2.real + w2.imag))


def _kernel(sr_ref, si_ref, bank_ref, w1r_ref, w1i_ref, tr_ref, ti_ref,
            w2r_ref, w2i_ref, w2s_ref, o_ref, *, n_epochs, scale, precision):
    c = pl.program_id(0)
    f = pl.program_id(1)
    dot = functools.partial(jnp.dot, precision=precision,
                            preferred_element_type=jnp.float32)
    bank = bank_ref[f]                                   # (K1, N2)
    w1r, w1i = w1r_ref[...], w1i_ref[...]
    tr, ti = tr_ref[...], ti_ref[...]
    w2r, w2i, w2s = w2r_ref[...], w2i_ref[...], w2s_ref[...]

    def epoch(e, acc):
        zr = sr_ref[e, c] * bank
        zi = si_ref[e, c] * bank
        ar = dot(w1r, zr) - dot(w1i, zi)                 # (N1, N2)
        ai = dot(w1r, zi) + dot(w1i, zr)
        br = ar * tr - ai * ti
        bi = ar * ti + ai * tr
        t1 = dot(br, w2r)
        t2 = dot(bi, w2i)
        t3 = dot(br + bi, w2s)
        xr = t1 - t2
        xi = t3 - t1 - t2
        return acc + xr * xr + xi * xi

    acc = lax.fori_loop(0, n_epochs, epoch, jnp.zeros(tr.shape, jnp.float32))
    # acc[n1, n2] is sample n1 + N1 * n2: its transpose is in time order.
    o_ref[c, f] = (acc * scale).T


def mean_power(signals: jnp.ndarray, bank: jnp.ndarray,
               interpret: bool = False, vma_axes=()) -> jnp.ndarray:
    """(E, C, N) float32 epochs x (F, N) real bank -> (C, F, N) epoch-mean
    power, ``ops.cwt.mean_power_from_bank(..., interpolate=True)``
    semantics, for the N that ``supports`` accepts.  ``interpret=True``
    runs the kernel in the Pallas interpreter (CPU tests; the dots then
    run at float32 "highest").  ``vma_axes``: inside ``shard_map``, the
    mesh axes the output varies over."""
    e, c, n = signals.shape
    f = bank.shape[0]
    n1, n2, k1 = geometry(n)
    spec = jnp.fft.rfft(signals)[..., :n // 2]
    sr = spec.real.reshape(e, c, k1, n2)
    si = spec.imag.reshape(e, c, k1, n2)
    bk = bank[:, :n // 2].reshape(f, k1, n2)
    consts = [jnp.asarray(x) for x in _constants(n)]
    precision = (lax.Precision.HIGHEST if interpret
                 else lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    kernel = functools.partial(_kernel, n_epochs=e,
                               scale=1.0 / (float(n) * n * e),
                               precision=precision)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(
            (c, f, n2, n1), jnp.float32,
            vma=frozenset(vma_axes) if vma_axes else None),
        grid=(c, f),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="epoch_mean_power",
    )(sr, si, bk, *consts)
    return out.reshape(c, f, n)
