"""Sequence-parallel CWT for long recordings: chunked overlap-save
convolution with ``ppermute`` halo exchange over the time axis.

The reference FFTs the whole signal in one shot (``/root/reference/
ninwavelets/base.py:399``) — a 10-minute 1 kHz recording is a single 600k-
point FFT on one device, and its only long-signal story is "cupy is faster
for long waves" (``README.md:461-465``).  Here the time axis is sharded over
the mesh's ``time`` axis and each device convolves its own chunk:

1. every device holds a contiguous chunk of L = N / n_time samples;
2. each device fetches ``halo`` samples from both neighbors with two
   ``lax.ppermute`` shifts (edge devices get zeros — i.e. the global
   boundary is zero-padded, *linear* convolution, where the reference's
   whole-signal FFT is circular; interiors match to float32 for any wavelet
   whose time support fits in the halo);
3. the device runs the ordinary FFT x bank x iFFT on its extended
   (L + 2*halo)-sample chunk against a bank synthesized at that length —
   the bank grid maps bin i to physical frequency i * sfreq / n for any n
   (``ops.grids.fft_bin_freqs``), so the *same continuous transfer function*
   is sampled at chunk resolution;
4. the central L samples of the result are kept; outputs stay sharded over
   time (the (F, N) plane is never resident on one device).

Halo sizing: the wavelet family's time support at the *lowest* analysis
frequency (Morse/Morlet have infinite support; ``halo_samples`` truncates at
a relative-envelope tolerance, per SURVEY §7.3).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.bank import WaveletDef, make_fft_bank_ri
from ..ops.cwt import _as_bank
from ..ops.grids import analytic_mask, fft_bin_freqs
from .mesh import TIME_AXIS


@partial(jax.jit, static_argnames=("wdef",))
def _probe_spectrum(wdef: WaveletDef, grid, freq):
    """(real, imag) of ``trans_formula`` on the probe grid, compiled once
    per (wavelet, probe length)."""
    spec = jnp.asarray(wdef.trans_formula(grid, freq))
    if jnp.iscomplexobj(spec):
        return spec.real, spec.imag
    return spec, jnp.zeros_like(spec)


def halo_samples(wdef: WaveletDef, min_freq: float, sfreq: float,
                 tol: float = 1e-4,
                 probe_seconds: Optional[float] = None) -> int:
    """Time-domain support (in samples) of the slowest analysis wavelet.

    Synthesizes the wavelet at ``min_freq`` by evaluating its frequency-
    domain formula on a long probe grid and inverse-FFTing on the host
    (float64), then returns the one-sided distance from the envelope peak at
    which the envelope has decayed below ``tol * max`` — the halo width that
    makes chunked == whole-signal at float32 in the interior.

    Only Reverse/Both-mode families make sense here (time-parallel long
    recordings with Normal-mode Haar/MexicanHat banks inherit the reference's
    Twice-mode quirks and are not supported for chunking).
    """
    from ..ops.bank import WaveletMode
    if wdef.mode not in (WaveletMode.Reverse, WaveletMode.Both):
        # Class-derived wdefs always carry a trans_formula (the base class
        # supplies an identity default), so gate on the MODE: only
        # frequency-domain families have a meaningful spectrum to probe.
        raise ValueError(
            f"halo_samples needs a Reverse/Both-mode wavelet (got "
            f"{wdef.mode}); Normal/Twice families are not supported for "
            "time-chunked processing")
    if probe_seconds is None:
        # Generous probe: >= 16 cycles of the slowest wavelet, >= 2 s.
        probe_seconds = max(16.0 / min_freq, 2.0)
    n = int(2 ** np.ceil(np.log2(sfreq * probe_seconds)))
    grid = np.asarray(fft_bin_freqs(n, sfreq, dtype=jnp.float32),
                      dtype=np.float64)
    # One jitted program with float boundaries: eager jnp formula
    # evaluation would dispatch (and compile) one op at a time.
    sr, si = _probe_spectrum(wdef, jnp.asarray(grid, jnp.float32),
                             jnp.float32(min_freq))
    spec = np.asarray(sr, np.float64) + 1j * np.asarray(si, np.float64)
    w = np.fft.ifft(spec)
    env = np.abs(w)
    peak = env.max()
    if peak == 0.0:
        return 1
    # The wavelet is centered at sample 0 with tails wrapping at both ends;
    # measure circular distance from 0 of the farthest sample above tol.
    above = np.nonzero(env > tol * peak)[0]
    dist = np.minimum(above, n - above)
    return int(dist.max()) + 1


def pow2_halo(window: int, min_halo: int) -> int:
    """Smallest halo >= ``min_halo`` making ``window + 2*halo`` a power of
    two, the FFT's fastest length (non-power-of-two lengths take slower
    mixed-radix or Bluestein plans).
    """
    if window % 2:
        raise ValueError("window length must be even")
    ext = 1 << int(np.ceil(np.log2(window + 2 * min_halo)))
    return (ext - window) // 2


def chunk_bank(wdef: WaveletDef, freqs, chunk_len: int, halo: int,
               sfreq: float, interpolate: bool = False):
    """(F, chunk_len + 2*halo) bank for the extended chunks, as a float
    (real, imag-or-None) pair ready for ``chunked_*`` below.

    Built through the jitted float-boundary ``make_fft_bank_ri`` (the
    package's float-pair convention, see ``ops.cwt``)."""
    return make_fft_bank_ri(wdef, jnp.asarray(freqs, jnp.float32),
                            chunk_len + 2 * halo, sfreq, interpolate)


def _exchange_halos(sig: jnp.ndarray, halo: int, n_dev: int) -> jnp.ndarray:
    """Extend the local chunk with ``halo`` samples from each neighbor over
    the ``time`` mesh axis (zeros at the global edges — ppermute leaves
    unaddressed outputs zero)."""
    to_right = [(i, i + 1) for i in range(n_dev - 1)]
    to_left = [(i + 1, i) for i in range(n_dev - 1)]
    left_halo = lax.ppermute(sig[..., -halo:], TIME_AXIS, to_right)
    right_halo = lax.ppermute(sig[..., :halo], TIME_AXIS, to_left)
    return jnp.concatenate([left_halo, sig, right_halo], axis=-1)


def _local_cwt(sig, bank, halo: int, interpolate: bool, n_dev: int):
    ext = _exchange_halos(sig, halo, n_dev)
    spec = jnp.fft.fft(ext.astype(jnp.complex64))
    if interpolate:
        spec = spec * analytic_mask(ext.shape[-1], jnp.float32)
    c = jnp.fft.ifft(spec[..., None, :] * bank)
    return c[..., halo:c.shape[-1] - halo]


def _chunk_call(mesh, signal_r, bank_r, bank_i, halo, interpolate, epilogue,
                n_outs: int = 1):
    n_dev = mesh.shape[TIME_AXIS]
    ndim = signal_r.ndim
    sig_spec = P(*([None] * (ndim - 1)), TIME_AXIS)
    out_spec = P(*([None] * (ndim - 1)), None, TIME_AXIS)
    if n_outs > 1:
        out_spec = (out_spec,) * n_outs

    def local(sig, br, bi):
        c = _local_cwt(sig, _as_bank(br, bi), halo, interpolate, n_dev)
        return epilogue(c)

    if bank_i is None:
        fn = lambda sig, br: local(sig, br, None)
        return jax.shard_map(
            fn, mesh=mesh, in_specs=(sig_spec, P(None, None)),
            out_specs=out_spec)(signal_r, bank_r)
    return jax.shard_map(
        local, mesh=mesh, in_specs=(sig_spec, P(None, None), P(None, None)),
        out_specs=out_spec)(signal_r, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "halo", "interpolate"))
def chunked_power(signal_r, bank_r, bank_i=None, *, mesh: Mesh, halo: int,
                  interpolate: bool = False):
    """Sequence-parallel ``|cwt|**2``: (..., N) -> (..., F, N) float32, time
    axis sharded over the mesh ``time`` axis.  ``bank_r/bank_i`` must be the
    extended-chunk bank from ``chunk_bank`` (last dim = N/n_time + 2*halo).
    """
    return _chunk_call(mesh, signal_r, bank_r, bank_i, halo, interpolate,
                       lambda c: jnp.square(c.real) + jnp.square(c.imag))


@partial(jax.jit, static_argnames=("mesh", "halo", "interpolate"))
def chunked_abs(signal_r, bank_r, bank_i=None, *, mesh: Mesh, halo: int,
                interpolate: bool = False):
    """Sequence-parallel ``|cwt|``."""
    return _chunk_call(mesh, signal_r, bank_r, bank_i, halo, interpolate,
                       jnp.abs)


@partial(jax.jit, static_argnames=("mesh", "halo", "interpolate"))
def chunked_cwt_ri(signal_r, bank_r, bank_i=None, *, mesh: Mesh, halo: int,
                   interpolate: bool = False):
    """Sequence-parallel raw coefficients as a (real, imag) float pair."""
    return _chunk_call(mesh, signal_r, bank_r, bank_i, halo, interpolate,
                       lambda c: (c.real, c.imag), n_outs=2)
