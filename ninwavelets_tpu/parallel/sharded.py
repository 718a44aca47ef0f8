"""Sharded batch transforms: the EpochsWavelet reductions scaled over a mesh.

The reference computes its epochs TFRs with a per-epoch Python loop on one
host (``/root/reference/ninwavelets/mneutils.py:26-71``).  Here the same math
runs under ``shard_map`` over a (data, freq) mesh:

* the (E, C, N) epochs block is sharded over ``data`` on the epoch axis,
* the (F, N) bank is sharded over ``freq`` — each device holds (and can
  synthesize) only its own frequency slice,
* the epoch-mean power and inter-trial coherence reductions finish with one
  ``pmean`` over ``data`` (the only cross-device traffic; the frequency axis
  needs no collective at all),
* outputs stay sharded over ``freq`` so the (C, F, N) TFR plane never has to
  be resident on one device; gathering happens only if the caller fetches the
  array to host.

Program boundaries are float-only (real/imag pairs), as everywhere in the
package (see ``ops.cwt``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.cwt import (_as_bank, _as_signal, _kernel_or_xla_mean_power,
                       _scan_mean, cwt_from_bank)
from .mesh import DATA_AXIS, FREQ_AXIS

_BANK_SPEC = P(FREQ_AXIS, None)


def _shard_call(mesh, local, sig_spec, out_specs, signals_r, bank_r, bank_i):
    """Dispatch ``local(sig, bank_r, bank_i_or_None)`` through shard_map,
    with the imag bank plumbed only when it exists (its presence is static
    under jit, so the two traces are distinct programs)."""
    if bank_i is None:
        fn = lambda sig, br: local(sig, br, None)
        return jax.shard_map(fn, mesh=mesh, in_specs=(sig_spec, _BANK_SPEC),
                             out_specs=out_specs)(signals_r, bank_r)
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(sig_spec, _BANK_SPEC, _BANK_SPEC),
                         out_specs=out_specs)(signals_r, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate"))
def sharded_mean_power(signals_r, bank_r, bank_i=None, *, mesh: Mesh,
                       interpolate: bool = False):
    """Epoch-mean power TFR over the mesh: (E, ..., N) -> (..., F, N).

    Epochs sharded over ``data``, bank rows over ``freq``; each shard
    reduces its local epochs as one device would (the Triton kernel on
    CUDA devices where it applies, the CWT+|.|^2 scan otherwise), then one
    ``pmean`` over ``data`` completes the global epoch mean (reference
    semantics: ``mneutils.py:42-55``).  E must be divisible by the
    ``data`` axis size (use ``mesh.pad_to_multiple`` on the host
    otherwise).
    """
    def local(sig, br, bi):
        local_mean = _kernel_or_xla_mean_power(
            sig, _as_bank(br, bi), interpolate,
            vma_axes=(DATA_AXIS, FREQ_AXIS))
        return lax.pmean(local_mean, DATA_AXIS)

    out_spec = P(*([None] * (signals_r.ndim - 2)), FREQ_AXIS, None)
    return _shard_call(mesh, local, P(DATA_AXIS), out_spec,
                       signals_r, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps"))
def sharded_itc(signals_r, bank_r, bank_i=None, *, mesh: Mesh,
                interpolate: bool = False, eps: float = 0.0):
    """Inter-trial coherence over the mesh: (E, ..., N) -> (..., F, N).

    ``| mean_E cwt/|cwt| |`` (reference ``mneutils.py:57-71``): the unit-phase
    mean is linear in epochs, so shards reduce locally, ``pmean`` over
    ``data``, and the final ``abs`` runs on the reduced value.
    """
    def local(sig, br, bi):
        bank = _as_bank(br, bi)

        def unit_phase(c):
            mag = jnp.abs(c)
            if eps:
                mag = jnp.maximum(mag, eps)
            return c / mag

        local_mean = _scan_mean(sig, bank, interpolate, unit_phase,
                                vma_axes=(DATA_AXIS, FREQ_AXIS))
        return jnp.abs(lax.pmean(local_mean, DATA_AXIS))

    out_spec = P(*([None] * (signals_r.ndim - 2)), FREQ_AXIS, None)
    return _shard_call(mesh, local, P(DATA_AXIS), out_spec,
                       signals_r, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate"))
def sharded_cwt_ri(signals_r, bank_r, bank_i=None, *, mesh: Mesh,
                   interpolate: bool = False):
    """Raw CWT coefficients over the mesh: (E, ..., N) -> (E, ..., F, N) as a
    (real, imag) float pair, epochs sharded over ``data`` and frequency rows
    over ``freq``.  No collective at all — both axes are embarrassingly
    parallel; the output stays fully sharded.
    """
    ndim = signals_r.ndim  # (E, ..., N)
    out_spec = P(DATA_AXIS, *([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sig, br, bi):
        c = cwt_from_bank(_as_signal(sig, None), _as_bank(br, bi), interpolate)
        return c.real, c.imag

    return _shard_call(mesh, local, P(DATA_AXIS, *([None] * (ndim - 1))),
                       (out_spec, out_spec), signals_r, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate"))
def sharded_power(signals_r, bank_r, bank_i=None, *, mesh: Mesh,
                  interpolate: bool = False):
    """Per-epoch power (no epoch mean): (E, ..., N) -> (E, ..., F, N),
    sharded over (data, freq) with no collectives."""
    ndim = signals_r.ndim
    out_spec = P(DATA_AXIS, *([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sig, br, bi):
        c = cwt_from_bank(_as_signal(sig, None), _as_bank(br, bi), interpolate)
        return jnp.square(c.real) + jnp.square(c.imag)

    return _shard_call(mesh, local, P(DATA_AXIS, *([None] * (ndim - 1))),
                       out_spec, signals_r, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate"))
def sharded_cross_power(sigs_a, sigs_b, bank_r, bank_i=None, *, mesh: Mesh,
                        interpolate: bool = False):
    """Cross-wavelet product ``Wa * conj(Wb)`` over the mesh as a (real,
    imag) float pair: (E, ..., N) x2 -> (E, ..., F, N) x2.

    Epochs sharded over ``data``, bank rows over ``freq`` — both axes
    embarrassingly parallel, no collective (extension op; no reference
    counterpart — see ``ops.extensions.cross_power_from_bank``).
    """
    from ..ops.extensions import cross_power_from_bank
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(DATA_AXIS, *([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, br, bi):
        return cross_power_from_bank(sa, sb, _as_bank(br, bi), interpolate)

    if bank_i is None:
        fn = lambda sa, sb, br: local(sa, sb, br, None)
        return jax.shard_map(
            fn, mesh=mesh, in_specs=(sig_spec, sig_spec, _BANK_SPEC),
            out_specs=(out_spec, out_spec))(sigs_a, sigs_b, bank_r)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(sig_spec, sig_spec, _BANK_SPEC, _BANK_SPEC),
        out_specs=(out_spec, out_spec))(sigs_a, sigs_b, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps"))
def sharded_coherence(sigs_a, sigs_b, bank_r, bank_i=None, *, mesh: Mesh,
                      interpolate: bool = False, eps: float = 1e-12):
    """Epoch-wise wavelet coherence over the mesh: (E, ..., N) x2 ->
    (..., F, N) in [0, 1].

    Each shard accumulates its local cross/power sums
    (``ops.extensions.coherence_sums``); one ``pmean`` over ``data``
    completes all four global reductions, and the ratio is taken on the
    reduced values — mesh result == single-device result.  E must be divisible
    by the ``data`` axis size.
    """
    from ..ops.extensions import coherence_from_sums, coherence_sums
    n_epochs = sigs_a.shape[0]
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, br, bi):
        sums = coherence_sums(sa, sb, _as_bank(br, bi), interpolate,
                              vma_axes=(DATA_AXIS, FREQ_AXIS))
        xr, xi, pa, pb = (lax.psum(s, DATA_AXIS) for s in sums)
        return coherence_from_sums(xr, xi, pa, pb, n_epochs, eps,
                                   vma_axes=(FREQ_AXIS,))

    if bank_i is None:
        fn = lambda sa, sb, br: local(sa, sb, br, None)
        return jax.shard_map(
            fn, mesh=mesh, in_specs=(sig_spec, sig_spec, _BANK_SPEC),
            out_specs=out_spec)(sigs_a, sigs_b, bank_r)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(sig_spec, sig_spec, _BANK_SPEC, _BANK_SPEC),
        out_specs=out_spec)(sigs_a, sigs_b, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "wavelet", "level", "denoise",
                                   "mode"))
def sharded_modwt(x, *, mesh: Mesh, wavelet: str = "db4",
                  level: int | None = None, denoise: bool = False,
                  mode: str = "soft"):
    """MODWT (or MODWT shrinkage with ``denoise=True``) over the mesh:
    the leading batch axis (channels / epochs) shards over ``data`` and
    each shard runs the full per-signal transform — embarrassingly
    parallel, no collectives (each signal's coefficients depend only on
    itself; the replicated frequency-domain bank is built per shard).
    (..., N) -> (..., J+1, N), or (..., N) with ``denoise``."""
    from ..ops.dwt import max_level as _max_level
    from ..ops.dwt import modwt as _modwt
    from ..ops.dwt import modwt_denoise as _denoise
    lvl = _max_level(x.shape[-1], wavelet) if level is None else int(level)
    ndim = x.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    if denoise:
        out_spec = sig_spec
        local = lambda s: _denoise(s, wavelet, lvl, mode)
    else:
        out_spec = P(DATA_AXIS, *([None] * ndim))
        local = lambda s: _modwt(s, wavelet, lvl)
    return jax.shard_map(local, mesh=mesh, in_specs=(sig_spec,),
                         out_specs=out_spec)(x)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps"))
def sharded_imcoh(sigs_a, sigs_b, bank_r, bank_i=None, *, mesh: Mesh,
                  interpolate: bool = False, eps: float = 1e-12):
    """Imaginary coherency over the mesh: (E, ..., N) x2 -> (..., F, N)
    in [-1, 1].  Same shard layout and ``pmean`` reduction as
    ``sharded_coherence`` (the ratio is scale-invariant in the common
    epoch factor); only the finisher differs."""
    from ..ops.extensions import coherence_sums, imcoh_from_sums
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, br, bi):
        sums = coherence_sums(sa, sb, _as_bank(br, bi), interpolate,
                              vma_axes=(DATA_AXIS, FREQ_AXIS))
        xr, xi, pa, pb = (lax.psum(s, DATA_AXIS) for s in sums)
        return imcoh_from_sums(xr, xi, pa, pb, eps,
                               vma_axes=(FREQ_AXIS,))

    if bank_i is None:
        fn = lambda sa, sb, br: local(sa, sb, br, None)
        return jax.shard_map(
            fn, mesh=mesh, in_specs=(sig_spec, sig_spec, _BANK_SPEC),
            out_specs=out_spec)(sigs_a, sigs_b, bank_r)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(sig_spec, sig_spec, _BANK_SPEC, _BANK_SPEC),
        out_specs=out_spec)(sigs_a, sigs_b, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "method", "interpolate", "eps"))
def sharded_phase_lag(sigs_a, sigs_b, bank_r, *, mesh: Mesh,
                      method: str = "wpli", interpolate: bool = False,
                      eps: float = 0.0):
    """Phase-lag connectivity (PLI / wPLI / debiased wPLI^2) over the
    mesh: (E, ..., N) x2 -> (..., F, N).

    All four ``phase_lag_sums`` planes are linear in epochs, so shards
    accumulate locally, one ``psum`` each over ``data`` completes the RAW
    global sums (dwpli mixes squares of sums with sums of squares, so
    unlike coherence no common rescaling is admissible), and the finisher
    runs on the reduced planes with the TRUE epoch count.  Mesh result ==
    single-device ``ops.connectivity.phase_lag_from_bank``."""
    from ..ops.connectivity import phase_lag_from_sums, phase_lag_sums
    n_epochs = sigs_a.shape[0]
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, br):
        sums = phase_lag_sums(sa, sb, br, interpolate,
                              vma_axes=(DATA_AXIS, FREQ_AXIS))
        sums = tuple(lax.psum(s, DATA_AXIS) for s in sums)
        return phase_lag_from_sums(sums, n_epochs, method, eps)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(sig_spec, sig_spec, _BANK_SPEC),
        out_specs=out_spec)(sigs_a, sigs_b, bank_r)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps"))
def sharded_ppc(sigs_a, sigs_b, bank_r, *, mesh: Mesh,
                interpolate: bool = False, eps: float = 0.0):
    """Pairwise phase consistency over the mesh: (E, ..., N) x2 ->
    (..., F, N).

    PPC is a closed form of the SAME unit cross-phase sums as PLV
    (``(|sum u|^2 - E) / (E (E - 1))``), so the shard layout and the one
    ``psum`` are exactly ``sharded_plv``'s — only the finisher differs.
    Mesh result == single-device ``ops.connectivity.ppc_from_bank``."""
    from ..ops.connectivity import plv_sums
    n_epochs = sigs_a.shape[0]
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, br):
        sr, si = plv_sums(sa, sb, br, interpolate, eps,
                          vma_axes=(DATA_AXIS, FREQ_AXIS))
        sr = lax.psum(sr, DATA_AXIS)
        si = lax.psum(si, DATA_AXIS)
        return (sr * sr + si * si - n_epochs) / (n_epochs
                                                 * (n_epochs - 1.0))

    return jax.shard_map(
        local, mesh=mesh, in_specs=(sig_spec, sig_spec, _BANK_SPEC),
        out_specs=out_spec)(sigs_a, sigs_b, bank_r)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps"))
def sharded_plv(sigs_a, sigs_b, bank_r, *, mesh: Mesh,
                interpolate: bool = False, eps: float = 0.0):
    """Phase-locking value over the mesh: (E, ..., N) x2 -> (..., F, N).

    The unit cross-phase mean is linear in epochs (exactly like ITC), so
    shards accumulate their local sums (``ops.connectivity.plv_sums``),
    one ``psum`` over ``data`` completes the global mean, and the final
    abs runs on the reduced planes.  Epochs shard over ``data``, bank
    rows over ``freq`` — mesh result == single-device
    ``ops.connectivity.plv_from_bank``.
    """
    from ..ops.connectivity import plv_sums
    n_epochs = sigs_a.shape[0]
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, br):
        sr, si = plv_sums(sa, sb, br, interpolate, eps,
                          vma_axes=(DATA_AXIS, FREQ_AXIS))
        sr = lax.psum(sr, DATA_AXIS)
        si = lax.psum(si, DATA_AXIS)
        return jnp.sqrt(sr * sr + si * si) / n_epochs

    return jax.shard_map(
        local, mesh=mesh, in_specs=(sig_spec, sig_spec, _BANK_SPEC),
        out_specs=out_spec)(sigs_a, sigs_b, bank_r)


@partial(jax.jit, static_argnames=("mesh", "n", "m", "interpolate", "eps"))
def sharded_nm_plv(sigs_a, sigs_b, bank_a_r, bank_b_r, *, mesh: Mesh,
                   n: int = 1, m: int = 1, interpolate: bool = False,
                   eps: float = 0.0):
    """n:m cross-frequency phase locking over the mesh: (E, ..., N) x2 ->
    (..., F, N).

    Same layout as ``sharded_plv`` — the ``exp(i(n phi_a - m phi_b))``
    epoch mean is linear in epochs, and the row-paired banks shard
    together over ``freq`` (row k of both banks lives on the same device,
    so the pairing never crosses shards).  Mesh result == single-device
    ``ops.connectivity.nm_plv_from_bank``.
    """
    from ..ops.connectivity import nm_plv_sums
    n_epochs = sigs_a.shape[0]
    ndim = sigs_a.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sa, sb, ba, bb):
        # |mean| is not linear in epochs — reduce the complex SUMS across
        # shards and take the magnitude after (the plv_sums pattern).
        sr, si = nm_plv_sums(sa, sb, ba, bb, n, m, interpolate, eps,
                             vma_axes=(DATA_AXIS, FREQ_AXIS))
        sr = lax.psum(sr, DATA_AXIS)
        si = lax.psum(si, DATA_AXIS)
        return jnp.sqrt(sr * sr + si * si) / n_epochs

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(sig_spec, sig_spec, _BANK_SPEC, _BANK_SPEC),
        out_specs=out_spec)(sigs_a, sigs_b, bank_a_r, bank_b_r)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps"))
def sharded_superlet_mean_power(signals_r, banks, weights, *, mesh: Mesh,
                                interpolate: bool = False,
                                eps: float = 1e-30):
    """Epoch-mean superlet power over the mesh: (E, ..., N) ->
    (..., F, N).

    Epochs shard over ``data``; the (O, F, N) member banks and (O, F)
    FASLT weights shard over ``freq`` on their F axis — the geometric
    fusion is per-(f, t) independent, so the frequency axis is
    embarrassingly parallel (unlike synchrosqueezing) and the only
    collective is the final ``pmean`` over ``data``.  Mesh result ==
    single-device ``ops.superlets.superlet_mean_power``.
    """
    from ..ops.superlets import superlet_power_from_banks
    ndim = signals_r.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sig, bks, w):
        e_local = sig.shape[0]
        zero = lax.pcast(
            jnp.zeros(sig.shape[1:-1] + (bks.shape[1], sig.shape[-1]),
                      jnp.float32), (DATA_AXIS, FREQ_AXIS), to="varying")

        def step(acc, s):
            return acc + superlet_power_from_banks(
                s, bks, w, interpolate, eps,
                vma_axes=(DATA_AXIS, FREQ_AXIS)), None

        local_mean = lax.scan(step, zero, sig)[0] / e_local
        return lax.pmean(local_mean, DATA_AXIS)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(sig_spec, P(None, FREQ_AXIS, None), P(None, FREQ_AXIS)),
        out_specs=out_spec)(signals_r, banks, weights)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps",
                                   "time_range"))
def sharded_plv_matrix(sigs, bank_r, *, mesh: Mesh,
                       interpolate: bool = False, eps: float = 0.0,
                       time_range=None):
    """All-pairs phase-locking matrix over the mesh:
    (E, C, N) -> (F, C, C), time-averaged.

    Epochs shard over ``data`` (each shard contracts its local epochs into
    partial (C, C, n) pairwise sums; one ``psum`` per row completes them
    before the abs), bank rows over ``freq`` (independent — the output
    stays sharded on its leading axis).  Mesh result == single-device
    ``ops.connectivity.plv_matrix_from_bank``.
    """
    from ..ops.connectivity import pair_matrix_scan
    n_epochs = sigs.shape[0]

    def local(sg, br):
        def per_row(sr, si):
            sr = lax.psum(sr, DATA_AXIS)
            si = lax.psum(si, DATA_AXIS)
            return jnp.mean(jnp.sqrt(sr * sr + si * si), axis=-1) / n_epochs

        return pair_matrix_scan(sg, br, per_row, interpolate, unit=True,
                                eps=eps, time_range=time_range)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(DATA_AXIS), _BANK_SPEC),
        out_specs=P(FREQ_AXIS, None, None))(sigs, bank_r)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps",
                                   "time_range"))
def sharded_coherence_matrix(sigs, bank_r, bank_i=None, *, mesh: Mesh,
                             interpolate: bool = False, eps: float = 1e-12,
                             time_range=None):
    """All-pairs epoch-wise wavelet coherence over the mesh:
    (E, C, N) -> (F, C, C), time-averaged.

    Same layout as ``sharded_plv_matrix``; the cross and power sums are
    both completed by the one ``psum`` over ``data`` (the power sums are
    the diagonal of the pairwise sums), so the ratio runs on global
    values — mesh result == single-device
    ``ops.connectivity.coherence_matrix_from_bank``.
    """
    from ..ops.connectivity import pair_matrix_scan
    n_epochs = sigs.shape[0]

    def local(sg, br, bi=None):
        def per_row(sr, si):
            sr = lax.psum(sr, DATA_AXIS)
            si = lax.psum(si, DATA_AXIS)
            num = (sr * sr + si * si) / (n_epochs * n_epochs)
            p = jnp.einsum('aan->an', sr) / n_epochs
            den = p[:, None, :] * p[None, :, :]
            if eps:
                den = jnp.maximum(den, eps * jnp.max(den))
            return jnp.mean(num / den, axis=-1)

        return pair_matrix_scan(sg, _as_bank(br, bi), per_row, interpolate,
                                time_range=time_range)

    out_spec = P(FREQ_AXIS, None, None)
    if bank_i is None:
        return jax.shard_map(
            local, mesh=mesh, in_specs=(P(DATA_AXIS), _BANK_SPEC),
            out_specs=out_spec)(sigs, bank_r)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), _BANK_SPEC, _BANK_SPEC),
        out_specs=out_spec)(sigs, bank_r, bank_i)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "lam",
                                   "time_range"))
def sharded_partial_coherence(sigs, bank_r, *, mesh: Mesh,
                              interpolate: bool = False,
                              lam: float = 1e-5, time_range=None):
    """All-pairs partial coherence over the mesh:
    (E, C, N) -> (F, C, C).

    Same layout as ``sharded_coherence_matrix`` (epochs over ``data``
    psum-completed per row, bank rows over ``freq``); the tiny (C, C)
    precision-matrix solve then runs on global sums, identically on
    every data shard.  Mesh result == single-device
    ``ops.connectivity.partial_coherence_from_bank``.
    """
    from ..ops.connectivity import (pair_matrix_scan,
                                    partial_coherence_per_row)
    n_epochs = sigs.shape[0]

    def local(sg, br):
        def per_row(sr, si):
            sr = lax.psum(sr, DATA_AXIS)
            si = lax.psum(si, DATA_AXIS)
            return partial_coherence_per_row(sr, si, n_epochs, lam)

        return pair_matrix_scan(sg, br, per_row, interpolate,
                                time_range=time_range,
                                precision=lax.Precision.HIGHEST)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(DATA_AXIS), _BANK_SPEC),
        out_specs=P(FREQ_AXIS, None, None))(sigs, bank_r)


@partial(jax.jit, static_argnames=("mesh", "interpolate", "eps",
                                   "time_range", "normalize"))
def sharded_psi_matrix(sigs, bank_r, *, mesh: Mesh, interpolate: bool = False,
                eps: float = 1e-12, time_range=None,
                normalize: bool = True):
    """Phase-slope index over the mesh: (E, C, N) -> (C, C).

    Epochs shard over ``data``; the bank is REPLICATED — adjacent-row
    pairs form the frequency slope, so the row scan is sequential and
    cannot split over ``freq``.  Each shard contracts its local epochs
    into per-epoch cross-spectral sums, one ``psum`` per row completes
    the full-sample total (every shard then holds the identical
    full-sample replicate plus ITS epochs' leave-one-out replicates),
    and the jackknife moments are completed by two final ``psum``s.
    Mesh result == single-device ``ops.connectivity.psi_matrix_from_bank``.
    """
    from ..ops.connectivity import psi_reps_scan
    e = sigs.shape[0]
    # the single-device validation, or a 1-row bank scans zero pairs and
    # silently returns an all-zero matrix where the ops API raises
    if e < 2:
        raise ValueError("psi needs at least 2 epochs (>= 3 for a "
                         "meaningful jackknife)")
    if bank_r.shape[0] < 2:
        raise ValueError("psi needs at least 2 bank rows (adjacent "
                         "frequency pairs form the slope)")
    n0, n1 = time_range if time_range is not None else (0, sigs.shape[-1])

    ndev = mesh.shape[DATA_AXIS]

    def local(sg, br):
        reps = psi_reps_scan(
            sg, br, n0, n1, e, eps, interpolate,
            complete=lambda s: lax.psum(s, DATA_AXIS))
        # reps[-1] is value-identical on every shard but still carries
        # the data-varying type (it was concatenated with the local
        # leave-one-out rows); one tiny (C, C) psum/ndev makes it
        # replicated for real (ndev is a power of two — exact division).
        psi = lax.psum(reps[-1], DATA_AXIS) / ndev
        if not normalize:
            return psi
        jk = reps[:-1]                       # this shard's epochs
        jk_mean = lax.psum(jnp.sum(jk, axis=0), DATA_AXIS) / e
        var = (e - 1.0) / e * lax.psum(
            jnp.sum((jk - jk_mean) ** 2, axis=0), DATA_AXIS)
        std = jnp.sqrt(jnp.maximum(var, 0.0))
        return jnp.where(std > 0, psi / jnp.where(std > 0, std, 1.0), 0.0)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(DATA_AXIS), None),
        out_specs=P())(sigs, bank_r)


@partial(jax.jit, static_argnames=("mesh", "sfreq", "interpolate",
                                   "rel_threshold", "uniform_grid"))
def sharded_ssq_mean_power(signals_r, bank_r, f_grid, *, mesh: Mesh,
                           sfreq: float, interpolate: bool = True,
                           rel_threshold: float = 1e-6,
                           uniform_grid=None):
    """Epoch-mean synchrosqueezed power over the mesh:
    (E, ..., N) -> (..., F, N).

    Synchrosqueezing is NOT embarrassingly parallel on the frequency axis —
    reassignment moves energy BETWEEN analysis rows — so the layout differs
    from the plain power reductions: epochs shard over ``data`` as usual,
    the SOURCE rows (bank slices) shard over ``freq``, and each shard
    scatters its sources into a full-height partial target plane; one
    ``psum`` over ``freq`` completes the plane and one ``pmean`` over
    ``data`` completes the epoch mean.  The noise-gate floor is
    ``pmax``-reduced inside the core so shards gate against the global
    per-epoch peak — mesh result == single-device
    ``ops.sst.ssq_mean_power``.  F must be divisible by the ``freq`` axis size and
    E the ``data`` axis size.
    """
    from ..ops.sst import _reassigned_power

    e = signals_r.shape[0]

    def local(sig, br, fg):
        offset = lax.axis_index(FREQ_AXIS) * br.shape[0]
        zero = jnp.zeros(sig.shape[1:-1] + (fg.shape[0], sig.shape[-1]),
                         jnp.float32)
        zero = lax.pcast(zero, (DATA_AXIS, FREQ_AXIS), to="varying")

        def step(acc, s):
            return acc + _reassigned_power(
                s, br, fg, sfreq, interpolate, rel_threshold,
                row_offset=offset, n_rows_out=fg.shape[0],
                freq_axis=FREQ_AXIS,
                vma_axes=(DATA_AXIS, FREQ_AXIS),
                uniform_grid=uniform_grid), None

        total = lax.scan(step, zero, sig)[0]
        total = lax.psum(total, FREQ_AXIS)        # complete target rows
        return lax.psum(total, DATA_AXIS) / e     # global epoch mean

    out_spec = P(*([None] * (signals_r.ndim - 2)), None, None)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), _BANK_SPEC, P(None)),
        out_specs=out_spec)(signals_r, bank_r, f_grid)


@partial(jax.jit, static_argnames=("mesh", "sfreq", "interpolate",
                                   "rel_threshold", "t_decim"))
def sharded_reassigned_mean_power(signals_r, bank_r, f_grid, *, mesh: Mesh,
                                  sfreq: float, interpolate: bool = True,
                                  rel_threshold: float = 1e-6,
                                  t_decim: int = 16):
    """Epoch-mean 2-D REASSIGNED scalogram over the mesh:
    (E, ..., N) -> (..., F, ceil(N/t_decim)).

    Same layout reasoning as ``sharded_ssq_mean_power`` — reassignment
    moves energy between analysis rows, so SOURCE rows (bank slices)
    shard over ``freq``, each shard scatters into a full-height partial
    plane (targeting is by value against the full grid's edges), and a
    ``psum`` over ``freq`` + ``pmean`` over ``data`` complete it.  The
    noise-gate floor is ``pmax``-reduced per signal so shards gate
    against the global peak: mesh result == single-device
    ``ops.reassign.reassigned_mean_power``.
    """
    from ..ops.reassign import _reassign_one

    e = signals_r.shape[0]

    def local(sig, br, fg):
        offset = lax.axis_index(FREQ_AXIS) * br.shape[0]
        f_own = lax.dynamic_slice_in_dim(fg, offset, br.shape[0])
        inner = sig.shape[1:-1]
        flat = sig.reshape((-1, sig.shape[-1]))

        def one(s):
            return _reassign_one(
                s, br, fg, sfreq=sfreq, interpolate=interpolate,
                rel_threshold=rel_threshold, t_decim=t_decim,
                f_own=f_own, pmax_axes=(FREQ_AXIS,),
                vma_axes=(DATA_AXIS, FREQ_AXIS))

        planes = lax.map(one, flat)              # (E_loc*prod(inner), F, T')
        planes = planes.reshape((sig.shape[0],) + inner + planes.shape[1:])
        total = jnp.sum(planes, axis=0)          # local epoch sum
        total = lax.psum(total, FREQ_AXIS)       # complete target rows
        return lax.psum(total, DATA_AXIS) / e    # global epoch mean

    out_spec = P(*([None] * (signals_r.ndim - 2)), None, None)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), _BANK_SPEC, P(None)),
        out_specs=out_spec)(signals_r, bank_r,
                            jnp.asarray(f_grid, jnp.float32))


@partial(jax.jit, static_argnames=("mesh", "interpolate", "method",
                                   "n_bins"))
def sharded_pac(sigs_r, bank_phase_r, bank_amp_r, *, mesh: Mesh,
                interpolate: bool = False, method: str = "mvl",
                n_bins: int = 18):
    """Epoch-mean phase-amplitude comodulogram over the mesh:
    (E, ..., N) -> (..., Fp, Fa).

    Every phase row pairs with every amp row, so only one frequency axis
    can shard: phase-bank rows go over ``freq`` and the amp bank is
    replicated.  Epochs shard over ``data``; per-epoch comodulograms
    (``ops.connectivity.pac_from_banks``) accumulate locally under a scan,
    then one ``pmean`` over ``data`` completes the epoch mean.  The output
    stays sharded on the phase-frequency axis.  E must be divisible by the ``data``
    axis size and Fp the ``freq`` axis size.
    """
    from ..ops.connectivity import pac_mean_from_banks

    def local(sig, bp, ba):
        total = pac_mean_from_banks(sig, bp, ba, interpolate, method,
                                    n_bins,
                                    vma_axes=(DATA_AXIS, FREQ_AXIS))
        return lax.pmean(total, DATA_AXIS)

    out_spec = P(*([None] * (sigs_r.ndim - 2)), FREQ_AXIS, None)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), _BANK_SPEC, P(None, None)),
        out_specs=out_spec)(sigs_r, bank_phase_r, bank_amp_r)


@partial(jax.jit, static_argnames=("mesh", "interpolate"))
def sharded_mean_power_grad(signals_r, bank_r, g, *, mesh: Mesh,
                            interpolate: bool = False):
    """One distributed TRAINING step on the epoch-mean power: the VJP of
    ``sharded_mean_power`` against a cotangent g (C, F, N) sharded over
    ``freq`` like the power itself — e.g. the gradient of a loss on the
    TFR wrt both the signals AND the bank (learnable wavelets).

    Layout: epochs shard over ``data``, bank rows over ``freq`` (the bank
    gradient stays freq-sharded — each device owns the gradient of its own
    rows); the global mean is a pmean of shard means, so each shard's
    local VJP runs with cotangent g / n_data, the signal gradient stays
    epoch-sharded with NO collective, and one ``psum`` over ``data``
    completes the bank gradient.  Returns (power, dsignals, dbank).
    """
    from ..ops.cwt import _mean_power_bwd

    def local(sig, br, gg):
        d = lax.psum(1, DATA_AXIS)
        # Forward: _scan_mean directly (not mean_power_from_bank) so the
        # scan zero init carries the shard_map varying-axes type.
        # Backward: the ANALYTIC adjoint, not jax.vjp —
        # autodiffing the rfft path under shard_map trips a cotangent
        # varying-type mismatch in the fft transpose rule, and the
        # analytic pipeline is the gated gradient path anyway.
        p_local = _scan_mean(
            sig, br, interpolate,
            lambda c: jnp.square(c.real) + jnp.square(c.imag),
            vma_axes=(DATA_AXIS, FREQ_AXIS))
        p = lax.pmean(p_local, DATA_AXIS)
        gg = lax.pcast(gg / d, (DATA_AXIS,), to="varying")
        br_v = lax.pcast(br, (DATA_AXIS,), to="varying")
        ds, db = _mean_power_bwd(sig, br_v, interpolate, gg)
        # Each freq shard covers only its own bank rows: the signal
        # gradient sums contributions from ALL rows -> psum over freq.
        return (p, lax.psum(ds, FREQ_AXIS), lax.psum(db, DATA_AXIS))

    nb = signals_r.ndim - 2   # batch dims between epochs and samples
    p_spec = P(*([None] * nb), FREQ_AXIS, None)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), _BANK_SPEC, p_spec),
        out_specs=(p_spec, P(DATA_AXIS), _BANK_SPEC))(
        signals_r, bank_r, g)


@partial(jax.jit, static_argnames=("mesh", "n_perm", "threshold", "na",
                                   "sizes", "chunk"))
def sharded_cluster_null(x, key, *, mesh: Mesh, n_perm: int,
                         threshold: float, na=None, sizes=None,
                         chunk: int = 64, adjacency=None):
    """Permutation null of max cluster masses over the mesh: (P,).

    Permutations are embarrassingly parallel, so the DRAW (the canonical
    ``ops.cluster.sign_draws`` / ``relabel_draws`` for the given key — the
    same sequence the single-device null consumes) shards its chunk axis
    over ``data`` while the (E, F, N) trial stack replicates; each shard
    scans its local chunks through the shared chunk kernels.  Mesh result
    == single-device ``ops.cluster._sign_flip_null`` / ``_relabel_null``
    for the same key, bit for bit.  ``na=None`` selects the one-sample
    sign-flip null; ``na=k`` the independent-groups relabeling null with
    the first k trials as group A; ``sizes=(n1, n2, ...)`` the one-way-F
    relabeling null over G groups stacked in order.  With channel
    ``adjacency`` edges the stack is (E, C, F, N) (spatio-spectral
    clusters); the adjacency replicates to every shard.
    """
    from ..ops.cluster import (_pad_perms, anova_chunk_max_mass,
                               anova_draws, relabel_chunk_max_mass,
                               relabel_draws, sign_chunk_max_mass,
                               sign_draws)
    x = jnp.asarray(x, jnp.float32)
    e, plane = x.shape[0], x.shape[1:]
    xf = x.reshape(e, -1)
    n_chunks = _pad_perms(n_perm, chunk)
    d = mesh.shape[DATA_AXIS]
    pad_chunks = -(-n_chunks // d) * d
    if sizes is not None:
        draws = anova_draws(key, n_perm, sizes, chunk)
        xf = xf - jnp.mean(xf, 0)
        aux = (jnp.sum(xf * xf, 0),)

        def chunk_fn(dchunk, xf_, aux_):
            return anova_chunk_max_mass(dchunk, xf_, aux_[0], sizes,
                                        threshold, plane, adjacency)
    elif na is None:
        draws = sign_draws(key, n_perm, e, chunk)
        aux = (jnp.sum(xf * xf, 0),)

        def chunk_fn(dchunk, xf_, aux_):
            return sign_chunk_max_mass(dchunk, xf_, aux_[0], e, threshold,
                                       plane, adjacency)
    else:
        nb = e - na
        draws = relabel_draws(key, n_perm, e, na, chunk)
        x2f = xf * xf
        aux = (x2f, jnp.sum(xf, 0), jnp.sum(x2f, 0))

        def chunk_fn(dchunk, xf_, aux_):
            return relabel_chunk_max_mass(dchunk, xf_, aux_[0], aux_[1],
                                          aux_[2], na, nb, threshold,
                                          plane, adjacency)
    if pad_chunks != n_chunks:
        reps = jnp.broadcast_to(
            draws[:1], (pad_chunks - n_chunks,) + draws.shape[1:])
        draws = jnp.concatenate([draws, reps], 0)

    def local(dr, xf_, *aux_):
        def step(c, dchunk):
            return c, chunk_fn(dchunk, xf_, aux_)

        _, out = lax.scan(step, 0, dr)
        return out

    aux_specs = tuple(P(*([None] * a.ndim)) for a in aux)
    draw_spec = P(DATA_AXIS, *([None] * (draws.ndim - 1)))
    out = jax.shard_map(
        local, mesh=mesh,
        in_specs=(draw_spec, P(None, None)) + aux_specs,
        out_specs=P(DATA_AXIS, None))(draws, xf, *aux)
    return out.reshape(-1)[:n_perm]


def sharded_cluster_test_one_sample(x, *, mesh: Mesh, n_perm: int = 999,
                                    threshold=None, alpha: float = 0.05,
                                    seed: int = 0, adjacency=None):
    """``ops.cluster.cluster_test_one_sample`` with the permutation null
    computed over the mesh (same key -> same result as single-device)."""
    from ..ops.cluster import _resolve_threshold, cluster_test_one_sample
    x = jnp.asarray(x, jnp.float32)
    thr = _resolve_threshold(threshold, alpha, x.shape[0] - 1)
    null = sharded_cluster_null(x, jax.random.PRNGKey(seed), mesh=mesh,
                                n_perm=n_perm, threshold=thr,
                                adjacency=adjacency)
    return cluster_test_one_sample(x, threshold=thr, null_max=null,
                                   adjacency=adjacency)


def sharded_cluster_test_independent(xa, xb, *, mesh: Mesh,
                                     n_perm: int = 999, threshold=None,
                                     alpha: float = 0.05, seed: int = 0,
                                     adjacency=None):
    """``ops.cluster.cluster_test_independent`` with the relabeling null
    computed over the mesh."""
    from ..ops.cluster import _resolve_threshold, cluster_test_independent
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    na = xa.shape[0]
    thr = _resolve_threshold(threshold, alpha, na + xb.shape[0] - 2)
    null = sharded_cluster_null(jnp.concatenate([xa, xb], 0),
                                jax.random.PRNGKey(seed), mesh=mesh,
                                n_perm=n_perm, threshold=thr, na=na,
                                adjacency=adjacency)
    return cluster_test_independent(xa, xb, threshold=thr, null_max=null,
                                    adjacency=adjacency)


def sharded_cluster_test_f(groups, *, mesh: Mesh, n_perm: int = 999,
                           threshold=None, alpha: float = 0.05,
                           seed: int = 0, adjacency=None):
    """``ops.cluster.cluster_test_f`` (one-way ANOVA clusters) with the
    relabeling null computed over the mesh."""
    from ..ops.cluster import cluster_test_f, f_threshold
    groups = [jnp.asarray(x, jnp.float32) for x in groups]
    sizes = tuple(int(x.shape[0]) for x in groups)
    if threshold is None:
        threshold = f_threshold(alpha, len(sizes) - 1,
                                sum(sizes) - len(sizes))
    thr = float(threshold)
    null = sharded_cluster_null(jnp.concatenate(groups, 0),
                                jax.random.PRNGKey(seed), mesh=mesh,
                                n_perm=n_perm, threshold=thr,
                                sizes=sizes, adjacency=adjacency)
    return cluster_test_f(groups, threshold=thr, null_max=null,
                          adjacency=adjacency)


@partial(jax.jit, static_argnames=("mesh", "interpolate"))
def sharded_multitaper_mean_power(signals_r, banks, *, mesh: Mesh,
                                  interpolate: bool = False):
    """Epoch-mean multitaper Morse power over the mesh: (E, ..., N) ->
    (..., F, N).

    Epochs shard over ``data``; the (F, K, n) taper banks shard their F
    axis over ``freq`` — the F-major stack keeps every frequency's K
    orthogonal taper rows on ONE shard, so the taper mean is purely
    local and the only collective is the ``pmean`` over ``data``.  Mesh
    result == single-device ``ops.multitaper.multitaper_mean_power``.
    """
    ndim = signals_r.ndim
    sig_spec = P(DATA_AXIS, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sig, bks):
        f_loc, k, n = bks.shape
        local_mean = _scan_mean(
            sig, bks.reshape(f_loc * k, n), interpolate,
            lambda c: jnp.square(c.real) + jnp.square(c.imag),
            vma_axes=(DATA_AXIS, FREQ_AXIS))
        local_mean = lax.pmean(local_mean, DATA_AXIS)
        local_mean = local_mean.reshape(*local_mean.shape[:-2], f_loc, k,
                                        local_mean.shape[-1])
        return jnp.mean(local_mean, axis=-2)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(sig_spec, P(FREQ_AXIS, None, None)),
        out_specs=out_spec)(signals_r, banks)


@partial(jax.jit, static_argnames=("mesh", "time_decim", "n_iter",
                                   "interpolate"))
def sharded_wavelet_granger(sigs, bank_r, *, mesh: Mesh,
                            time_decim: int = 16, n_iter: int = 60,
                            interpolate: bool = True):
    """Time-resolved pairwise Granger causality over the mesh:
    (E, C, N) + the energy-normalized uniform-grid bank (from
    ``ops.granger._granger_inputs``) -> (T', K, C, C).

    Two shard_map stages: (1) epochs shard over ``data`` — each shard
    accumulates its local wavelet cross-spectra, one ``psum`` completes
    the epoch mean (replicated (T', K, C, C) planes, tiny); (2) the
    Wilson factorizations are embarrassingly parallel over time slices,
    so T' re-shards over ``data`` and each shard factorizes its slice
    locally.  Mesh result == single-device ``ops.granger
    .wavelet_granger`` for the same bank.  The data-axis size must
    divide T' (= ceil(N / time_decim)).
    """
    from ..ops.granger import _pairwise_jit
    from ..ops.cwt import cwt_from_bank
    e, c, n = sigs.shape
    t_idx = jnp.arange(0, n, time_decim)

    def local_cross(sig_shard, br):
        def step(acc, sig):
            w = cwt_from_bank(sig, br, interpolate)[..., t_idx]
            return acc + jnp.einsum("akt,bkt->tkab", w, jnp.conj(w)), None

        init = jnp.zeros((t_idx.shape[0], br.shape[0], c, c),
                         jnp.complex64)
        init = lax.pcast(init, (DATA_AXIS,), to="varying")
        cross, _ = lax.scan(step, init, sig_shard)
        cross = lax.psum(cross, DATA_AXIS) / e
        return jnp.real(cross), jnp.imag(cross)

    sr, si = jax.shard_map(
        local_cross, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(None, None)),
        out_specs=(P(), P()))(sigs, bank_r)

    from ..ops.granger import _pair_list
    pairs = _pair_list(c)

    def local_gc(sr_shard, si_shard):
        return _pairwise_jit(sr_shard, si_shard, jnp.asarray(pairs),
                             n_iter=n_iter)

    gc_pairs = jax.shard_map(
        local_gc, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS))(sr, si)
    # scatter pair planes into the (T', K, C, C) matrix (host-static
    # pair list, device data)
    k = bank_r.shape[0]
    out = jnp.zeros((sr.shape[0], k, c, c), jnp.float32)
    i, j = pairs[:, 0], pairs[:, 1]
    out = out.at[..., i, j].set(jnp.moveaxis(gc_pairs[..., 0], -2, -1))
    out = out.at[..., j, i].set(jnp.moveaxis(gc_pairs[..., 1], -2, -1))
    return out


@partial(jax.jit, static_argnames=("mesh", "orthogonalize", "interpolate",
                                   "log", "eps", "time_range"))
def sharded_env_corr(sigs, bank_r, *, mesh: Mesh,
                     orthogonalize: bool = True, interpolate: bool = False,
                     log: bool = True, eps: float = 1e-12,
                     time_range=None):
    """All-pairs power-envelope correlation over the mesh: (E, C, N) ->
    (F, C, C).

    The per-epoch Pearson correlations are local to each trial and the
    epoch MEAN is linear, so epochs shard over ``data`` (one ``pmean``)
    and bank rows over ``freq`` (row-independent scan).  Mesh result ==
    single-device ``ops.envelope.env_corr_matrix``."""
    from ..ops.envelope import env_corr_matrix_from_bank

    def local(sig, br):
        r = env_corr_matrix_from_bank(sig, br, orthogonalize, interpolate,
                                      log, eps, time_range)
        return lax.pmean(r, DATA_AXIS)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(DATA_AXIS), _BANK_SPEC),
        out_specs=P(FREQ_AXIS))(sigs, bank_r)


@partial(jax.jit, static_argnames=("mesh", "sfreq"))
def _sharded_stockwell_jit(signals_r, bins, *, mesh: Mesh, sfreq: float):
    from ..ops.stockwell import _stockwell_jit
    ndim = signals_r.ndim
    out_spec = P(DATA_AXIS, *([None] * (ndim - 2)), FREQ_AXIS, None)

    def local(sig, b):
        return _stockwell_jit(sig, b, sfreq=sfreq)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, *([None] * (ndim - 1))), P(FREQ_AXIS)),
        out_specs=(out_spec, out_spec))(signals_r, bins)


def sharded_stockwell(signals_r, freqs, *, mesh: Mesh, sfreq: float):
    """S-transform over the mesh: (E, ..., N) at the given analysis
    frequencies (Hz, validated to FFT bins in (0, Nyquist] like every
    other Stockwell surface) -> (real, imag) (E, ..., F, N) pairs,
    epochs sharded over ``data`` and frequency rows over ``freq`` —
    both axes embarrassingly parallel, no collective."""
    from ..ops.stockwell import _bins
    signals_r = jnp.asarray(signals_r)
    bins = _bins(freqs, signals_r.shape[-1], sfreq)
    return _sharded_stockwell_jit(signals_r, jnp.asarray(bins),
                                  mesh=mesh, sfreq=float(sfreq))


@partial(jax.jit, static_argnames=("mesh", "n_folds", "lam"))
def _sharded_tf_decode_jit(xa, xb, *, mesh: Mesh, n_folds: int,
                           lam: float):
    """Cross-validated TF decoding AUC over the mesh: (Ea, C, F, N) vs
    (Eb, C, F, N) -> (F, N).

    Every pixel's classifier is independent, so the frequency axis
    shards over ``freq`` with NO collectives (trials and channels
    replicate — the fold arithmetic needs every trial on each shard).
    Mesh result == single-device ``ops.decoding.tf_decode``."""
    from ..ops.decoding import _tf_decode_jit

    def local(a, b):
        return _tf_decode_jit(a, b, n_folds=n_folds, lam=lam,
                              vma_axes=(FREQ_AXIS,))

    spec = P(None, None, FREQ_AXIS, None)
    return jax.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                         out_specs=P(FREQ_AXIS, None))(xa, xb)


def sharded_tf_decode(xa, xb, *, mesh: Mesh, n_folds: int = 5,
                      lam: float = 1e-3):
    """Validated wrapper (same checks as ``ops.decoding.tf_decode`` —
    without them, trial counts below ``n_folds`` leave empty test folds
    whose zero AUC silently deflates the average)."""
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.ndim != 4 or xb.ndim != 4 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("expected (Ea, C, F, N) and (Eb, C, F, N) with "
                         "matching planes, got %s and %s"
                         % (xa.shape, xb.shape))
    if min(xa.shape[0], xb.shape[0]) < n_folds:
        raise ValueError("need at least n_folds trials per class")
    return _sharded_tf_decode_jit(xa, xb, mesh=mesh,
                                  n_folds=int(n_folds), lam=float(lam))


# --------------------------------------------------------------- HMM ----

_SHARDED_FN_CACHE: dict = {}


def _cache_put(key, fn):
    """Bounded insert: a sweep over many distinct configs must not
    accumulate live jitted shard_map wrappers without limit (each holds
    compiled code mappings; Linux caps a process at 65530)."""
    if len(_SHARDED_FN_CACHE) > 64:
        _SHARDED_FN_CACHE.clear()
    _SHARDED_FN_CACHE[key] = fn


def sharded_hmm_fit(x, *, mesh: Mesh, n_states: int, n_iter: int = 50,
                    stickiness: float = 0.9, seed: int = 0):
    """Mesh-parallel ``ops.hmm.hmm_fit``: sequences shard over the data
    axis, every EM sufficient statistic (state weights, moment matmuls,
    transition counts, initial-state mass, log-likelihood) is one
    ``psum``, so the fit is numerically the single-device EM with a
    different f32 reduction order.  Decoded ``gamma``/``states`` come
    back sharded over sequences; parameters are replicated.

    ``B`` must be divisible by the data-axis size.
    """
    from ..ops.hmm import (_VAR_FLOOR, _e_step, _init_params,
                           _viterbi_jit_body)
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 3:
        raise ValueError("expected (B, T, D) sequences")
    b, t, d = x.shape
    ndata = mesh.shape[DATA_AXIS]
    if b % ndata:
        raise ValueError(f"B={b} must be divisible by the data axis ({ndata})")
    k = int(n_states)

    # init must be mesh-invariant: computed once from the full block
    pi0, a0, means0, var0 = _init_params(
        x, jax.random.PRNGKey(seed), k, float(stickiness))

    # cache the jitted shard_map per (mesh, knobs): the EM scan trace is
    # expensive and a fresh shard_map per call would re-run it every time
    cache_key = ("hmm", mesh, k, int(n_iter), d)
    if cache_key in _SHARDED_FN_CACHE:
        out = _SHARDED_FN_CACHE[cache_key](x, pi0, a0, means0, var0)
        from ..ops.hmm import HMMResult
        return HMMResult(*out)

    def local(xl, pi0, a0, means0, var0):
        flat = xl.reshape(-1, d)
        hi = lax.Precision.HIGHEST

        def em(carry, _):
            pi, a, means, variances = carry
            gamma, xi, ll = jax.vmap(
                lambda seq: _e_step(seq, pi, a, means, variances))(xl)
            g = gamma.reshape(-1, k)
            nk = lax.psum(jnp.sum(g, 0), DATA_AXIS) + 1e-8
            m1 = lax.psum(jnp.matmul(g.T, flat, precision=hi),
                          DATA_AXIS)
            m2 = lax.psum(jnp.matmul(g.T, flat * flat, precision=hi),
                          DATA_AXIS)
            means = m1 / nk[:, None]
            variances = jnp.maximum(m2 / nk[:, None] - means * means,
                                    _VAR_FLOOR)
            xi_tot = lax.psum(jnp.sum(xi, 0), DATA_AXIS) + 1e-8
            a = xi_tot / jnp.sum(xi_tot, 1, keepdims=True)
            pi = lax.psum(jnp.sum(gamma[:, 0, :], 0), DATA_AXIS) + 1e-8
            pi = pi / jnp.sum(pi)
            return (pi, a, means, variances), lax.psum(jnp.sum(ll),
                                                       DATA_AXIS)

        (pi, a, means, variances), ll_trace = lax.scan(
            em, (pi0, a0, means0, var0), None, length=int(n_iter))
        gamma, _, _ = jax.vmap(
            lambda seq: _e_step(seq, pi, a, means, variances))(xl)
        states = jax.vmap(lambda seq: _viterbi_jit_body(
            seq, pi, a, means, variances))(xl)
        return pi, a, means, variances, gamma, states, ll_trace

    rep = P()
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS), rep, rep, rep, rep),
        out_specs=(rep, rep, rep, rep, P(DATA_AXIS), P(DATA_AXIS), rep)))
    _cache_put(cache_key, fn)
    out = fn(x, pi0, a0, means0, var0)
    from ..ops.hmm import HMMResult
    return HMMResult(*out)


# ------------------------------------------------------------ FastICA ----

def sharded_fastica(x, *, mesh: Mesh, n_components: int | None = None,
                    fun: str = "logcosh", n_iter: int = 200,
                    seed: int = 0):
    """Mesh-parallel ``ops.ica.fastica``: SAMPLES shard over the data
    axis (the natural split for one long recording) — the channel
    covariance, the nonlinearity moment matmuls, and the derivative
    means are each one ``psum``; the K x K eigendecompositions run
    replicated.  Returns an ``ICAResult`` whose ``sources`` are sharded
    over time; ``N`` must be divisible by the data-axis size.
    """
    from ..ops.ica import (ICAResult, _finalize_components,
                           _ica_step, _sym_decorrelate,
                           _whiten_from_cov)
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("expected (channels, samples)")
    c, n = x.shape
    ndata = mesh.shape[DATA_AXIS]
    if n % ndata:
        raise ValueError(f"N={n} must be divisible by the data axis ({ndata})")
    k = c if n_components is None else int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, channels]")
    if fun not in ("logcosh", "exp", "cube"):
        raise ValueError("fun must be 'logcosh', 'exp' or 'cube'")
    hi = lax.Precision.HIGHEST
    w_init = _sym_decorrelate(jax.random.normal(
        jax.random.PRNGKey(seed), (k, k), jnp.float32))

    cache_key = ("ica", mesh, k, fun, int(n_iter), c, n)
    if cache_key in _SHARDED_FN_CACHE:
        return ICAResult(*_SHARDED_FN_CACHE[cache_key](x, w_init))

    def local(xl, w0):
        # only the two data-axis moments differ from ops.ica: they
        # complete with psum; whitening, the fixed-point step algebra,
        # and the order/sign conventions are the SHARED helpers
        mean = lax.psum(jnp.sum(xl, axis=1), DATA_AXIS) / n
        xc = xl - mean[:, None]
        cov = lax.psum(jnp.matmul(xc, xc.T, precision=hi), DATA_AXIS) / n
        whiten, z, e_top, s_top = _whiten_from_cov(cov, xc, k, hi)

        def step(w, _):
            return _ica_step(
                w, z, fun, n,
                reduce_m=lambda m: lax.psum(m, DATA_AXIS),
                reduce_gp=lambda g: lax.psum(g, DATA_AXIS),
                precision=hi)

        w, conv = lax.scan(step, w0, None, length=int(n_iter))
        unmixing, mixing, sources = _finalize_components(
            w, whiten, e_top, s_top, xc, hi)
        return unmixing, mixing, mean, sources, conv

    rep = P()
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(None, DATA_AXIS), rep),
        out_specs=(rep, rep, rep, P(None, DATA_AXIS), rep)))
    _cache_put(cache_key, fn)
    return ICAResult(*fn(x, w_init))


def sharded_covariance(x, *, mesh: Mesh) -> jnp.ndarray:
    """Mesh-parallel ``ops.spatial.covariance``: epochs shard over the
    data axis; each shard accumulates its per-epoch-centered (C, C)
    covariance sum and ONE ``psum`` pools them — bit-identical to the
    single-device pooled estimate (per-epoch statistics make the shard
    split exact, no cross-shard moments).  E must be divisible by the data
    axis."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 3:
        raise ValueError("expected (E, C, N)")
    e, c, n = x.shape
    ndata = mesh.shape[DATA_AXIS]
    if e % ndata:
        raise ValueError(f"E={e} must be divisible by the data axis ({ndata})")
    hi = lax.Precision.HIGHEST

    # keyed on the MESH only: the local fn reads shapes off its shard
    # (global E = local * ndata is trace-static), so jit's own per-shape
    # cache handles new (E, C, N) without a new wrapper per shape — a
    # shape-keyed entry per sweep point was a live-executable leak
    cache_key = ("spatial_cov", mesh)
    if cache_key not in _SHARDED_FN_CACHE:
        def local(xl):
            el, cl, nl = xl.shape
            xc = xl - jnp.mean(xl, axis=2, keepdims=True)
            # flat (C, E_local*N) matmul — see ops.spatial.covariance
            y = xc.transpose(1, 0, 2).reshape(cl, -1)
            s = jnp.matmul(y, y.T, precision=hi)
            return lax.psum(s, DATA_AXIS) / jnp.float32(
                el * ndata * (nl - 1))

        _cache_put(cache_key, jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P(DATA_AXIS, None, None),),
            out_specs=P())))
    return _SHARDED_FN_CACHE[cache_key](x)


def sharded_csp(xa, xb, *, mesh: Mesh, n_components: int = 4,
                shrink: float = 0.01):
    """Mesh-parallel ``ops.spatial.csp``: both class covariances pool
    over epoch shards (``sharded_covariance``); the tiny C x C
    generalized eigensolve runs replicated on host-visible arrays.
    No bandpass here — filter before sharding if needed."""
    from ..ops.spatial import _csp_from_covs
    xa = jnp.asarray(xa, jnp.float32)
    xb = jnp.asarray(xb, jnp.float32)
    if xa.ndim != 3 or xb.ndim != 3 or xa.shape[1:] != xb.shape[1:]:
        raise ValueError("xa/xb must be (E, C, N) with matching (C, N)")
    c = xa.shape[1]
    k = int(n_components)
    if not (1 <= k <= c):
        raise ValueError("n_components must be in [1, C]")
    ca = sharded_covariance(xa, mesh=mesh)
    cb = sharded_covariance(xb, mesh=mesh)
    return _csp_from_covs(ca, cb, k, float(shrink))
