"""Canonical Polyadic (PARAFAC) decomposition of time-frequency tensors
(Harshman 1970; Kolda & Bader, SIAM Rev. 2009).  No reference
counterpart — this is the ERPWAVELAB-style multiway analysis (Morup et
al., J. Neurosci. Methods 2007): a (channel x frequency x time) or
(epoch x frequency x time) power/ITPC tensor factors into rank-R
components, each an outer product of a spatial signature, a spectral
signature, and a temporal envelope.

Design notes:
* every ALS step is an MTTKRP, expressed directly as one ``einsum``
  over the DENSE tensor (no unfolding copies, no Khatri-Rao
  materialization) — XLA contracts it as one dense product;
* the normal equations are R x R (R is single/double digits): solved
  with a Cholesky-friendly ``jnp.linalg.solve`` on device;
* the iteration count is static (``lax.scan``); convergence is reported
  as the final relative fit, computed from the factor Grams and the
  last MTTKRP (never re-materializing the reconstruction);
* ``nonneg=True`` swaps the solve for HALS column updates (Cichocki &
  Phan 2009) — closed-form per column, still nothing but matmuls — the
  right mode for power tensors, which are nonnegative by construction;
* deterministic random init from a PRNG seed (uniform for the
  nonnegative mode), columns renormalized every sweep with the scale
  absorbed into the weight vector.
"""
from __future__ import annotations

import string
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["cp_decompose", "cp_reconstruct"]


_HI = jax.lax.Precision.HIGHEST


def _mttkrp(x, factors, mode):
    """einsum('ijk,jr,kr->ir', x, B, C)-style MTTKRP for any ndim.

    Precision.HIGHEST throughout: the fit metric cancels three
    O(||X||^2) terms, and a DEFAULT-precision matmul (TF32 on a GPU,
    ~1e-3 rel err) would swamp the residual of any model
    with fit > ~0.93 (and degrade the ALS normal equations)."""
    nd = x.ndim
    letters = string.ascii_lowercase[:nd]
    ins = [letters]
    ops = [x]
    for m in range(nd):
        if m == mode:
            continue
        ins.append(letters[m] + "r")
        ops.append(factors[m])
    return jnp.einsum(",".join(ins) + "->" + letters[mode] + "r", *ops,
                      precision=_HI)


def _gram_product(factors, skip):
    v = None
    for m, f in enumerate(factors):
        if m == skip:
            continue
        g = jnp.matmul(f.T, f, precision=_HI)
        v = g if v is None else v * g
    return v


@partial(jax.jit, static_argnames=("rank", "n_iter", "nonneg", "shape",
                                   "ridge"))
def _cp_jit(x, key, *, rank, n_iter, nonneg, shape, ridge):
    nd = len(shape)
    keys = jax.random.split(key, nd)
    if nonneg:
        factors = [jax.random.uniform(keys[m], (shape[m], rank),
                                      jnp.float32, 0.1, 1.0)
                   for m in range(nd)]
    else:
        factors = [jax.random.normal(keys[m], (shape[m], rank),
                                     jnp.float32) for m in range(nd)]
    eye = jnp.eye(rank, dtype=jnp.float32)

    def sweep(carry, _):
        factors = list(carry)
        for mode in range(nd):
            m = _mttkrp(x, factors, mode)            # (I_mode, R)
            v = _gram_product(factors, mode)         # (R, R)
            if nonneg:
                a = factors[mode]
                for r in range(rank):
                    num = m[:, r] - a @ v[:, r] + a[:, r] * v[r, r]
                    a = a.at[:, r].set(jnp.maximum(
                        num / jnp.maximum(v[r, r], 1e-12), 1e-12))
                factors[mode] = a
            else:
                factors[mode] = jnp.linalg.solve(
                    v + ridge * eye, m.T).T
            # renormalize all but the last mode (it keeps the scale)
            if mode != nd - 1:
                norm = jnp.maximum(jnp.linalg.norm(
                    factors[mode], axis=0, keepdims=True), 1e-12)
                factors[mode] = factors[mode] / norm
                factors[nd - 1] = factors[nd - 1] * norm
        return tuple(factors), None

    factors, _ = lax.scan(sweep, tuple(factors), None, length=n_iter)
    factors = list(factors)

    # fit from Grams: ||X-Xh||^2 = ||X||^2 - 2<X,Xh> + ||Xh||^2, with
    # <X,Xh> = sum(MTTKRP_last * last factor) and
    # ||Xh||^2 = 1^T (hadamard of all Grams) 1.
    m_last = _mttkrp(x, factors, nd - 1)
    inner = jnp.sum(m_last * factors[nd - 1])
    vfull = _gram_product(factors, nd - 1) * jnp.matmul(
        factors[nd - 1].T, factors[nd - 1], precision=_HI)
    norm_xh2 = jnp.sum(vfull)
    norm_x2 = jnp.sum(x * x)
    resid2 = jnp.maximum(norm_x2 - 2.0 * inner + norm_xh2, 0.0)
    fit = 1.0 - jnp.sqrt(resid2) / jnp.maximum(jnp.sqrt(norm_x2), 1e-30)

    # final form: unit-norm columns everywhere, scale in the weights
    weights = jnp.ones((rank,), jnp.float32)
    for mode in range(nd):
        norm = jnp.maximum(jnp.linalg.norm(factors[mode], axis=0), 1e-12)
        factors[mode] = factors[mode] / norm
        weights = weights * norm
    order = jnp.argsort(-weights)
    weights = weights[order]
    factors = [f[:, order] for f in factors]
    return weights, tuple(factors), fit


def cp_decompose(tensor, rank: int, n_iter: int = 100,
                 nonneg: bool = False, seed: int = 0,
                 ridge: float = 1e-6):
    """``(weights, factors, fit)`` — rank-``rank`` CP/PARAFAC model of a
    dense >=2-way float tensor: ``tensor ~= sum_r weights[r] *
    outer(factors[0][:, r], factors[1][:, r], ...)``.

    Factor columns are unit-norm, components sorted by descending
    weight; ``fit`` is ``1 - ||X - Xhat|| / ||X||`` (1 = perfect).
    ``nonneg=True`` runs HALS nonnegative updates (use for power/ITPC
    tensors); ``n_iter`` is the fixed ALS sweep count (static).
    """
    x = jnp.asarray(tensor, jnp.float32)
    if x.ndim < 2:
        raise ValueError("CP needs a tensor of >= 2 modes")
    if rank < 1 or rank > min(x.shape):
        # rank > min dim is legal for CP in general but pointless for
        # the TF use cases here and destabilizes ALS; refuse loudly.
        raise ValueError("rank must be in [1, min(tensor.shape)]")
    w, facs, fit = _cp_jit(
        x, jax.random.PRNGKey(seed), rank=int(rank), n_iter=int(n_iter),
        nonneg=bool(nonneg), shape=tuple(int(s) for s in x.shape),
        ridge=float(ridge))
    return w, list(facs), fit


def cp_reconstruct(weights, factors):
    """Dense tensor from a CP model (inverse of ``cp_decompose``)."""
    nd = len(factors)
    letters = string.ascii_lowercase[:nd]
    ins = ["r"] + [letters[m] + "r" for m in range(nd)]
    return jnp.einsum(",".join(ins) + "->" + letters,
                      jnp.asarray(weights, jnp.float32),
                      *[jnp.asarray(f, jnp.float32) for f in factors],
                      precision=_HI)
