"""Bootstrap confidence intervals for trial-averaged planes (percentile
bootstrap over epochs): how stable is this TFR / ITC / spectrum given
the trials at hand?

No reference counterpart.  Layout: a bootstrap replicate's mean is a
weighted trial average, so ALL replicates are one (B, E) @ (E, plane)
matmul contraction — the same chunked-matmul recipe as the cluster
permutation nulls; the per-pixel percentile is a sort over the (small)
replicate axis, streamed in chunks so device memory holds ``chunk`` replicate
planes at a time.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["bootstrap_ci"]

_CHUNK = 64


@partial(jax.jit, static_argnames=("n_boot", "lower", "upper", "chunk"))
def _boot_jit(x, key, *, n_boot, lower, upper, chunk):
    e = x.shape[0]
    xf = x.reshape(e, -1)
    n_chunks = -(-n_boot // chunk)
    counts = jax.vmap(
        lambda k: jnp.bincount(jax.random.randint(k, (e,), 0, e),
                               length=e))(
        jax.random.split(key, n_chunks * chunk)).astype(jnp.float32)
    counts = counts.reshape(n_chunks, chunk, e) / e

    def step(_, k):
        return 0, jnp.matmul(counts[k], xf,
                             precision=jax.lax.Precision.HIGHEST)

    means = lax.scan(step, 0, jnp.arange(n_chunks))[1]
    means = means.reshape(-1, xf.shape[-1])[:n_boot]
    lo = jnp.quantile(means, lower, axis=0)
    hi = jnp.quantile(means, upper, axis=0)
    return (lo.reshape(x.shape[1:]), hi.reshape(x.shape[1:]))


def bootstrap_ci(trials, alpha: float = 0.05, n_boot: int = 1000,
                 seed: int = 0):
    """``(lower, upper)`` percentile-bootstrap confidence bounds for the
    trial mean of (E, ...) per-trial planes (e.g. single-trial power):
    resample trials with replacement ``n_boot`` times (each replicate's
    mean is one row of a counts-matrix contraction), take the
    ``alpha/2`` and ``1 - alpha/2`` per-pixel quantiles.
    """
    trials = jnp.asarray(trials, jnp.float32)
    if trials.ndim < 2 or trials.shape[0] < 2:
        raise ValueError("expected (epochs >= 2, ...), got %s"
                         % (trials.shape,))
    return _boot_jit(trials, jax.random.PRNGKey(seed),
                     n_boot=int(n_boot), lower=float(alpha / 2.0),
                     upper=float(1.0 - alpha / 2.0), chunk=_CHUNK)
