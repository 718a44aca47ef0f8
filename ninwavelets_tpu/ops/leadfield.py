"""Analytic EEG forward model: current dipole in a homogeneous
conducting sphere.

No reference counterpart — this makes the source-space tools
(``ops/beamformer.py``: LCMV / DICS / minimum norm) self-contained: the
user supplies electrode positions and source grid, not a leadfield from
another package.  The model is the classical insulated homogeneous
sphere (the textbook EEG forward problem; see e.g. Mosher, Leahy &
Lewis 1999, IEEE TBME 46:245 for the family of sphere models): exact
series solution, no numerical PDE.

Math.  For a dipole ``q`` at radius ``b`` inside a sphere of radius
``R`` and conductivity ``sigma`` (air outside — insulating boundary),
the surface potential at electrode direction ``r_e`` is

    V = 1/(4 pi sigma R^2) * sum_{n>=1} (2n+1)/n * f^(n-1)
        * [ n (q . r0_hat) P_n(c)  +  (q . (r_e_hat - c r0_hat)) P_n'(c) ]

with ``f = b/R``, ``c = cos(angle(r0, r_e))``.  The tangential term is
written with the UNNORMALIZED in-plane vector ``r_e_hat - c r0_hat``
so the usual ``1/sin`` of the associated Legendre route cancels
analytically — no singularity at electrodes collinear with the source.
The center-dipole limit (only n=1 survives) is the known
``V = 3 (q . r_hat) / (4 pi sigma R^2)``, anchored in the tests next to
an independent z-axis/associated-Legendre oracle, zero-mean and
rotation-equivariance identities, and an end-to-end LCMV localization.

Design: Legendre ``P_n`` / ``P_n'`` ride one ``lax.scan`` over the
term index with (E, S) planes as carry (Bonnet recurrences), the
orientation axis is one einsum, everything float32-safe because the
series is scaled by ``f^(n-1) <= 1`` (eccentricity is validated < 0.95
where ~200 terms give ~1e-6 tails).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["sphere_leadfield", "fibonacci_electrodes", "source_grid"]


@partial(jax.jit, static_argnames=("n_terms",))
def _series_jit(re_hat, r0_hat, f, *, n_terms):
    """(E, S, 3) leadfield series for unit dipoles along x/y/z.

    ``re_hat`` (E, 3) unit electrode directions, ``r0_hat`` (S, 3) unit
    source directions, ``f`` (S,) eccentricities b/R in [0, 1).
    Returns the bracketed sum — caller applies 1/(4 pi sigma R^2).
    """
    c = jnp.einsum("ek,sk->es", re_hat, r0_hat,
                   precision=lax.Precision.HIGHEST)      # cos gamma
    # tangential geometry vector t = re - c r0 (E, S, 3), radial r0
    t = re_hat[:, None, :] - c[..., None] * r0_hat[None, :, :]

    def step(carry, n):
        p_nm1, p_n, dp_nm1, dp_n, fpow, acc_r, acc_t = carry
        nf = n.astype(jnp.float32)
        # Bonnet: (n+1) P_{n+1} = (2n+1) c P_n - n P_{n-1}
        p_np1 = ((2 * nf + 1) * c * p_n - nf * p_nm1) / (nf + 1)
        # derivative recurrence: P'_{n+1} = P'_{n-1} + (2n+1) P_n
        dp_np1 = dp_nm1 + (2 * nf + 1) * p_n
        # term n+1 of the sum, weighted
        m = nf + 1
        w = (2 * m + 1) / m * fpow                       # (S,)
        acc_r = acc_r + w[None, :] * m * p_np1
        acc_t = acc_t + w[None, :] * dp_np1
        fpow = fpow * f
        return (p_n, p_np1, dp_n, dp_np1, fpow, acc_r, acc_t), None

    # n = 1 terms seeded directly: P_1 = c, P_1' = 1, weight 3 f^0
    p0 = jnp.ones_like(c)
    p1 = c
    dp0 = jnp.zeros_like(c)
    dp1 = jnp.ones_like(c)
    acc_r = 3.0 * p1                                      # 3 * 1 * P_1
    acc_t = 3.0 * dp1
    fpow = f                                              # f^(n-1), n=2
    carry = (p0, p1, dp0, dp1, fpow, acc_r, acc_t)
    carry, _ = lax.scan(step, carry,
                        jnp.arange(1, n_terms, dtype=jnp.int32))
    acc_r, acc_t = carry[5], carry[6]
    # assemble per orientation: acc_r couples to (q . r0), acc_t to
    # (q . t) — one broadcastized outer product over the xyz axis
    return (acc_r[..., None] * r0_hat[None, :, :]
            + acc_t[..., None] * t)


def sphere_leadfield(elec_pos, src_pos, radius: float | None = None,
                     sigma: float = 0.33, n_terms: int = 200,
                     orientation=None):
    """EEG leadfield of a homogeneous conducting sphere.

    Args:
      elec_pos: (E, 3) electrode positions.  They are projected onto
        the sphere surface (only their directions matter — scalp
        electrodes sit ON the boundary).
      src_pos: (S, 3) dipole positions INSIDE the sphere (eccentricity
        must stay below 0.95 — the series needs ~1/(1-f) terms).
      radius: sphere radius; default = the mean electrode radius.
      sigma: conductivity in S/m (0.33 = the standard scalp/brain
        value).
      n_terms: series truncation (error ~ f^n_terms).
      orientation: optional (S, 3) fixed dipole orientations — returns
        (E, S).  Default returns the free-orientation (E, S, 3)
        leadfield feeding ``ops.lcmv`` / ``ops.minimum_norm`` directly.

    Returns:
      (E, S, 3) — potential at each electrode for unit x/y/z dipoles —
      or (E, S) with ``orientation``.  Potentials are zero-mean over a
      dense uniform electrode layout (all n >= 1 harmonics integrate to
      zero on the sphere).
    """
    elec = np.asarray(elec_pos, np.float64)
    src = np.asarray(src_pos, np.float64)
    if elec.ndim != 2 or elec.shape[1] != 3:
        raise ValueError("elec_pos must be (E, 3)")
    if src.ndim != 2 or src.shape[1] != 3:
        raise ValueError("src_pos must be (S, 3)")
    er = np.linalg.norm(elec, axis=1)
    if np.any(er <= 0):
        raise ValueError("electrode at the origin")
    r = float(radius) if radius is not None else float(er.mean())
    if r <= 0:
        raise ValueError("radius must be positive")
    re_hat = elec / er[:, None]
    b = np.linalg.norm(src, axis=1)
    f = b / r
    if np.any(f >= 0.95):
        raise ValueError(
            f"source eccentricity up to {f.max():.3f} — the series "
            "model needs |src| < 0.95 * radius")
    # a source exactly at the origin has no direction; nudge the unit
    # vector arbitrarily (f = 0 kills every tangential/radial
    # difference: only the n=1 isotropic term survives)
    safe_b = np.where(b > 0, b, 1.0)
    r0_hat = src / safe_b[:, None]
    r0_hat[b == 0] = np.array([0.0, 0.0, 1.0])
    lf = _series_jit(jnp.asarray(re_hat, jnp.float32),
                     jnp.asarray(r0_hat, jnp.float32),
                     jnp.asarray(f, jnp.float32),
                     n_terms=int(n_terms))
    lf = lf / jnp.float32(4.0 * np.pi * float(sigma) * r * r)
    if orientation is not None:
        ori = np.asarray(orientation, np.float64)
        if ori.shape != src.shape:
            raise ValueError("orientation must match src_pos (S, 3)")
        ori = ori / np.maximum(
            np.linalg.norm(ori, axis=1, keepdims=True), 1e-30)
        return jnp.einsum("esk,sk->es", lf,
                          jnp.asarray(ori, jnp.float32),
                          precision=lax.Precision.HIGHEST)
    return lf


def fibonacci_electrodes(n: int, radius: float = 0.09,
                         upper_only: bool = True) -> np.ndarray:
    """(n, 3) quasi-uniform electrode layout on the sphere (Fibonacci
    lattice); ``upper_only`` keeps the z > 0 hemisphere convention of a
    real EEG cap (the lattice is built on the hemisphere directly)."""
    if n < 1:
        raise ValueError("need at least one electrode")
    i = np.arange(n) + 0.5
    golden = (1 + 5 ** 0.5) / 2
    phi = 2 * np.pi * i / golden
    z = (i / n) if upper_only else (1 - 2 * i / n)
    s = np.sqrt(np.maximum(1 - z * z, 0.0))
    return (radius
            * np.stack([s * np.cos(phi), s * np.sin(phi), z], 1))


def source_grid(radius: float = 0.09, spacing: float = 0.015,
                max_eccentricity: float = 0.85) -> np.ndarray:
    """(S, 3) cubic source grid inside the sphere (the volumetric
    source space for LCMV/DICS scans)."""
    lim = radius * max_eccentricity
    ax = np.arange(-lim, lim + spacing / 2, spacing)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    g = g.reshape(-1, 3)
    return g[np.linalg.norm(g, axis=1) <= lim]


__all__.append("fit_dipole")


@partial(jax.jit, static_argnames=("n_terms",))
def _scan_grid_jit(v, re_hat, r0_hat, f, scale, *, n_terms):
    """Residual sum of squares of the best-moment dipole at every grid
    point: q* = argmin ||v - L q|| solved per point as a tiny (3, 3)
    system (HIGHEST — the Gram is near-singular for deep sources)."""
    lf = _series_jit(re_hat, r0_hat, f, n_terms=n_terms) * scale
    # average-reference the MODEL too: v is centered, and the sphere
    # potential is zero-mean only over the FULL sphere, not a cap
    lf = lf - jnp.mean(lf, axis=0, keepdims=True)
    return _grid_rss(lf, v)


def _grid_rss(lf, v):
    """Best closed-form moment per source and its residual: (S,) rss,
    (S, 3) q for an (E, S, 3) leadfield stack (shared by the EEG and
    MEG grid scans)."""
    hi = lax.Precision.HIGHEST
    g = jnp.einsum("esk,esl->skl", lf, lf, precision=hi)
    b = jnp.einsum("esk,e->sk", lf, v, precision=hi)
    g = g + 1e-6 * jnp.trace(g, axis1=-2, axis2=-1)[:, None, None] \
        * jnp.eye(3)
    q = jnp.linalg.solve(g, b[..., None])[..., 0]
    fit = jnp.einsum("esk,sk->es", lf, q, precision=hi)
    rss = jnp.sum((v[:, None] - fit) ** 2, axis=0)
    return rss, q


def _adam_position(loss, p0, max_b, n_steps, lr):
    """Adam on a 3-vector position with a norm clamp into (0, max_b];
    ``loss(p) -> (val, q)``.  Called INSIDE a jit (traced); shared by
    the EEG and MEG refinements so the optimizer mechanics cannot
    drift apart."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(carry, i):
        p, m, s2 = carry
        (val, _), grad = jax.value_and_grad(loss, has_aux=True)(p)
        m = b1 * m + (1 - b1) * grad
        s2 = b2 * s2 + (1 - b2) * grad * grad
        mh = m / (1 - b1 ** (i + 1.0))
        sh = s2 / (1 - b2 ** (i + 1.0))
        p = p - lr * mh / (jnp.sqrt(sh) + eps)
        b = jnp.linalg.norm(p)
        p = jnp.where(b > max_b, p * (max_b / b), p)
        # and away from the origin — both models are degenerate there
        # (EEG loses the source direction, MEG is silent) and the
        # normalization gradients NaN at exactly zero
        p = jnp.where(b < 1e-3 * max_b,
                      p + 1e-3 * max_b * jnp.array([0.0, 0.0, 1.0]), p)
        return (p, m, s2), val

    init = (p0, jnp.zeros(3), jnp.zeros(3))
    (p, _, _), hist = lax.scan(step, init,
                               jnp.arange(n_steps, dtype=jnp.float32))
    val, q = loss(p)
    return p, q, val, hist


@partial(jax.jit, static_argnames=("n_terms", "n_steps"))
def _refine_jit(v, re_hat, p0, scale, max_f, *, n_terms, n_steps):
    """Adam refinement of the dipole POSITION (unit-sphere units);
    the moment is re-solved in closed form inside the loss, so the
    gradient flows through the Legendre scan only via the geometry."""

    def loss(p):
        b = jnp.linalg.norm(p)
        fe = jnp.minimum(b, max_f)
        r0 = p / jnp.maximum(b, 1e-12)
        lf = _series_jit(re_hat, r0[None, :], fe[None],
                         n_terms=n_terms)[:, 0, :] * scale   # (E, 3)
        lf = lf - jnp.mean(lf, axis=0, keepdims=True)     # avg ref
        g = jnp.matmul(lf.T, lf, precision=lax.Precision.HIGHEST)
        # 1e-6 relative: a 1e-12 floor is below f32 resolution and is
        # a no-op exactly in the rank-deficient cases it exists for
        g = g + 1e-6 * jnp.trace(g) * jnp.eye(3)
        q = jnp.linalg.solve(
            g, jnp.matmul(lf.T, v, precision=lax.Precision.HIGHEST))
        r = v - jnp.matmul(lf, q, precision=lax.Precision.HIGHEST)
        return jnp.sum(r * r), q

    return _adam_position(loss, p0, max_f, n_steps, lr=3e-3)


def fit_dipole(v, elec_pos, radius: float | None = None,
               sigma: float = 0.33, spacing: float = 0.01,
               n_terms: int = 120, n_steps: int = 200,
               max_eccentricity: float = 0.90):
    """Single equivalent-current-dipole fit of a topography (mne's
    ``fit_dipole`` for the spherical head).

    Two stages, both on device: a coarse grid scan (best closed-form
    moment per grid point — batched 3x3 solves), then Adam refinement
    of the position THROUGH the differentiable Legendre series (the
    moment stays a closed-form inner solve, so only 3 parameters are
    optimized).  ``v`` is the (E,) sensor topography (average-referenced
    internally — sphere potentials are defined up to a constant).

    Returns a dict: ``pos`` (3,), ``moment`` (3,), ``gof`` in [0, 1]
    (goodness of fit, 1 - rss/||v||^2), ``grid_pos`` (the stage-1
    winner, for sanity checks).
    """
    v = np.asarray(v, np.float64)
    if v.ndim != 1:
        raise ValueError("v must be a single (E,) topography")
    elec = np.asarray(elec_pos, np.float64)
    if elec.shape != (v.shape[0], 3):
        raise ValueError("elec_pos must be (E, 3) matching v")
    er = np.linalg.norm(elec, axis=1)
    if np.any(er <= 0):
        raise ValueError("electrode at the origin")
    if not 0 < max_eccentricity < 0.95:
        raise ValueError("max_eccentricity must be in (0, 0.95) — the "
                         "series diverges beyond")
    r = float(radius) if radius is not None else float(er.mean())
    if r <= 0:
        raise ValueError("radius must be positive")
    re_hat = elec / er[:, None]
    v = v - v.mean()
    vn = float(np.linalg.norm(v))
    if vn == 0:
        raise ValueError("zero topography")
    grid = source_grid(r, spacing=spacing,
                       max_eccentricity=max_eccentricity)
    b = np.linalg.norm(grid, axis=1)
    r0 = np.where(b[:, None] > 0,
                  grid / np.maximum(b[:, None], 1e-30),
                  [0.0, 0.0, 1.0])
    scale = 1.0 / (4.0 * np.pi * float(sigma) * r * r)
    vj = jnp.asarray(v / vn, jnp.float32)
    rss, _ = _scan_grid_jit(vj, jnp.asarray(re_hat, jnp.float32),
                            jnp.asarray(r0, jnp.float32),
                            jnp.asarray(b / r, jnp.float32),
                            jnp.float32(scale), n_terms=int(n_terms))
    best = int(jnp.argmin(rss))
    p0 = jnp.asarray(grid[best] / r, jnp.float32)
    p, q, val, _ = _refine_jit(vj, jnp.asarray(re_hat, jnp.float32),
                               p0, jnp.float32(scale),
                               jnp.float32(max_eccentricity),
                               n_terms=int(n_terms),
                               n_steps=int(n_steps))
    gof = 1.0 - float(val)           # v was unit-normalized
    return {"pos": np.asarray(p, np.float64) * r,
            "moment": np.asarray(q, np.float64) * vn,
            "gof": gof,
            "grid_pos": grid[best]}


__all__.append("fit_dipole_evoked")


def fit_dipole_evoked(v_ts, elec_pos, radius: float | None = None,
                      sigma: float = 0.33, **kw):
    """Dipole model of an evoked time series (mne's ``fit_dipole`` on
    an Evoked): the POSITION is fitted once on the peak-GFP topography
    (where SNR is best), then the moment time course is the closed-form
    least-squares solve of the fixed (E, 3) leadfield against every
    sample — one (3, E) @ (E, T) matmul.

    ``v_ts`` is (E, T).  Returns the ``fit_dipole`` dict plus
    ``moment_ts`` (3, T), ``amplitude`` (T,) moment norms, ``gof_ts``
    (T,) per-sample goodness of fit, and ``peak_sample``.
    """
    v_ts = np.asarray(v_ts, np.float64)
    if v_ts.ndim != 2:
        raise ValueError("v_ts must be (E, T)")
    vc = v_ts - v_ts.mean(axis=0, keepdims=True)
    gfp = vc.std(axis=0)
    peak = int(np.argmax(gfp))
    res = fit_dipole(v_ts[:, peak], elec_pos, radius=radius,
                     sigma=sigma, **kw)
    # the SAME truncation as the position fit — a different n_terms
    # would make res["gof"] and gof_ts[peak_sample] disagree
    lf = np.asarray(sphere_leadfield(
        elec_pos, res["pos"][None], radius=radius, sigma=sigma,
        n_terms=int(kw.get("n_terms", 120))))[:, 0, :]
    lf = lf - lf.mean(axis=0, keepdims=True)
    g = lf.T @ lf + 1e-12 * np.trace(lf.T @ lf) * np.eye(3)
    q_ts = np.linalg.solve(g, lf.T @ vc)                   # (3, T)
    fit = lf @ q_ts
    rss = np.sum((vc - fit) ** 2, axis=0)
    tot = np.maximum(np.sum(vc * vc, axis=0), 1e-30)
    res.update(moment_ts=q_ts,
               amplitude=np.linalg.norm(q_ts, axis=0),
               gof_ts=1.0 - rss / tot, peak_sample=peak)
    return res


__all__.append("sphere_leadfield_meg")

_MU0 = 4e-7 * np.pi


@jax.jit
def _sarvas_jit(r, n_hat, r0):
    """(E, S, 3) MEG leadfield via the Sarvas (1987, eq. 25) closed
    form: for a dipole q at r0 inside ANY spherically symmetric
    conductor, the external field is B = mu0/(4 pi F^2) *
    (F (q x r0) - ((q x r0) . r) grad F), with

        F = a (r a + r^2 - r0 . r),    a_vec = r - r0
        grad F = (a^2/r + a.r/a + 2a + 2r) r_vec
                 - (a + 2r + a.r/a) r0.

    ``q x r0`` is linear in q, so the three unit-dipole columns come
    from one cross-product matrix.  Everything broadcasts over
    (E, S) pairs; sensor reading is B . n_hat.
    """
    hi = jax.lax.Precision.HIGHEST
    av = r[:, None, :] - r0[None, :, :]                  # (E, S, 3)
    a = jnp.linalg.norm(av, axis=-1)                     # (E, S)
    rn = jnp.linalg.norm(r, axis=-1)[:, None]            # (E, 1)
    adr = jnp.einsum("esk,ek->es", av, r, precision=hi)  # a . r
    r0dr = jnp.einsum("sk,ek->es", r0, r, precision=hi)  # r0 . r
    f = a * (rn * a + rn * rn - r0dr)
    gf = ((a * a / rn + adr / a + 2 * a + 2 * rn)[..., None]
          * r[:, None, :]
          - (a + 2 * rn + adr / a)[..., None] * r0[None, :, :])
    # q x r0 for unit q along x/y/z: rows of the cross matrix
    # (e_k x r0)_j = -eps_{kjl} r0_l -> stack the three columns
    zeros = jnp.zeros_like(r0[:, 0])
    qxr0 = jnp.stack([
        jnp.stack([zeros, r0[:, 2], -r0[:, 1]], -1),      # e_x x r0
        jnp.stack([-r0[:, 2], zeros, r0[:, 0]], -1),      # e_y x r0
        jnp.stack([r0[:, 1], -r0[:, 0], zeros], -1),      # e_z x r0
    ], 0)                                                 # (3, S, 3)
    num = (f[..., None, None] * qxr0[None].transpose(0, 2, 1, 3)
           - jnp.einsum("qsk,ek->esq", qxr0, r,
                        precision=hi)[..., None] * gf[:, :, None, :])
    b = num * (_MU0 / (4 * np.pi)) / (f * f)[..., None, None]
    return jnp.einsum("esqk,ek->esq", b, n_hat, precision=hi)


def sphere_leadfield_meg(sensor_pos, sensor_ori, src_pos,
                         orientation=None):
    """MEG leadfield of a spherically symmetric conductor (Sarvas).

    Args:
      sensor_pos: (E, 3) magnetometer positions OUTSIDE the source
        region (each |pos| must exceed every source radius).
      sensor_ori: (E, 3) pickup-coil orientations (normalized
        internally) — the returned value is ``B . ori`` in tesla per
        A*m of dipole moment.
      src_pos: (S, 3) dipole positions (NOT at a sensor).
      orientation: optional (S, 3) fixed orientations -> (E, S).

    The famous sphere-model properties hold exactly and are gated in
    the tests: RADIAL dipoles are magnetically silent, the field does
    not depend on the conductivity profile (no sigma argument), and a
    center dipole produces no external field.

    Returns (E, S, 3) for unit x/y/z dipoles, or (E, S) with
    ``orientation`` — feed ``ops.lcmv`` / ``minimum_norm`` exactly like
    the EEG leadfield.
    """
    sp = np.asarray(sensor_pos, np.float64)
    so = np.asarray(sensor_ori, np.float64)
    src = np.asarray(src_pos, np.float64)
    if sp.ndim != 2 or sp.shape[1] != 3:
        raise ValueError("sensor_pos must be (E, 3)")
    if so.shape != sp.shape:
        raise ValueError("sensor_ori must match sensor_pos")
    if src.ndim != 2 or src.shape[1] != 3:
        raise ValueError("src_pos must be (S, 3)")
    rs = np.linalg.norm(sp, axis=1)
    rq = np.linalg.norm(src, axis=1)
    if rs.min() <= rq.max():
        raise ValueError(
            f"sensors must sit outside the source region "
            f"(min |sensor| {rs.min():.4f} <= max |src| {rq.max():.4f})")
    so = so / np.maximum(np.linalg.norm(so, axis=1, keepdims=True),
                         1e-30)
    lf = _sarvas_jit(jnp.asarray(sp, jnp.float32),
                     jnp.asarray(so, jnp.float32),
                     jnp.asarray(src, jnp.float32))
    if orientation is not None:
        ori = np.asarray(orientation, np.float64)
        if ori.shape != src.shape:
            raise ValueError("orientation must match src_pos (S, 3)")
        ori = ori / np.maximum(
            np.linalg.norm(ori, axis=1, keepdims=True), 1e-30)
        return jnp.einsum("esk,sk->es", lf,
                          jnp.asarray(ori, jnp.float32),
                          precision=jax.lax.Precision.HIGHEST)
    return lf


__all__.append("fit_dipole_meg")


@jax.jit
def _scan_grid_meg_jit(v, sp, so, grid):
    """One jitted MEG grid scan (eager per-op dispatch would run the same
    math one op at a time)."""
    lf = _sarvas_jit(sp, so, grid)
    return _grid_rss(lf, v)


@partial(jax.jit, static_argnames=("n_steps",))
def _refine_meg_jit(v, sp, so, p0, max_b, *, n_steps):
    """Adam refinement of the MEG dipole position through the
    differentiable Sarvas form; the moment solve keeps only the
    tangential plane (radial dipoles are silent — a full 3x3 Gram is
    singular by physics)."""

    def loss(p):
        b = jnp.linalg.norm(p)
        pc = jnp.where(b > max_b, p * (max_b / b), p)
        lf = _sarvas_jit(sp, so, pc[None, :])[:, 0, :]     # (E, 3)
        g = jnp.matmul(lf.T, lf, precision=lax.Precision.HIGHEST)
        g = g + 1e-6 * jnp.trace(g) * jnp.eye(3)
        q = jnp.linalg.solve(
            g, jnp.matmul(lf.T, v, precision=lax.Precision.HIGHEST))
        r = v - jnp.matmul(lf, q, precision=lax.Precision.HIGHEST)
        return jnp.sum(r * r), q

    p, q, val, _ = _adam_position(loss, p0, max_b, n_steps, lr=2e-3)
    return p, q, val


def fit_dipole_meg(v, sensor_pos, sensor_ori, radius: float = 0.09,
                   spacing: float = 0.01, n_steps: int = 300,
                   max_eccentricity: float = 0.90):
    """Single-dipole fit of an MEG topography (Sarvas model).

    Same two-stage scheme as :func:`fit_dipole`: grid scan with
    closed-form moments (the 3x3 Gram gets a 1e-6 relative ridge — it
    is rank-2 by physics, the radial direction is silent), then Adam
    on the position through the differentiable Sarvas form.  The
    returned ``moment`` is the tangential component only — the radial
    component of a sphere-model MEG dipole is unobservable, and the
    reported ``gof`` is against the average-free field directly (MEG
    needs no reference).

    ``radius`` bounds the SOURCE region (the grid), not the sensors.
    Returns the same dict shape as :func:`fit_dipole`.
    """
    v = np.asarray(v, np.float64)
    if v.ndim != 1:
        raise ValueError("v must be a single (E,) topography")
    sp = np.asarray(sensor_pos, np.float64)
    so = np.asarray(sensor_ori, np.float64)
    if sp.shape != (v.shape[0], 3) or so.shape != sp.shape:
        raise ValueError("sensor_pos/sensor_ori must be (E, 3) "
                         "matching v")
    if not 0 < max_eccentricity < 1.0:
        raise ValueError("max_eccentricity must be in (0, 1)")
    vn = float(np.linalg.norm(v))
    if vn == 0:
        raise ValueError("zero topography")
    so = so / np.maximum(np.linalg.norm(so, axis=1, keepdims=True),
                         1e-30)
    grid = source_grid(radius, spacing=spacing,
                       max_eccentricity=max_eccentricity)
    # a (near-)center grid point is magnetically SILENT: its Gram is
    # ~0, the relative ridge is a no-op, the solve NaNs, and argmin
    # returns the NaN index — drop the degenerate seeds entirely
    grid = grid[np.linalg.norm(grid, axis=1) > 0.05 * radius]
    if np.linalg.norm(sp, axis=1).min() <= radius * max_eccentricity:
        raise ValueError("sensors must sit outside the source region")
    spj = jnp.asarray(sp, jnp.float32)
    soj = jnp.asarray(so, jnp.float32)
    vj = jnp.asarray(v / vn, jnp.float32)
    rss, _ = _scan_grid_meg_jit(vj, spj, soj,
                                jnp.asarray(grid, jnp.float32))
    best = int(jnp.argmin(rss))
    p, q, val = _refine_meg_jit(
        vj, spj, soj, jnp.asarray(grid[best], jnp.float32),
        jnp.float32(radius * max_eccentricity), n_steps=int(n_steps))
    pos = np.asarray(p, np.float64)
    # report the observable (tangential) moment only
    r0 = pos / max(np.linalg.norm(pos), 1e-30)
    qn = np.asarray(q, np.float64) * vn
    qt = qn - (qn @ r0) * r0
    return {"pos": pos, "moment": qt, "gof": 1.0 - float(val),
            "grid_pos": grid[best]}
