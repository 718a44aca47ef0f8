"""Matching pursuit: greedy sparse Gabor decomposition of a signal.

No reference counterpart — matching pursuit (Mallat & Zhang 1993) is
the standard sparse time-frequency tool in EEG for sleep spindles and
graphoelements (Durka's MP maps): the signal is greedily decomposed
into Gabor atoms

    g_{s,u,xi,phi}(t) = K exp(-pi (t-u)^2 / s^2) cos(2 pi xi (t-u) + phi)

and each iteration removes the best-correlated atom from the residual.
Unlike the CWT (fixed scale-frequency coupling) the dictionary spans
scale and frequency INDEPENDENTLY, so a brief high-frequency burst and
a long low-frequency oscillation at the same instant resolve as two
atoms, each with amplitude/phase/width parameters you can threshold —
the spindle-detection workflow.

Mapping: one iteration = one CWT-shaped bank pass.  The dictionary
correlations over ALL translations are ``ifft(fft(r) * conj(h_hat))``
per (scale, frequency) row — the same batched spectral product as
``ops.cwt`` — followed by a global argmax for SELECTION, and an exact
rank-2 (cos/sin Gram) projection for the UPDATE, so the residual energy
decreases monotonically even where the analytic-atom approximation is
poor (low xi*s).  Iterations ride a ``lax.scan`` with a static atom
count; signals batch over leading dims via ``vmap``.  Correlations are
CIRCULAR (the package-wide FFT convention): an atom hanging off one
edge wraps to the other — pad the segment if that matters.

Boundaries are float-only as everywhere in this package.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from jax import lax

__all__ = ["MPResult", "gabor_dictionary", "matching_pursuit", "mp_tfr"]


class MPResult(NamedTuple):
    """Greedy decomposition: leading dims of the input, then one entry
    per atom (ordered by extraction = decreasing energy in practice).

    ``amplitude``/``phase`` parametrize the REAL atom
    ``A exp(-pi (t-u)^2/s^2) cos(2 pi xi (t-u) + phi)`` (unnormalized
    envelope); ``scale_s`` is the Gaussian width ``s`` in seconds,
    ``time_s`` the center ``u``, ``freq_hz`` the carrier ``xi``;
    ``energy`` the residual energy removed by the atom; ``residual``
    the remaining signal after all atoms.
    """
    amplitude: jnp.ndarray     # (..., K)
    phase: jnp.ndarray         # (..., K)
    scale_s: jnp.ndarray       # (..., K)
    time_s: jnp.ndarray        # (..., K)
    freq_hz: jnp.ndarray       # (..., K)
    energy: jnp.ndarray        # (..., K)
    residual: jnp.ndarray      # (..., N)


def gabor_dictionary(n: int, sfreq: float,
                     scales_s: Optional[Sequence[float]] = None,
                     freqs: Optional[Sequence[float]] = None):
    """Spectral Gabor dictionary: ``(rows, meta)`` where ``rows`` is the
    (S*F, N) complex-as-float-pair analytic-atom spectrum bank
    (L2-normalized per row) and ``meta`` the (S*F, 2) host array of
    (scale_s, freq_hz) per row.

    Defaults: dyadic scales from 4 cycles of the highest frequency up
    to N/2 samples; a linear frequency grid up to 0.4*sfreq.
    """
    if freqs is None:
        freqs = np.linspace(sfreq / n, 0.4 * sfreq, 64)
    freqs = np.asarray(freqs, np.float64)
    if scales_s is None:
        smin = max(4.0 / freqs.max(), 8.0 / sfreq)
        smax = (n / 2.0) / sfreq
        n_s = max(int(np.ceil(np.log2(smax / smin))) + 1, 2)
        scales_s = smin * 2.0 ** np.arange(n_s)
        scales_s = scales_s[scales_s * sfreq <= n / 2]
    scales_s = np.asarray(scales_s, np.float64)

    # Analytic atom spectrum at frequency bin nu (Hz), scale s (s):
    # FT[exp(-pi t^2/s^2) e^{i 2 pi xi t}](nu) = s exp(-pi s^2 (nu-xi)^2)
    k = np.arange(n)
    nu = np.where(k < (n + 1) // 2, k, k - n) * (sfreq / n)
    rows = []
    meta = []
    for s in scales_s:
        for xi in freqs:
            spec = s * np.exp(-np.pi * s ** 2 * (nu - xi) ** 2)
            norm = np.sqrt((spec ** 2).sum() / n)   # Parseval, circular
            if norm < 1e-20:
                continue
            rows.append(spec / norm)
            meta.append((s, xi))
    rows = np.asarray(rows, np.float32)
    meta = np.asarray(meta, np.float64)
    return rows, meta


def _atom_pair(n: int, sfreq: float, s, xi, u):
    """Unnormalized quadrature atoms at (scale s [s], freq xi [Hz],
    center u [samples]) on the circular grid: (gc, gs) = envelope times
    (cos, sin)."""
    t = jnp.arange(n, dtype=jnp.float32)
    # circular distance to u in samples
    d = jnp.mod(t - u + n / 2.0, float(n)) - n / 2.0
    d = d / sfreq                                   # seconds
    env = jnp.exp(-jnp.pi * d ** 2 / jnp.maximum(s, 1e-12) ** 2)
    ang = 2.0 * jnp.pi * xi * d
    return env * jnp.cos(ang), env * jnp.sin(ang)


@partial(jax.jit, static_argnames=("n_atoms", "sfreq"))
def _mp_flat(flat, bank, meta_dev, *, n_atoms: int, sfreq: float):
    n = flat.shape[-1]

    def one(signal):
        spec_bank = bank                              # (R, N) real

        def step(r, _):
            rf = jnp.fft.fft(r.astype(jnp.complex64))
            corr = jnp.fft.ifft(rf[None, :] * spec_bank)   # (R, N)
            # <r, h(. - u)> over all u: bank rows are real symmetric
            # Gaussians in frequency, so conj is a no-op; ifft gives the
            # circular cross-correlation directly.
            mag = corr.real ** 2 + corr.imag ** 2
            idx = jnp.argmax(mag)
            row, u = idx // n, (idx % n).astype(jnp.float32)
            s = meta_dev[row, 0]
            xi = meta_dev[row, 1]
            gc, gs = _atom_pair(n, sfreq, s, xi, u)
            # exact rank-2 projection onto span{gc, gs}
            a = jnp.dot(gc, gc)
            b = jnp.dot(gs, gs)
            c = jnp.dot(gc, gs)
            p = jnp.dot(r, gc)
            q = jnp.dot(r, gs)
            det = jnp.maximum(a * b - c * c, 1e-20)
            alpha = (b * p - c * q) / det
            beta = (a * q - c * p) / det
            r_new = r - alpha * gc - beta * gs
            energy = alpha * p + beta * q
            amp = jnp.sqrt(alpha ** 2 + beta ** 2)
            phi = jnp.arctan2(-beta, alpha)
            return r_new, (amp, phi, s, u / sfreq, xi, energy)

        residual, outs = lax.scan(step, signal, None, length=n_atoms)
        return residual, outs

    return jax.vmap(one)(flat)


def matching_pursuit(signals_r, n_atoms: int, sfreq: float,
                     scales_s: Optional[Sequence[float]] = None,
                     freqs: Optional[Sequence[float]] = None) -> MPResult:
    """Greedy Gabor decomposition of ``(..., N)`` signals into
    ``n_atoms`` atoms each (see :class:`MPResult`).

    Selection scans a spectral dictionary over every (scale, frequency,
    translation); the update is the exact quadrature projection, so
    residual energy is monotone decreasing.  One iteration costs one
    (R, N) bank pass — R = scales x frequencies.
    """
    signals = jnp.asarray(signals_r, jnp.float32)
    lead = signals.shape[:-1]
    n = signals.shape[-1]
    rows, meta = gabor_dictionary(n, sfreq, scales_s, freqs)
    flat = signals.reshape((-1, n))
    residual, outs = _mp_flat(flat, jnp.asarray(rows),
                              jnp.asarray(meta, jnp.float32),
                              n_atoms=int(n_atoms), sfreq=float(sfreq))
    shape = lead + (n_atoms,)
    amp, phi, s, u, xi, en = (o.reshape(shape) for o in outs)
    return MPResult(amp, phi, s, u, xi, en,
                    residual.reshape(lead + (n,)))


def mp_tfr(result: MPResult, n: int, sfreq: float, f_grid,
           t_decim: int = 16) -> jnp.ndarray:
    """(..., F, ceil(N/t_decim)) MP energy map (Durka-style): each
    atom paints its closed-form Wigner blob — a 2-D Gaussian centered
    at (freq_hz, time_s) with time width ``s/2`` and frequency width
    ``1/(2 pi s)`` (the Gabor uncertainty pair) — scaled to its energy.
    Cross-terms are absent by construction (the point of MP maps)."""
    f_grid = jnp.asarray(f_grid, jnp.float32)
    n_t = -(-n // t_decim)
    t_grid = (jnp.arange(n_t, dtype=jnp.float32) + 0.5) * t_decim / sfreq

    amp, s, u, xi, en = (result.amplitude, result.scale_s, result.time_s,
                         result.freq_hz, result.energy)
    # (..., K, F): frequency profile; (..., K, T'): time profile
    sig_f = 1.0 / (2.0 * jnp.pi * jnp.maximum(s, 1e-12))
    fprof = jnp.exp(-0.5 * ((f_grid - xi[..., None]) / sig_f[..., None])
                    ** 2)
    fprof = fprof / jnp.maximum(fprof.sum(-1, keepdims=True), 1e-20)
    sig_t = jnp.maximum(s, 1e-12) / 2.0
    tprof = jnp.exp(-0.5 * ((t_grid - u[..., None]) / sig_t[..., None])
                    ** 2)
    tprof = tprof / jnp.maximum(tprof.sum(-1, keepdims=True), 1e-20)
    scaled = fprof * jnp.maximum(en, 0.0)[..., None]
    return jnp.einsum("...kf,...kt->...ft", scaled, tprof)
