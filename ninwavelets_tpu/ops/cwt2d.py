"""2-D continuous wavelet transform: directional Morlet over images.

The reference's roadmap names "2D wavelet" as its one unbuilt item
(`/root/reference/README.md:524`); this module completes it on the
continuous side.  The analyzing family is the standard directional 2-D
Morlet (Antoine & Murenzi 1996): in the frequency domain

    psi_hat(k; s, theta) = exp(-sigma^2 |s k - k0 e_theta|^2 / 2),

a Gaussian blob centered at wavenumber ``omega0 / s`` along direction
``theta`` — each (scale, orientation) row responds to oriented
oscillation at one spatial frequency, the image analog of the 1-D
Morlet's time-frequency atom.  (The DC leak exp(-sigma^2 omega0^2 / 2)
is ~1e-7 at the omega0 = 5.5 default — the usual admissibility
approximation, same as the 1-D Morlet.)

Design: the Gaussian blob FACTORS per (scale, theta) —
``|s k - k0 e_theta|^2 = (s kx - k0x)^2 + (s ky - k0y)^2`` — so every
bank row's frequency response is a rank-1 separable product
``by(ky) * bx(kx)`` of real 1-D Gaussians.  Each coefficient plane is
therefore the matrix sandwich

    W_{f,theta} = iDFT_H @ (S * by * bx) @ iDFT_W^T,   S = DFT_H @ img @ DFT_W^T,

pure dense matmuls against fixed DFT/iDFT matrices instead of a batched
fft2 (which of the two is faster on a given device is not measured on
the H100 yet).  The DFT matrices are cached DEVICE-resident per backend
(eagerly created, so no per-call re-upload), the bank factors stay
(F, T, H)+(F, T, W) vectors, and the fft2 path remains as the parity
oracle (``use_fft=True``).  H and W must be powers of two only on the fft
oracle path; the matmul path takes any size but pow2 keeps the two
paths comparable.  Boundaries are float pairs (the package's
convention); complex math stays inside jit.

Frequencies are in CYCLES PER PIXEL (Nyquist 0.5); scale
``s = omega0 / (2 pi f)``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["morlet2d_bank", "cwt2", "power2d", "pow2_pad2"]

OMEGA0 = 5.5


@functools.lru_cache(maxsize=32)
def _bank_np(freqs_key: tuple, thetas_key: tuple, h: int, w: int,
             sigma: float, omega0: float) -> np.ndarray:
    """(F, T, H, W) float32 frequency-domain bank — cached NUMPY (the
    jit-boundary rule), peak value 1 at each row's center wavenumber."""
    ky = 2.0 * np.pi * np.fft.fftfreq(h)[:, None]     # radians / pixel
    kx = 2.0 * np.pi * np.fft.fftfreq(w)[None, :]
    rows = np.empty((len(freqs_key), len(thetas_key), h, w), np.float32)
    for i, f in enumerate(freqs_key):
        s = omega0 / (2.0 * np.pi * f)
        for j, th in enumerate(thetas_key):
            k0y, k0x = omega0 * np.sin(th), omega0 * np.cos(th)
            d2 = (s * kx - k0x) ** 2 + (s * ky - k0y) ** 2
            rows[i, j] = np.exp(-0.5 * sigma ** 2 * d2)
    return rows


def morlet2d_bank(freqs, thetas, h: int, w: int, sigma: float = 1.0,
                  omega0: float = OMEGA0) -> jnp.ndarray:
    """(F, T, H, W) real directional-Morlet bank for fft2-domain use."""
    fk = tuple(float(f) for f in np.atleast_1d(freqs))
    tk = tuple(float(t) for t in np.atleast_1d(thetas))
    if any(f <= 0 or f > 0.5 for f in fk):
        raise ValueError("freqs are cycles/pixel in (0, 0.5]")
    return jnp.asarray(_bank_np(fk, tk, int(h), int(w), float(sigma),
                                float(omega0)))


def pow2_pad2(img):
    """Reflect-pad the trailing two axes up to the next powers of two;
    returns ``(padded, (h, w))`` with the original sizes for cropping."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[-2:]
    hp = 1 << max(int(np.ceil(np.log2(max(h, 2)))), 1)
    wp = 1 << max(int(np.ceil(np.log2(max(w, 2)))), 1)
    if (hp, wp) != (h, w):
        pad = [(0, 0)] * (img.ndim - 2) + [(0, hp - h), (0, wp - w)]
        img = jnp.pad(img, pad, mode="reflect")
    return img, (h, w)


@functools.partial(jax.jit, static_argnames=("power",))
def _cwt2_jit(img, bank, *, power: bool):
    spec = jnp.fft.fft2(img.astype(jnp.complex64))
    prod = spec[..., None, None, :, :] * bank          # (..., F, T, H, W)
    wv = jnp.fft.ifft2(prod)
    if power:
        return jnp.square(wv.real) + jnp.square(wv.imag)
    return wv.real, wv.imag


@functools.lru_cache(maxsize=32)
def _bank_sep_np(freqs_key: tuple, thetas_key: tuple, h: int, w: int,
                 sigma: float, omega0: float):
    """Separable factors of :func:`_bank_np`: real (F, T, H) and
    (F, T, W) Gaussians whose outer product is exactly the 2-D bank."""
    ky = 2.0 * np.pi * np.fft.fftfreq(h)
    kx = 2.0 * np.pi * np.fft.fftfreq(w)
    f = np.asarray(freqs_key, np.float64)[:, None, None]
    th = np.asarray(thetas_key, np.float64)[None, :, None]
    s = omega0 / (2.0 * np.pi * f)
    by = np.exp(-0.5 * sigma ** 2
                * (s * ky - omega0 * np.sin(th)) ** 2)
    bx = np.exp(-0.5 * sigma ** 2
                * (s * kx - omega0 * np.cos(th)) ** 2)
    return by.astype(np.float32), bx.astype(np.float32)


_DFT_DEV: dict = {}


def _dft_dev(n: int):
    """Device-resident (Fr, Fi, iFr, iFi) float32 DFT/iDFT matrices,
    cached per (n, backend) — eager creation, so caching device arrays
    is safe (the tracer-leak rule is about arrays made inside a trace),
    and nothing is re-uploaded host->device per call."""
    key = (n, jax.default_backend())
    if key not in _DFT_DEV:
        k = np.arange(n)
        ang = -2.0 * np.pi * np.outer(k, k) / n
        fr = np.cos(ang).astype(np.float32)
        fi = np.sin(ang).astype(np.float32)
        _DFT_DEV[key] = (jnp.asarray(fr), jnp.asarray(fi),
                         jnp.asarray(fr / n), jnp.asarray(-fi / n))
    return _DFT_DEV[key]


@functools.partial(jax.jit, static_argnames=("power",))
def _cwt2_sep_jit(img, by, bx, fyr, fyi, iyr, iyi, fxr, fxi, ixr, ixi,
                  *, power: bool):
    hp = jax.lax.Precision.HIGHEST
    cplx = lambda r, i: r.astype(jnp.complex64) + 1j * i.astype(
        jnp.complex64)
    fy, ify = cplx(fyr, fyi), cplx(iyr, iyi)
    fx, ifx = cplx(fxr, fxi), cplx(ixr, ixi)
    # S = DFT_H @ img @ DFT_W^T (the DFT matrix is symmetric)
    s = jnp.einsum("kh,...hw->...kw", fy, img.astype(jnp.complex64),
                   precision=hp)
    s = jnp.einsum("...kw,lw->...kl", s, fx, precision=hp)
    # scale by the separable bank factors -> (..., F, T, H, W)
    p = (s[..., None, None, :, :]
         * by[..., :, None].astype(jnp.complex64)
         * bx[..., None, :].astype(jnp.complex64))
    # the inverse sandwich
    wv = jnp.einsum("nk,...kw->...nw", ify, p, precision=hp)
    wv = jnp.einsum("...nw,mw->...nm", wv, ifx, precision=hp)
    if power:
        return jnp.square(wv.real) + jnp.square(wv.imag)
    return wv.real, wv.imag


_SEP_DEV: dict = {}


def _bank_sep_dev(fk, tk, h, w, sigma, omega0):
    """Device-resident separable factors, cached per (config, backend)
    like :func:`_dft_dev` — ``jnp.asarray(host_cache)`` per call would be
    a per-call H2D upload."""
    key = (fk, tk, h, w, sigma, omega0, jax.default_backend())
    if key not in _SEP_DEV:
        by, bx = _bank_sep_np(fk, tk, h, w, sigma, omega0)
        if len(_SEP_DEV) > 64:
            _SEP_DEV.clear()
        _SEP_DEV[key] = (jnp.asarray(by), jnp.asarray(bx))
    return _SEP_DEV[key]


def _cwt2_sep(img, freqs, thetas, sigma, omega0, power):
    fk = tuple(float(f) for f in np.atleast_1d(freqs))
    tk = tuple(float(t) for t in np.atleast_1d(thetas))
    if any(f <= 0 or f > 0.5 for f in fk):
        raise ValueError("freqs are cycles/pixel in (0, 0.5]")
    h, w = img.shape[-2:]
    by, bx = _bank_sep_dev(fk, tk, h, w, float(sigma), float(omega0))
    return _cwt2_sep_jit(img, by, bx,
                         *_dft_dev(h), *_dft_dev(w), power=power)


def _check_pow2(h: int, w: int):
    if h & (h - 1) or w & (w - 1):
        raise ValueError(
            f"H={h}, W={w} must be powers of two on the fft path (the "
            "FFT's fastest lengths); use pow2_pad2")


def cwt2(img, freqs, thetas=None, sigma: float = 1.0,
         omega0: float = OMEGA0, use_fft: bool = False):
    """Directional 2-D CWT of a real (..., H, W) image: returns the
    coefficient planes as a float pair ``(wr, wi)`` of shape
    (..., F, T, H, W).  ``thetas`` defaults to 6 orientations over
    [0, pi) (the transform of a real image at theta + pi is the
    conjugate — half the circle carries all the information).

    Default path: the separable DFT-matrix sandwich (dense matmuls);
    ``use_fft=True`` selects the batched fft2/ifft2 oracle (pow2 sizes
    only)."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[-2:]
    if thetas is None:
        thetas = np.arange(6) * np.pi / 6.0
    if not use_fft:
        return _cwt2_sep(img, freqs, thetas, sigma, omega0, power=False)
    _check_pow2(h, w)
    bank = morlet2d_bank(freqs, thetas, h, w, sigma, omega0)
    return _cwt2_jit(img, bank, power=False)


def power2d(img, freqs, thetas=None, sigma: float = 1.0,
            omega0: float = OMEGA0, use_fft: bool = False) -> jnp.ndarray:
    """(..., F, T, H, W) scalogram ``|W|^2`` of :func:`cwt2`."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[-2:]
    if thetas is None:
        thetas = np.arange(6) * np.pi / 6.0
    if not use_fft:
        return _cwt2_sep(img, freqs, thetas, sigma, omega0, power=True)
    _check_pow2(h, w)
    bank = morlet2d_bank(freqs, thetas, h, w, sigma, omega0)
    return _cwt2_jit(img, bank, power=True)
