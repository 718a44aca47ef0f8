"""2-D wavelet walkthrough: directional CWT on oriented textures and
separable DWT compression — the reference roadmap's "2D wavelet" item
(the reference README's roadmap section)
(`ops/cwt2d.py` runs as separable DFT matmuls; `ops/dwt2d.py` reuses the
tested 1-D lifting primitives).

    python examples/wavelet2d_demo.py

Ground truth: a 256x256 image of two oriented gratings (0.08 c/px at
30 deg in the left half, 0.2 c/px at 120 deg in the right half) plus
noise.  The demo shows the directional scalogram separating them, and
db4 wavedec2 compressing a piecewise-smooth image (Gaussian blobs) to
5% of its coefficients at high fidelity — oscillatory textures are NOT
wavelet-sparse; smooth-with-edges images are, which is the point of
the comparison printed last.
"""
import numpy as np

from ninwavelets_tpu.ops.cwt2d import power2d
from ninwavelets_tpu.ops.dwt2d import wavedec2, waverec2


def make_image(h=256, w=256, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    th1, f1 = np.deg2rad(30.0), 0.08
    th2, f2 = np.deg2rad(120.0), 0.20
    g1 = np.cos(2 * np.pi * f1 * (x * np.cos(th1) + y * np.sin(th1)))
    g2 = np.cos(2 * np.pi * f2 * (x * np.cos(th2) + y * np.sin(th2)))
    img = np.where(x < w // 2, g1, g2) + 0.3 * rng.standard_normal((h, w))
    return img.astype(np.float32)


def main():
    img = make_image()
    freqs = (0.05, 0.08, 0.12, 0.20)
    thetas = tuple(np.deg2rad([0.0, 30.0, 60.0, 90.0, 120.0, 150.0]))

    # directional scalogram: (F, T, H, W); mean energy per channel in
    # each half should peak at the planted (frequency, orientation)
    p = np.asarray(power2d(img, freqs, thetas))
    left = p[..., :, : img.shape[1] // 2].mean(axis=(-2, -1))
    right = p[..., :, img.shape[1] // 2:].mean(axis=(-2, -1))
    li = np.unravel_index(left.argmax(), left.shape)
    ri = np.unravel_index(right.argmax(), right.shape)
    print("[cwt2d] left half  -> %.2f c/px at %3.0f deg (truth 0.08 @ 30)"
          % (freqs[li[0]], np.rad2deg(thetas[li[1]])))
    print("[cwt2d] right half -> %.2f c/px at %3.0f deg (truth 0.20 @ 120)"
          % (freqs[ri[0]], np.rad2deg(thetas[ri[1]])))

    # separable DWT: keep the largest 5% of coefficients of a
    # piecewise-smooth image (where wavelets ARE the sparse basis)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    smooth = sum(a * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2 * s2 ** 2)))
                 for a, cx, cy, s2 in ((1.0, 70, 90, 30),
                                       (-0.7, 180, 60, 20),
                                       (0.5, 120, 190, 45)))
    smooth = smooth.astype(np.float32)
    coeffs = wavedec2(smooth, "db4", level=4)
    flat = np.concatenate([np.abs(np.asarray(c)).ravel()
                           for cs in coeffs
                           for c in (cs if isinstance(cs, tuple)
                                     else (cs,))])
    thresh = np.quantile(flat, 0.95)
    kept = []
    for cs in coeffs:
        if isinstance(cs, tuple):
            kept.append(tuple(np.where(np.abs(np.asarray(c)) >= thresh,
                                       np.asarray(c), 0.0) for c in cs))
        else:
            kept.append(np.where(np.abs(np.asarray(cs)) >= thresh,
                                 np.asarray(cs), 0.0))
    rec = np.asarray(waverec2(kept, "db4"))
    err = float(np.sqrt(((rec - smooth) ** 2).mean()) / smooth.std())
    # and the same 5% budget on the oscillatory texture, for contrast
    coeffs_t = wavedec2(img, "db4", level=4)
    flat_t = np.concatenate([np.abs(np.asarray(c)).ravel()
                             for cs in coeffs_t
                             for c in (cs if isinstance(cs, tuple)
                                       else (cs,))])
    thr_t = np.quantile(flat_t, 0.95)
    kept_t = []
    for cs in coeffs_t:
        if isinstance(cs, tuple):
            kept_t.append(tuple(np.where(np.abs(np.asarray(c)) >= thr_t,
                                         np.asarray(c), 0.0) for c in cs))
        else:
            kept_t.append(np.where(np.abs(np.asarray(cs)) >= thr_t,
                                   np.asarray(cs), 0.0))
    rec_t = np.asarray(waverec2(kept_t, "db4"))
    err_t = float(np.sqrt(((rec_t - img) ** 2).mean()) / img.std())
    print("[dwt2d]  5%% coefficients: smooth image rel RMSE %.3f vs "
          "oscillatory texture %.2f — wavelets compress edges, not "
          "gratings" % (err, err_t))


if __name__ == "__main__":
    main()
