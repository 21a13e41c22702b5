"""Image quality metrics: the JAX package's ``utils.metrics`` (PSNR,
svox2's Gaussian-window ``compute_ssim`` from opt/util/util.py, and the
viridis colour map), in numpy, the SSIM's convolutions in float64 torch on
a given device (the host's scipy took 21-30 s of a 1920x1080 capture's
render_imgs).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(img, gt, mask=None):
    img = np.asarray(img, np.float64)
    gt = np.asarray(gt, np.float64)
    if mask is not None:
        m = np.asarray(mask, bool)
        mse = np.mean((img[m] - gt[m]) ** 2)
    else:
        mse = np.mean((img - gt) ** 2)
    return -10.0 * math.log10(max(mse, 1e-12))


def compute_ssim(
    img0,
    img1,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    device="cpu",
) -> float:
    """Gaussian-window SSIM, matching the JaxNeRF/reference settings: the
    'valid' separable convolution of (H, W, C) images, computed in float64
    on ``device``."""
    img0 = torch.as_tensor(np.asarray(img0, np.float64), device=device)
    img1 = torch.as_tensor(np.asarray(img1, np.float64), device=device)
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)
    # convolve2d's flipped kernel, as a cross-correlation over H, then W
    k = torch.as_tensor(filt[::-1].copy(), device=device)

    def convolve(z):
        x = z.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
        x = F.conv2d(F.conv2d(x, k.view(1, 1, -1, 1)), k.view(1, 1, 1, -1))
        return x[:, 0]

    mu0 = convolve(img0)
    mu1 = convolve(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = convolve(img0**2) - mu00
    sigma11 = convolve(img1**2) - mu11
    sigma01 = convolve(img0 * img1) - mu01

    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(torch.sqrt(sigma00 * sigma11),
                                                  torch.abs(sigma01))

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return float(torch.mean(numer / denom))


# 16-anchor viridis LUT (matplotlib control points), linearly interpolated —
# replaces opt/util/util.py:viridis_cmap without a matplotlib dependency
_VIRIDIS = np.array([
    [0.267004, 0.004874, 0.329415], [0.282623, 0.140926, 0.457517],
    [0.253935, 0.265254, 0.529983], [0.206756, 0.371758, 0.553117],
    [0.163625, 0.471133, 0.558148], [0.127568, 0.566949, 0.550556],
    [0.134692, 0.658636, 0.517649], [0.266941, 0.748751, 0.440573],
    [0.477504, 0.821444, 0.318195], [0.741388, 0.873449, 0.149561],
    [0.993248, 0.906157, 0.143936],
], np.float32)


def viridis_cmap(gray: np.ndarray) -> np.ndarray:
    """Map a (H, W) array to (H, W, 3) viridis colors, normalizing to the
    finite min/max like the reference's ``viridis_cmap``."""
    g = np.asarray(gray, np.float32)
    finite = np.isfinite(g)
    lo = g[finite].min() if finite.any() else 0.0
    hi = g[finite].max() if finite.any() else 1.0
    t = np.clip((g - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    t = np.nan_to_num(t)
    x = t * (len(_VIRIDIS) - 1)
    i0 = np.clip(x.astype(np.int32), 0, len(_VIRIDIS) - 2)
    f = (x - i0)[..., None]
    return _VIRIDIS[i0] * (1 - f) + _VIRIDIS[i0 + 1] * f
