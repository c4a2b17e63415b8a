"""Image metrics (counterpart of mofanerf_tpu/utils/metrics.py; `ssim` is a
host-side numpy copy of the JAX package's)."""
from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    """Clip to [0,1] and quantize to uint8 (host-side)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Structural similarity (Wang et al. 2004) between two [H, W, C]
    images in [0, max_val]: Gaussian-windowed, channel-averaged, in f64 on
    the host, the standard formulation of NeRF quality tables."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    half = filter_size // 2
    x = np.arange(filter_size) - half
    g = np.exp(-(x ** 2) / (2 * filter_sigma ** 2))
    g /= g.sum()

    def blur(img):
        # separable Gaussian, valid region only
        out = np.apply_along_axis(lambda r: np.convolve(r, g, mode="valid"), 0, img)
        out = np.apply_along_axis(lambda r: np.convolve(r, g, mode="valid"), 1, out)
        return out

    mu_a, mu_b = blur(a), blur(b)
    sa = blur(a * a) - mu_a ** 2
    sb = blur(b * b) - mu_b ** 2
    sab = blur(a * b) - mu_a * mu_b
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)
    )
    return float(s.mean())
