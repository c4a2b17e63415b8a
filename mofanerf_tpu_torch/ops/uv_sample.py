"""Differentiable bilinear UV-map sampling (counterpart of
mofanerf_tpu/ops/uv_sample.py).

Parity with the reference `BilinearSampling` (models/model.py:249-264): a
differentiable bilinear lookup of RGB values in a UV texture map (legacy of
the paper's texture-space supervision; kept as public API surface). Plain
tensor operations: four gathers and their weights.
"""
from __future__ import annotations

import torch


def bilinear_sample(uv_map: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """uv_map: [H, W, C]; coords: [N, 2] float (row, col) pixel coordinates.
    Returns [N, C]. Gradients flow to both the map and the coordinates."""
    H, W = uv_map.shape[:2]
    r = coords[:, 0].clamp(0.0, H - 1.000001)
    c = coords[:, 1].clamp(0.0, W - 1.000001)
    r0 = torch.floor(r).long()
    c0 = torch.floor(c).long()
    r1 = torch.clamp(r0 + 1, max=H - 1)
    c1 = torch.clamp(c0 + 1, max=W - 1)
    fr = (r - r0)[:, None]
    fc = (c - c0)[:, None]
    v00 = uv_map[r0, c0]
    v01 = uv_map[r0, c1]
    v10 = uv_map[r1, c0]
    v11 = uv_map[r1, c1]
    return (v00 * (1 - fr) * (1 - fc)
            + v01 * (1 - fr) * fc
            + v10 * fr * (1 - fc)
            + v11 * fr * fc)
