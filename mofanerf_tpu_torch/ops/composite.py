"""Alpha compositing of raw field outputs into pixel values (counterpart of
mofanerf_tpu/ops/composite.py).

alpha = 1 - exp(-act(sigma) * delta), weights via the exclusive cumprod of
transmittance, depth/disp/acc maps and an optional white background.
Compositing stays float32 even when the MLP runs bfloat16.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CompositeOut(NamedTuple):
    rgb: torch.Tensor      # [N_rays, 3]
    disp: torch.Tensor     # [N_rays]
    acc: torch.Tensor      # [N_rays]
    weights: torch.Tensor  # [N_rays, N_samples]
    depth: torch.Tensor    # [N_rays]


def sigma_act(name: str):
    """Density activation by name; a typo raises."""
    if name == "relu":
        return F.relu
    if name == "softplus":
        return F.softplus
    raise ValueError(f"sigma_activation must be 'relu' or 'softplus', got {name!r}")


class _PositiveCumprod(torch.autograd.Function):
    """torch.cumprod over the last dim of a tensor with no zero element. Its
    backward is torch's own for that case, the reversed cumulative sum of
    grad x output divided by the input, without torch's test for zeros: that
    test reads a flag back to the host, which would make every differentiated
    render wait for the card."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def composite(
    raw_rgb: torch.Tensor,
    raw_sigma: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    noise: torch.Tensor | None = None,
    sigma_activation: str = "relu",
) -> CompositeOut:
    """raw_rgb: [N_rays, S, 3] pre-sigmoid; raw_sigma: [N_rays, S]; z_vals:
    [N_rays, S]; rays_d: [N_rays, 3].

    raw_noise_std > 0 adds `noise * raw_noise_std` to the raw density;
    `noise` is an injected [N_rays, S] standard-normal tensor (the JAX
    function draws it from a PRNG key)."""
    raw_rgb = raw_rgb.float()
    raw_sigma = raw_sigma.float()

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw_rgb)

    if raw_noise_std > 0.0:
        if noise is None:
            raise ValueError("sigma noise requires injected normal draws")
        raw_sigma = raw_sigma + noise * raw_noise_std

    alpha = 1.0 - torch.exp(-sigma_act(sigma_activation)(raw_sigma) * dists)
    # exclusive cumprod of transmittance: T_i = prod_{j<i} (1 - alpha_j + eps), whose
    # factors are >= eps > 0 (alpha <= 1)
    trans = _PositiveCumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1))[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return CompositeOut(rgb_map, disp_map, acc_map, weights, depth_map)
