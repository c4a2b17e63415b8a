"""RefineNet GAN losses (counterpart of mofanerf_tpu/models/refine/losses.py):
LSGAN over each scale's patch logits, summed over scales; the multiscale
feature-matching L1 with pix2pixHD's 4/(n_layers+1) * 1/num_D weights; and
the VGG19 perceptual L1 over the relu1_1 ... relu5_1 slices with weights
[1/32, 1/16, 1/8, 1/4, 1].

No VGG weights ship with the repo: `convert_torchvision_vgg19` maps a
torchvision `vgg19().features` state dict to `VGG19Features`' layout, and
`vgg_from_jax_layout` reads the JAX package's layout (its
`convert_torchvision_vgg19` output: {"params": {"conv{b}_{c}": {"kernel":
HWIO, "bias"}}}, numpy leaves).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# VGG19 up to relu5_1: (channels, convs) per block, the last block's first conv only
_VGG_PLAN = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 1)]
VGG_SLICE_WEIGHTS = [1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0]
# (JAX name, torchvision `features` index) of each conv, in order
VGG_CONVS = [("conv0_0", 0), ("conv0_1", 2), ("conv1_0", 5), ("conv1_1", 7),
             ("conv2_0", 10), ("conv2_1", 12), ("conv2_2", 14), ("conv2_3", 16),
             ("conv3_0", 19), ("conv3_1", 21), ("conv3_2", 23), ("conv3_3", 25),
             ("conv4_0", 28)]


def lsgan_loss(logits: List[List[torch.Tensor]], is_real: bool) -> torch.Tensor:
    """MSE of each scale's patch logits to 1 (real) or 0 (fake), summed over
    scales."""
    target = 1.0 if is_real else 0.0
    return sum(torch.mean((feats[-1] - target) ** 2) for feats in logits)


def feature_matching_loss(fake_feats: List[List[torch.Tensor]],
                          real_feats: List[List[torch.Tensor]],
                          n_layers: int = 3, num_D: int = 2) -> torch.Tensor:
    """L1 between the discriminator's features of the fake and of the real
    (the real's detached)."""
    w = 4.0 / (n_layers + 1) * (1.0 / num_D)
    loss = 0.0
    for scale_f, scale_r in zip(fake_feats, real_feats):
        for f, r in zip(scale_f[:-1], scale_r[:-1]):
            loss = loss + w * torch.mean(torch.abs(f - r.detach()))
    return loss


class VGG19Features(nn.Module):
    """The activations after relu1_1, relu2_1, relu3_1, relu4_1, relu5_1 (the
    reference Vgg19's slices of torchvision's `features`)."""

    def __init__(self, device=None):
        super().__init__()
        chans = [3] + [ch for ch, n in _VGG_PLAN for _ in range(n)]
        self.convs = nn.ModuleList(nn.Conv2d(chans[k], chans[k + 1], 3, padding=1, device=device)
                                   for k in range(len(chans) - 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W] in [-1, 1] (pix2pixHD feeds it tanh outputs)."""
        outs, k, h = [], 0, x
        for b, (_, n) in enumerate(_VGG_PLAN):
            if b:
                h = F.max_pool2d(h, 2, 2)
            for c in range(n):
                h = F.relu(self.convs[k](h))
                k += 1
                if c == 0:
                    outs.append(h)
        return outs


def vgg_perceptual_loss(vgg: VGG19Features, vgg_params: Dict[str, torch.Tensor],
                        fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Weighted L1 between the VGG slices of fake and real; the real's
    features carry no gradient."""
    f_feats = torch.func.functional_call(vgg, vgg_params, (fake,))
    with torch.no_grad():
        r_feats = torch.func.functional_call(vgg, vgg_params, (real,))
    loss = 0.0
    for w, f, r in zip(VGG_SLICE_WEIGHTS, f_feats, r_feats):
        loss = loss + w * torch.mean(torch.abs(f - r))
    return loss


def convert_torchvision_vgg19(state_dict) -> Dict[str, np.ndarray]:
    """torchvision `vgg19().features` state dict -> VGG19Features' state dict
    (numpy): the 13 convs up to relu5_1, kernels kept OIHW."""
    out = {}
    for k, (_, ti) in enumerate(VGG_CONVS):
        out[f"convs.{k}.weight"] = np.asarray(state_dict[f"{ti}.weight"], np.float32)
        out[f"convs.{k}.bias"] = np.asarray(state_dict[f"{ti}.bias"], np.float32)
    return out


def vgg_from_jax_layout(variables) -> Dict[str, np.ndarray]:
    """The JAX package's VGG19Features variables ({"params": {"conv{b}_{c}":
    {"kernel" HWIO, "bias"}}}, numpy leaves) -> VGG19Features' state dict
    (numpy, OIHW)."""
    p = variables["params"]
    out = {}
    for k, (name, _) in enumerate(VGG_CONVS):
        out[f"convs.{k}.weight"] = np.ascontiguousarray(
            np.asarray(p[name]["kernel"], np.float32).transpose(3, 2, 0, 1))
        out[f"convs.{k}.bias"] = np.asarray(p[name]["bias"], np.float32)
    return out
