"""Multiscale PatchGAN discriminator, pix2pixHD-style (counterpart of
mofanerf_tpu/models/refine/discriminator.py), NCHW.

num_D discriminators over an average-pooled image pyramid, each a PatchGAN
(`NLayerDiscriminator`: 4x4 convs with padding 2, instance norm, LeakyReLU
0.2) returning its intermediate features for the feature-matching loss.
Scale k of the pyramid (full resolution first) goes through `scales[num_D - 1
- k]`, as the JAX module applies `scale_{num_D-1-k}`.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofanerf_tpu_torch.models.refine.generator import InstanceNorm


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3, device=None):
        super().__init__()
        widths = [input_nc, ndf]
        for _ in range(1, n_layers + 1):
            widths.append(min(widths[-1] * 2, 512))
        strides = [2] * n_layers + [1]
        self.convs = nn.ModuleList(
            nn.Conv2d(widths[i], widths[i + 1], 4, stride=s, padding=2, device=device)
            for i, s in enumerate(strides))
        self.final = nn.Conv2d(widths[-1], 1, 4, padding=2, device=device)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The per-stage feature list; its last entry is the patch logits."""
        feats = []
        h = x
        for k, conv in enumerate(self.convs):
            h = conv(h)
            h = F.leaky_relu(h if k == 0 else self.norm(h), 0.2)
            feats.append(h)
        feats.append(self.final(h))
        return feats


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3, num_D: int = 2,
                 device=None):
        super().__init__()
        self.scales = nn.ModuleList(NLayerDiscriminator(input_nc, ndf, n_layers, device)
                                    for _ in range(num_D))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """x: [B, C, H, W] -> per-scale feature lists, full resolution first."""
        num_D = len(self.scales)
        results = []
        for i in range(num_D):
            if i:
                x = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
            results.append(self.scales[num_D - 1 - i](x))
        return results
