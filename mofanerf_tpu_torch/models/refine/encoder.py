"""pix2pixHD instance-wise feature encoder (counterpart of
mofanerf_tpu/models/refine/encoder.py), NCHW: a conv-down / conv-up feature
autoencoder whose output is averaged over each instance region. The
reference's RefineNet configuration does not enable it; it is part of the
subsystem's surface."""
from __future__ import annotations

import torch
import torch.nn as nn

from mofanerf_tpu_torch.models.refine.generator import (ConvTransposeSame, InstanceNorm,
                                                        reflect_pad)

N_INSTANCE_IDS = 256   # pix2pixHD's instance ids are uint8-like


class InstanceFeatureEncoder(nn.Module):
    def __init__(self, input_nc: int = 3, feat_nc: int = 3, ngf: int = 16,
                 n_downsampling: int = 4, device=None):
        super().__init__()
        nd = n_downsampling
        self.stem = nn.Conv2d(input_nc, ngf, 7, device=device)
        self.downs = nn.ModuleList(nn.Conv2d(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, stride=2,
                                             padding=1, device=device) for i in range(nd))
        self.ups = nn.ModuleList(ConvTransposeSame(ngf * 2 ** (nd - i), ngf * 2 ** (nd - i) // 2,
                                                   device) for i in range(nd))
        self.final = nn.Conv2d(ngf, feat_nc, 7, device=device)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] -> per-pixel features [B, feat_nc, H, W]."""
        h = torch.relu(self.norm(self.stem(reflect_pad(x, 3))))
        for conv in list(self.downs) + list(self.ups):
            h = torch.relu(self.norm(conv(h)))
        return torch.tanh(self.final(reflect_pad(h, 3)))


def instance_average(features: torch.Tensor, inst_map: torch.Tensor) -> torch.Tensor:
    """Each instance region's features replaced by their mean over the region.

    features: [B, C, H, W]; inst_map: [B, H, W] integer ids in [0, 256).
    Segment sums over the batch's (image, id) pairs with `index_add_`, no
    per-instance loop."""
    B, C, H, W = features.shape
    ids = (inst_map.reshape(B, -1).to(torch.int64)
           + N_INSTANCE_IDS * torch.arange(B, device=features.device)[:, None]).reshape(-1)
    feats = features.permute(0, 2, 3, 1).reshape(-1, C)
    sums = feats.new_zeros(B * N_INSTANCE_IDS, C).index_add_(0, ids, feats)
    counts = feats.new_zeros(B * N_INSTANCE_IDS).index_add_(0, ids, feats.new_ones(ids.shape))
    means = sums / counts.clamp(min=1.0)[:, None]
    return means[ids].reshape(B, H, W, C).permute(0, 3, 1, 2)
