"""UV texture-map encoder CNN (counterpart of mofanerf_tpu/models/tex_encoder.py).

[B, S, S, 3] UV map -> 7 stride-2 4x4 convs (3->32->32->32->32->64->128->256)
with LeakyReLU(0.2), flatten, FC 512, `mu` FC -> tex_dim, then a 3-layer
LeakyReLU(0.1) "decoding" MLP head. It runs once a frame, off the hot path.

The public input stays NHWC as in the JAX package; the module moves channels
first for the convolutions and back before the flatten, so the first FC's
rows are in the JAX encoder's (NHWC) order and the bridge only transposes
kernels. Convolutions run in full f32 on the card (cuDNN's TF32 default is
switched off around them); the FCs follow `torch.backends.cuda.matmul`,
whose default is full f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mofanerf_tpu_torch.utils.device import resolve_device

CONV_WIDTHS = (32, 32, 32, 32, 64, 128, 256)


def _conv_out_side(side: int) -> int:
    for _ in CONV_WIDTHS:
        side = (side + 2 - 4) // 2 + 1
    return side


class TextureEncoder(nn.Module):
    def __init__(self, tex_dim: int = 256, uv_size: int = 512, device=None):
        super().__init__()
        side = _conv_out_side(uv_size)
        if side < 1:
            raise ValueError(f"uv_size {uv_size} is too small for 7 stride-2 convs (>= 128)")
        chans = (3,) + CONV_WIDTHS
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], kernel_size=4, stride=2, padding=1, device=device)
            for i in range(len(CONV_WIDTHS)))
        self.fc = nn.Linear(side * side * CONV_WIDTHS[-1], 512, device=device)
        self.mu = nn.Linear(512, tex_dim, device=device)
        self.decoding = nn.ModuleList(nn.Linear(tex_dim, tex_dim, device=device)
                                      for _ in range(3))

    def forward(self, uv_map: torch.Tensor) -> torch.Tensor:
        """uv_map: [B, S, S, 3] in [0, 1] -> [B, tex_dim]."""
        x = uv_map.permute(0, 3, 1, 2)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            for conv in self.convs:
                x = F.leaky_relu(conv(x), negative_slope=0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.leaky_relu(self.fc(x), negative_slope=0.2)
        h = self.mu(x)
        for layer in self.decoding:
            h = F.leaky_relu(layer(h), negative_slope=0.1)
        return h


def init_tex_encoder_params(generator: torch.Generator, tex_dim: int = 256,
                            uv_size: int = 512, device="cuda") -> dict:
    """The encoder's state dict with fan-in-scaled normal kernels and zero
    biases (the JAX encoder's init statistics); the draws come from a CPU
    `torch.Generator`, so the values differ from JAX's."""
    device = resolve_device(device)
    shapes = {k: tuple(v.shape)
              for k, v in TextureEncoder(tex_dim, uv_size, device="meta").state_dict().items()}
    state = {}
    for name, shape in shapes.items():
        if name.endswith("bias"):
            state[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            fan_in = int(np.prod(shape[1:]))
            w = torch.randn(shape, generator=generator, dtype=torch.float32)
            state[name] = (w / np.sqrt(fan_in)).to(device)
    return state
