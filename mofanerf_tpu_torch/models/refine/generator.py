"""RefineNet generators, pix2pixHD-style (counterpart of
mofanerf_tpu/models/refine/generator.py), NCHW.

`GlobalGenerator`: a reflect-padded 7x7 stem, n stride-2 downsamples, n_blocks
ResNet blocks, n transposed-conv upsamples, a 7x7 conv to the output and tanh;
`LocalEnhancer` wraps a global trunk on the 2x-downsampled input with a
full-resolution branch. Instance norm without affine, biased variance, eps
1e-5.

The JAX package's upsample is flax `nn.ConvTranspose((3, 3), strides=(2, 2),
padding="SAME")`, which is not torch's usual `ConvTranspose2d(3, stride=2,
padding=1, output_padding=1)`: it equals `conv_transpose2d` with the kernel
flipped in both spatial axes, laid out [in, out, kh, kw], padding 0, and the
output cropped to its first 2n rows and columns (`ConvTransposeSame`; the
bridge flips the kernel as it carries it across).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over the image, no affine, biased
    variance (torch InstanceNorm2d's defaults, which pix2pixHD uses).

    Written out rather than `F.instance_norm`, whose backward in PyTorch 2.13
    on the CPU returns a wrong input gradient when the incoming gradient is
    channels-last (tests/test_torch_refine_models.py holds both against JAX's
    gradient); autograd differentiates these operations in any layout."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


class ConvTransposeSame(nn.ConvTranspose2d):
    """A 3x3 stride-2 transposed convolution doubling the image side, as flax's
    `ConvTranspose((3, 3), strides=(2, 2), padding="SAME")` (see the module
    docstring for the weight layout)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__(cin, cout, 3, stride=2, padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return super().forward(x)[..., :2 * h, :2 * w]


class ResnetBlock(nn.Module):
    """Reflect-padded 3x3 conv, norm, ReLU, conv, norm, plus the input."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, device=device)
        self.conv2 = nn.Conv2d(dim, dim, 3, device=device)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm(self.conv1(reflect_pad(x, 1))))
        return x + self.norm(self.conv2(reflect_pad(h, 1)))


def _trunk(input_nc: int, ngf: int, n_down: int, n_blocks: int, device):
    """stem, downsamples, ResNet blocks, upsamples (back to ngf channels)."""
    stem = nn.Conv2d(input_nc, ngf, 7, device=device)
    downs = nn.ModuleList(nn.Conv2d(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, stride=2, padding=1,
                                    device=device) for i in range(n_down))
    blocks = nn.ModuleList(ResnetBlock(ngf * 2 ** n_down, device) for _ in range(n_blocks))
    ups = nn.ModuleList(ConvTransposeSame(ngf * 2 ** (n_down - i), ngf * 2 ** (n_down - i) // 2,
                                          device) for i in range(n_down))
    return stem, downs, blocks, ups


def _run_trunk(m, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(m.norm(m.stem(reflect_pad(x, 3))))
    for conv in m.downs:
        h = F.relu(m.norm(conv(h)))
    for block in m.blocks:
        h = block(h)
    for up in m.ups:
        h = F.relu(m.norm(up(h)))
    return h


class GlobalGenerator(nn.Module):
    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsampling: int = 4, n_blocks: int = 9, device=None):
        super().__init__()
        self.stem, self.downs, self.blocks, self.ups = _trunk(input_nc, ngf, n_downsampling,
                                                              n_blocks, device)
        self.final = nn.Conv2d(ngf, output_nc, 7, device=device)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] in [-1, 1] -> [B, output_nc, H, W] in [-1, 1]."""
        return torch.tanh(self.final(reflect_pad(_run_trunk(self, x), 3)))


class LocalEnhancer(nn.Module):
    """The global trunk (its own final conv dropped) on the input pooled to
    half resolution, added to a full-resolution branch, then ResNet blocks and
    one upsample back to the input's side."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsample_global: int = 4, n_blocks_global: int = 9,
                 n_blocks_local: int = 3, device=None):
        super().__init__()
        # registered in the JAX module's order of creation (the bridge counts on it)
        self.stem, self.downs, self.blocks, self.ups = _trunk(
            input_nc, ngf * 2, n_downsample_global, n_blocks_global, device)
        self.local_stem = nn.Conv2d(input_nc, ngf, 7, device=device)
        self.local_down = nn.Conv2d(ngf, ngf * 2, 3, stride=2, padding=1, device=device)
        self.local_blocks = nn.ModuleList(ResnetBlock(ngf * 2, device)
                                          for _ in range(n_blocks_local))
        self.local_up = ConvTransposeSame(ngf * 2, ngf, device)
        self.final = nn.Conv2d(ngf, output_nc, 7, device=device)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = _run_trunk(self, F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False))
        h = F.relu(self.norm(self.local_stem(reflect_pad(x, 3))))
        h = F.relu(self.norm(self.local_down(h))) + g
        for block in self.local_blocks:
            h = block(h)
        h = F.relu(self.norm(self.local_up(h)))
        return torch.tanh(self.final(reflect_pad(h, 3)))
