"""The products of a reference: in f32, or with both operands rounded to a
lower precision first (the control of a comparison)."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # largest finite float8 e4m3


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude to the format's largest), back in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """`mm(a, b)`: a @ b in f32, the operands first rounded to `name`:
    'f32' (unrounded), 'bf16' or 'fp8' (e4m3, a scale a tensor). Rounding is
    outside autograd's view of the scale: the gradient passes straight
    through it (the usual rule for quantised training)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        low = x.to(torch.bfloat16).to(torch.float32) if self.name == "bf16" else _fp8(x)
        return x + (low - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


@contextlib.contextmanager
def full_f32():
    """Products and convolutions in full f32 on the card (no TF32)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
