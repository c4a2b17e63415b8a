"""A field layer of the training path, `relu(x @ W [+ x2 @ W2] + b)` in bf16:
the autograd function over cuBLAS and a Triton kernel, and its plain PyTorch
version.

`linear_relu(pairs, b)` is the layer `F.relu(_layer(pairs, b, bf16))` of
models/field.py, differentiable in every input. On CUDA tensors it runs
`LinearReLU`; on CPU tensors `linear_relu_ref`, the same arithmetic in
plain PyTorch. Any other device raises.

- Forward: cuBLASLt's bias-and-ReLU epilogue (`torch._addmm_activation`):
  the bf16 product summed in f32, the bias and the ReLU added before the
  output is written once, in bf16. The skip layer's first product takes
  the bias in its epilogue and its second sums onto that output in place
  (`addmm_`, beta 1), then one ReLU in place. It replaces a bias pass and a
  ReLU pass over the `[rows, W]` activation.
- Backward (`relu_grad`, written in Triton, built at first use, cached
  under `build/triton`; then cuBLAS's two products a weight): one pass
  reads `dy` and the saved output `y`, writes `dz = dy * (y > 0)` and the
  column sums of its tiles, which give the bias gradient in f32; `dz @ W^T`
  and `x^T @ dz` are cuBLAS's bf16 products with f32 sums, as in
  `_layer`'s backward. It replaces ReLU's backward, the bias's reduction
  and the weights' and bias's casts.

The weights are f32 masters cast to bf16 once a call (a training step calls
each layer once); the weight gradients come back as f32.

No TPU kernel stands behind it: under jit, XLA fused the bias, the ReLU
and the casts into its dots, where eager PyTorch makes a pass over the
activation for each of them and for each of their gradients. At the fine
field's 131,072 rows x 1024 an activation is 268 MB: a pass costs ~0.16 ms
at 3.35 TB/s, and a product 0.28 ms at 989 TFLOP/s (bf16, H100).
`relu_grad` is bound by its bytes (three activations).

Rounding is `_layer`'s but for the sums: the bias is rounded to bf16, as
there, but added to the f32 product before the one rounding of the output
(the skip layer's output is rounded after its first product and after its
second), and the bias gradient is an f32 sum.
"""
from __future__ import annotations

import collections
import functools
import os

import torch
import torch.nn.functional as F

# Triton launches made by `LinearReLU` in this process, by kernel: "relu_grad" -> launches
launch_count: collections.Counter = collections.Counter()

RELU_GRAD_TILE = {"BM": 64, "BN": 256, "num_warps": 8}


def linear_relu_ref(pairs, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the first product of bf16 operands summed in f32
    with the bf16-rounded bias and rounded to bf16, the second (if any)
    summed onto it in f32 and rounded again, then ReLU."""
    f32, bf16 = torch.float32, torch.bfloat16
    y = None
    for x, w in pairs:
        p = x.to(bf16).to(f32) @ w.to(bf16).to(f32)
        y = (p + (b.to(bf16).to(f32) if y is None else y.to(f32))).to(bf16)
    return F.relu(y)


def linear_relu(pairs, b: torch.Tensor) -> torch.Tensor:
    """relu(sum(x @ w for x, w in pairs) + b) in bf16 for one or two pairs
    (x [M, K_i] any float dtype, w [K_i, N] f32, b [N] f32), differentiable
    in every input. CUDA tensors run `LinearReLU`, CPU tensors the plain
    version; other devices raise."""
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"a layer takes one or two products, got {len(pairs)}")
    dev = pairs[0][0].device
    if dev.type == "cpu":
        return linear_relu_ref(pairs, b)
    if dev.type != "cuda":
        raise ValueError(f"linear_relu runs on cuda or cpu, not {dev}")
    (x, w), (x2, w2) = pairs[0], (pairs[1] if len(pairs) == 2 else (None, None))
    return LinearReLU.apply(x, w, b, x2, w2)


# ---- the backward's kernel -----------------------------------------------------------------

@functools.cache
def _kernels():
    """The Triton kernel, defined at first use (this module imports without triton)."""
    from mofanerf_tpu_torch.utils.cuda_build import BUILD_DIR

    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def relu_grad(dy_ptr, y_ptr, dz_ptr, part_ptr, M, N, HAS_DB: tl.constexpr,
                  BM: tl.constexpr, BN: tl.constexpr):
        # dz = where(y <= 0, 0, dy) (relu's backward: a NaN output passes dy), and the
        # column sums of the program's [BM, BN] block of dz into part[pid_m]
        pid_m = tl.program_id(0)
        rm = pid_m * BM + tl.arange(0, BM)
        rn = tl.program_id(1) * BN + tl.arange(0, BN)
        m = (rm[:, None] < M) & (rn[None, :] < N)
        offs = rm[:, None].to(tl.int64) * N + rn[None, :]
        g = tl.load(dy_ptr + offs, mask=m, other=0.0)
        y = tl.load(y_ptr + offs, mask=m, other=0.0)
        g = tl.where(y <= 0.0, 0.0, g)
        tl.store(dz_ptr + offs, g, mask=m)
        if HAS_DB:
            tl.store(part_ptr + pid_m.to(tl.int64) * N + rn, tl.sum(g.to(tl.float32), axis=0),
                     mask=rn < N)

    return {"relu_grad": relu_grad}


def _launch(name, grid, cfg, *args, **consts):
    k = _kernels()[name]
    k[grid](*args, **consts, **cfg)
    launch_count[name] += 1


def relu_grad(dy, y, with_db: bool):
    """(dy * (y > 0) [M, N] bf16, its column sums [N] f32 or None) in one pass:
    dy, y [M, N] bf16 contiguous."""
    M, N = dy.shape
    dz = torch.empty_like(dy)
    cfg = RELU_GRAD_TILE
    grid = (-(-M // cfg["BM"]), -(-N // cfg["BN"]))
    part = torch.empty((grid[0], N), dtype=torch.float32, device=dy.device) if with_db else dz
    if M:
        _launch("relu_grad", grid, cfg, dy, y, dz, part, M, N, HAS_DB=with_db)
    return dz, (part.sum(0) if with_db else None)


class LinearReLU(torch.autograd.Function):
    """relu(x @ w + [x2 @ w2] + b): forward by cuBLASLt's bias-and-ReLU
    epilogue; backward by `relu_grad` (the mask and the bias gradient in one
    pass) and cuBLAS's products of the masked gradient. w, w2 and b f32; the
    output and the input gradients bf16; the weight gradients summed in f32
    and rounded to bf16, as the products of `_layer` round them; the bias
    gradient f32."""

    @staticmethod
    def forward(ctx, x, w, b, x2, w2):
        bf16 = torch.bfloat16
        xb, wb, bb = x.to(bf16), w.to(bf16), b.to(bf16)
        if x2 is None:
            x2b = w2b = None
            y = torch._addmm_activation(bb, xb, wb)
        else:
            x2b, w2b = x2.to(bf16), w2.to(bf16)
            y = torch.addmm(bb, xb, wb).addmm_(x2b, w2b).relu_()
        ctx.save_for_backward(xb, wb, x2b, w2b, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wb, x2, w2b, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        dz, db = relu_grad(dy.to(torch.bfloat16).contiguous(), y, with_db=need[2])
        f32 = torch.float32
        dx = dz @ wb.t() if need[0] else None
        dw = (x.t() @ dz).to(f32) if need[1] else None
        dx2 = dz @ w2b.t() if x2 is not None and need[3] else None
        dw2 = (x2.t() @ dz).to(f32) if x2 is not None and need[4] else None
        return dx, dw, db, dx2, dw2
