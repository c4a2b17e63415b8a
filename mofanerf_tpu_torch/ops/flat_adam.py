"""Adam over one flat f32 buffer a tree, with the finite check and the skip:
the Triton kernels' wrapper and their plain PyTorch versions.

A tree's leaves live in one flat f32 buffer, each a view into it starting at
a multiple of `ALIGN` elements (256 bytes), the gaps zero (`FlatLayout`).
Params, Adam's moments and the gradients each have such a buffer, so an
update is one pass over four buffers and no longer a dozen launches a leaf:

- `all_finite(g, loss, flag)`: `flag` (an int32 scalar) set to 1, then to 0
  when the loss or any gradient is not finite (one launch of `finite`: a
  program that finds one writes the 0).
- `adam_(p, mu, nu, g, count, ...)`: optax.adam's update of params and
  moments in place, and `count += 1`, all where `flag` is non-zero and none of
  it where it is 0 (one launch of `adam`). The arithmetic is the per-leaf
  chain's: each product and sum rounded to f32 as its own operation, the
  divisions and the square root correctly rounded.

On CUDA tensors they launch the kernels (written in Triton, built at first
use, cached under `build/triton`); on CPU tensors they run `all_finite_ref`
and `adam_ref_`, the same arithmetic in plain PyTorch. Any other device
raises.

No TPU kernel stands behind them: under jit, XLA fused optax's per-leaf
update, the check and the selects into a few loops. The update reads four
buffers and writes three (7 x 4 bytes a parameter; the teacher's ~25 M
parameters make ~0.2 ms at 3.35 TB/s), the check reads one.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
from typing import List, Sequence

import torch

ALIGN = 64          # f32 elements: leaves start 256 bytes apart
_BLOCK = 4096       # elements a program of either kernel

# Triton launches made here in this process, by kernel: "finite", "adam" -> launches
launch_count: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a tree (tree_leaves order) lies in its flat buffer."""

    shapes: tuple     # leaf shapes
    offsets: tuple    # start of each leaf, a multiple of ALIGN
    size: int         # elements of the buffer, a multiple of ALIGN

    @classmethod
    def of(cls, leaves: Sequence[torch.Tensor]) -> "FlatLayout":
        shapes, offsets, at = [], [], 0
        for t in leaves:
            if t.dtype != torch.float32:
                raise ValueError(f"a flat buffer holds f32 leaves, got {t.dtype}")
            shapes.append(tuple(t.shape))
            offsets.append(at)
            at += -(-t.numel() // ALIGN) * ALIGN
        return cls(tuple(shapes), tuple(offsets), at)

    def zeros(self, device, extra: int = 0) -> torch.Tensor:
        """A buffer of the layout, zero (with `extra` elements after it)."""
        return torch.zeros(self.size + extra, dtype=torch.float32, device=device)

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The leaves as views of `flat` (at least `size` elements)."""
        sizes = []
        for (shape, off), nxt in zip(zip(self.shapes, self.offsets),
                                     self.offsets[1:] + (self.size,)):
            n = 1
            for d in shape:
                n *= d
            sizes += [n, nxt - off - n]
        pieces = flat[:self.size].split(sizes) if sizes else ()
        return [p.view(s) for p, s in zip(pieces[::2], self.shapes)]

    def pack(self, leaves: Sequence[torch.Tensor], device=None) -> torch.Tensor:
        """A new buffer holding `leaves` (its gaps zero)."""
        flat = self.zeros(device if device is not None else leaves[0].device)
        if leaves:
            torch._foreach_copy_(self.views(flat), list(leaves))
        return flat


# ---- plain versions ----------------------------------------------------------------------

def all_finite_ref(g: torch.Tensor, loss: torch.Tensor | None, flag: torch.Tensor) -> torch.Tensor:
    ok = torch.isfinite(g).all()
    if loss is not None:
        ok = ok & torch.isfinite(loss)
    return flag.mul_(ok.to(flag.dtype))


def adam_ref_(p, mu, nu, g, count, neg_lr, bc1, bc2, flag, b1, b2, eps) -> None:
    """The per-leaf chain's arithmetic on the flat buffers, then the select."""
    new_mu = g * (1 - b1) + mu * b1
    new_nu = (g * g) * (1 - b2) + nu * b2
    denom = torch.sqrt(new_nu / bc2) + eps
    new_p = p + (new_mu / bc1) / denom * neg_lr
    if flag is None:
        p.copy_(new_p)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        count.add_(1)
        return
    ok = flag != 0
    p.copy_(torch.where(ok, new_p, p))
    mu.copy_(torch.where(ok, new_mu, mu))
    nu.copy_(torch.where(ok, new_nu, nu))
    count.add_(ok.to(count.dtype))


# ---- the kernels ---------------------------------------------------------------------------

@functools.cache
def _kernels():
    from mofanerf_tpu_torch.utils.cuda_build import BUILD_DIR

    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def finite(g_ptr, n, loss_ptr, flag_ptr, HAS_LOSS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        g = tl.load(g_ptr + offs, mask=offs < n, other=0.0)
        bad = tl.max(((g - g) != 0.0).to(tl.int32), axis=0)     # inf - inf and NaN are NaN
        if HAS_LOSS:
            if pid == 0:
                x = tl.load(loss_ptr)
                bad = tl.maximum(bad, ((x - x) != 0.0).to(tl.int32))
        if bad != 0:
            tl.store(flag_ptr, 0)

    @triton.jit
    def adam(p_ptr, mu_ptr, nu_ptr, g_ptr, n, count_ptr, lr_ptr, bc1_ptr, bc2_ptr, flag_ptr,
             lr_value, b1, one_b1, b2, one_b2, eps, LR_PTR: tl.constexpr,
             HAS_FLAG: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        if HAS_FLAG:
            ok = (tl.load(flag_ptr) != 0).to(tl.int32)
        else:
            ok = tl.full((), 1, tl.int32)
        if pid == 0:
            tl.store(count_ptr, tl.load(count_ptr) + ok)
        if ok != 0:
            offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            m = offs < n
            g = tl.load(g_ptr + offs, mask=m, other=0.0)
            mu = tl.load(mu_ptr + offs, mask=m, other=0.0)
            nu = tl.load(nu_ptr + offs, mask=m, other=0.0)
            p = tl.load(p_ptr + offs, mask=m, other=0.0)
            if LR_PTR:
                neg_lr = tl.load(lr_ptr)
            else:
                neg_lr = lr_value
            mu = g * one_b1 + mu * b1
            nu = (g * g) * one_b2 + nu * b2
            denom = tl.sqrt_rn(tl.div_rn(nu, tl.load(bc2_ptr))) + eps
            p = p + tl.div_rn(tl.div_rn(mu, tl.load(bc1_ptr)), denom) * neg_lr
            tl.store(mu_ptr + offs, mu, mask=m)
            tl.store(nu_ptr + offs, nu, mask=m)
            tl.store(p_ptr + offs, p, mask=m)

    return {"finite": finite, "adam": adam, "triton": triton}


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flat Adam runs on cuda or cpu, not {t.device}")
    return t.device.type


def _check(name: str, t: torch.Tensor, n: int, dev) -> None:
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"{name} must be a contiguous f32 buffer of {n} elements on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def all_finite(g: torch.Tensor, loss: torch.Tensor | None, flag: torch.Tensor) -> torch.Tensor:
    """`flag` (an int32 scalar) set to 1, then to 0 if `loss` (if given) or any
    element of the flat buffer `g` is not finite; returns `flag`."""
    flag.fill_(1)
    if _device(g) == "cpu":
        return all_finite_ref(g, loss, flag)
    n = g.numel()
    _check("g", g, n, g.device)
    k = _kernels()["finite"]
    k[(max(1, -(-n // _BLOCK)),)](g, n, g if loss is None else loss, flag,
                                  HAS_LOSS=loss is not None, BLOCK=_BLOCK)
    launch_count["finite"] += 1
    return flag


def adam_(p, mu, nu, g, count, neg_lr, bc1, bc2, flag, b1: float, b2: float,
          eps: float) -> None:
    """Adam on flat buffers in place: mu, nu, p and `count` (int32 scalar) take
    their next values where `flag` is non-zero or None and keep theirs where it
    is 0. `neg_lr` (minus the rate: an f32 scalar tensor or a number), `bc1`,
    `bc2` (1 - b^t, f32 scalar tensors) are the update's constants."""
    if _device(p) == "cpu":
        return adam_ref_(p, mu, nu, g, count, neg_lr, bc1, bc2, flag, b1, b2, eps)
    n = p.numel()
    for name, t in (("p", p), ("mu", mu), ("nu", nu), ("g", g)):
        _check(name, t, n, p.device)
    lr_is_tensor = isinstance(neg_lr, torch.Tensor)
    if lr_is_tensor:
        neg_lr = neg_lr.to(torch.float32)
    k = _kernels()["adam"]
    k[(max(1, -(-n // _BLOCK)),)](
        p, mu, nu, g, n, count, neg_lr if lr_is_tensor else bc1, bc1, bc2,
        bc1 if flag is None else flag, 0.0 if lr_is_tensor else float(neg_lr),
        b1, 1 - b1, b2, 1 - b2, eps, LR_PTR=lr_is_tensor, HAS_FLAG=flag is not None,
        BLOCK=_BLOCK, enable_fp_fusion=False)
    launch_count["adam"] += 1
