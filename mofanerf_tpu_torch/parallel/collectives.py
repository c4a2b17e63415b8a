"""Collectives on a mesh's axes (the port's counterpart of the collectives
XLA inserts for the JAX package's sharded jit and shard_map).

Every collective here is an `all_reduce`: gloo carries only broadcast,
all_reduce and barrier on CUDA tensors, and several ranks sharing one card
must use gloo (NCCL refuses two ranks on one device), so the same code runs
over NCCL and over gloo. A gather is an all_reduce sum of zero-filled whole
buffers, each rank's block in its place: exact, since x + 0 = x. Half-width
floats are summed in f32 and rounded back once.

- rows over `data`: `data_rows` (the rank's contiguous block of a padded
  stream) and `gather_blocks` (the blocks back, every rank the whole);
- gradients over `data`: `all_reduce_mean_`, in place on the one flat buffer of
  every leaf;
- the fine field's columns over `model`: the autograd functions
  `copy_to_model` (forward the identity, backward the sum over model) and
  `gather_from_model` (forward the columns gathered, backward the rank's
  slice), which keep the gradients of everything before a tensor-parallel
  layer whole, not n_model times too large.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from mofanerf_tpu_torch.parallel.mesh import axis_rank, axis_size

_HALF = (torch.bfloat16, torch.float16)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, in f32 for half-width floats; returns a
    new tensor of t's dtype."""
    buf = t.float() if t.dtype in _HALF else t.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def padded_len(n: int, stride: int) -> int:
    """n rounded up to a multiple of stride."""
    return n + (-n) % stride


def pad_rows(x: torch.Tensor, n_total: int, fill: float = 1.0) -> torch.Tensor:
    """x [n, ...] padded with rows of `fill` to [n_total, ...] (rays of ones,
    as the JAX package pads a frame)."""
    pad = torch.full((n_total - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous block of x's rows: the i-th of n_data equal
    blocks on data rank i (JAX's P("data")); a tensor or a numpy array,
    whose rows must divide."""
    n = axis_size(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} data ranks")
    m = x.shape[0] // n
    i = axis_rank(mesh, "data")
    return x[i * m:(i + 1) * m]


def gather_blocks(items: Sequence[Tuple[torch.Tensor, int]], mesh, axis: str = "data"
                  ) -> List[torch.Tensor]:
    """Each (block, dim): the whole tensor whose `axis`-rank-th block along
    `dim` this rank holds, on every rank. One all_reduce (f32) for all items."""
    if not items:
        return []
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    wholes = []
    for t, dim in items:
        shape = list(t.shape)
        w = shape[dim]
        shape[dim] = w * n
        whole = torch.zeros(shape, dtype=torch.float32, device=t.device)
        whole.narrow(dim, r * w, w).copy_(t)
        wholes.append(whole)
    flat = torch.cat([w.reshape(-1) for w in wholes])
    dist.all_reduce(flat, group=_group(mesh, axis))
    out, at = [], 0
    for (t, _), w in zip(items, wholes):
        out.append(flat[at:at + w.numel()].reshape(w.shape).to(t.dtype))
        at += w.numel()
    return out


def all_reduce_mean_(flat: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The mean of the f32 buffer `flat` over `axis`, in place: one collective
    for every leaf of a flat gradient buffer (ops/flat_adam.py). Returns `flat`."""
    dist.all_reduce(flat, group=_group(mesh, axis))
    return flat.div_(axis_size(mesh, axis))


def all_true(flag: torch.Tensor, group) -> torch.Tensor:
    """A boolean scalar that holds on every rank of `group`, on every rank."""
    bad = (~flag).to(torch.float32)
    dist.all_reduce(bad, group=group)
    return bad == 0


class ModelAxis(NamedTuple):
    """The `model` axis as the tensor-parallel layers use it."""

    group: object
    size: int
    rank: int


def model_axis(mesh) -> ModelAxis | None:
    """The mesh's model axis; None without a mesh or with one model rank."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    return ModelAxis(_group(mesh, "model"), axis_size(mesh, "model"), axis_rank(mesh, "model"))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # every model rank holds a partial sum over its column block
        return _all_reduce_sum(g, ctx.axis.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        w = x.shape[-1]
        whole = torch.zeros(tuple(x.shape[:-1]) + (w * axis.size,), dtype=x.dtype,
                            device=x.device)
        whole[..., axis.rank * w:(axis.rank + 1) * w] = x
        return _all_reduce_sum(whole, axis.group)

    @staticmethod
    def backward(ctx, g):
        # every model rank ran the same computation on the gathered tensor, so
        # `g` is whole on each: the rank's columns are its gradient, no sum
        w = g.shape[-1] // ctx.axis.size
        return g[..., ctx.axis.rank * w:(ctx.axis.rank + 1) * w].contiguous(), None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The input of a column-parallel layer: x itself; its gradient summed
    over the model ranks' column blocks."""
    return _CopyToModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """A column-parallel layer's output block [..., w] -> the whole
    [..., w * size] on every model rank; the gradient is the rank's slice."""
    return _GatherFromModel.apply(x, axis)
