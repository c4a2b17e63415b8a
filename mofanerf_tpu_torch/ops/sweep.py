"""Fixed-shape full-frame packet sweep with slab-test ray compaction
(counterpart of mofanerf_tpu/ops/sweep.py).

A closed-form ray/AABB slab test orders face-hitting rays first, only the
first `hit_fraction` of rays (rounded up to whole packets) are rendered, and
the rest scatter back as analytic background. hit_fraction=None measures the
hit count on the host (`profiling.host_read`: the card's queued work is
waited for) and buckets it up to a canonical fraction, so no foreground ray
is dropped. Packets run in a Python loop, one call of
`ray_fn` each, with the same packet shapes and padding as the JAX package.

`sweep_made` sweeps rays made together with their per-ray operands and hit
count (`ops/serve_rays.py::serve_rays`, the fused serving route): it reads the
budget from the count and gathers rays and operands alike, with no second
slab test and no padding of its own.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from mofanerf_tpu_torch.ops.bounds import ray_aabb_interval
from mofanerf_tpu_torch.ops.rays import get_rays
from mofanerf_tpu_torch.utils import profiling

HIT_BUDGET_BUCKETS = (0.25, 0.5, 0.75, 1.0)


def bucket_fraction(frac: float, buckets=HIT_BUDGET_BUCKETS) -> float:
    """Smallest canonical budget covering `frac`."""
    for b in sorted(buckets):
        if frac <= b:
            return b
    return 1.0


def packet_plan(n: int, packet_size: int, packet_multiple: int = 1):
    """(p, rows): the packet size a sweep of n rays takes (packet_size, or n
    when fewer, rounded up to the multiple) and the rows it sweeps without
    compaction, n and the padding rays after them."""
    p = min(packet_size, n)
    p = -(-p // packet_multiple) * packet_multiple
    return p, n + (-n) % p


def hit_share(n_hit: int, n: int) -> float:
    """n_hit / n in f32, as `hit.float().mean()` takes it on the CPU (the sum
    is exact below 2**24 rays, then one rounded division)."""
    return float(np.float32(n_hit) / np.float32(n))


def _kept(hit, p, hit_fraction):
    """(sel, m): the first m rays with hits first, in their original order (a
    stable sort, as jnp.argsort); m the budget rounded up to whole packets,
    clamped to the ray count."""
    n = hit.shape[0]
    order = torch.sort((~hit).to(torch.uint8), stable=True).indices
    m = min(int(-(-int(n * hit_fraction) // p) * p), n)
    return order[:m], m


def compact_rays(ro_flat, rd_flat, p, aabb_min, aabb_max, near, far, hit_fraction):
    """Order face-hitting rays first and keep a whole-packets budget.
    Returns (ro, rd, sel, n_eval); sel is None when no compaction applied."""
    n = ro_flat.shape[0]
    hit = None
    if hit_fraction is None or hit_fraction < 1.0:
        _, _, hit = ray_aabb_interval(ro_flat, rd_flat, aabb_min, aabb_max, near, far)
    if hit_fraction is None:
        hit_fraction = bucket_fraction(profiling.host_read(hit.float().mean()))

    if hit_fraction < 1.0:
        sel, m = _kept(hit, p, hit_fraction)
        return ro_flat[sel], rd_flat[sel], sel, m
    return ro_flat, rd_flat, None, n


_BG_FILL = {"rgb": None, "disp": 1e10, "acc": 0.0, "depth": 0.0}


def scatter_background(maps, sel, n, n_eval, white_bkgd):
    """Unpad packet outputs and scatter compacted rays back over analytic
    background values (composite()'s outputs for an all-empty ray)."""
    out = {}
    for k, v in maps.items():
        flat = v.reshape((v.shape[0] * v.shape[1],) + v.shape[2:])[:n_eval]
        if sel is not None:
            fill = _BG_FILL.get(k, 0.0)
            if k == "rgb":
                fill = 1.0 if white_bkgd else 0.0
            full = torch.full((n,) + flat.shape[1:], fill, dtype=flat.dtype,
                              device=flat.device)
            full[sel] = flat
        else:
            full = flat
        out[k] = full
    return out


def sweep_rays(
    ray_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
    ro_flat: torch.Tensor,   # [N, 3]
    rd_flat: torch.Tensor,   # [N, 3]
    packet_size: int,
    aabb_min=None,
    aabb_max=None,
    near: float = 0.0,
    far: float = math.inf,
    hit_fraction: float | None = 1.0,
    white_bkgd: bool = False,
    packet_multiple: int = 1,
    prepare: Callable | None = None,
) -> Dict[str, torch.Tensor]:
    """Sweep `ray_fn` over a flat ray stream in fixed-size packets with
    optional slab compaction. Returns flat [N, ...] maps.

    packet_multiple: round the packet size UP to this granularity (padding
    rays, all ones, cover the remainder).
    prepare: (rays_o, rays_d) -> per-ray tensors [n, ...], made once over
    every packet's rays (padding included) and handed to `ray_fn` as
    further arguments, a packet's rows each: per-ray work done in a few
    large operations rather than a few small ones a packet.

    Spans (utils/profiling.py): `mofanerf.sweep.prepare` to the first packet,
    `mofanerf.sweep.packet` around each `ray_fn` call,
    `mofanerf.sweep.assemble` for the stack and the scatter."""
    with profiling.annotate("mofanerf.sweep.prepare"):
        n = ro_flat.shape[0]
        p, _ = packet_plan(n, packet_size, packet_multiple)
        ro_flat, rd_flat, sel, n_eval = compact_rays(
            ro_flat, rd_flat, p, aabb_min, aabb_max, near, far, hit_fraction
        )

        n_pad = (-n_eval) % p
        pad = torch.ones((n_pad, 3), dtype=ro_flat.dtype, device=ro_flat.device)
        ro = torch.cat([ro_flat, pad]).reshape(-1, p, 3)
        rd = torch.cat([rd_flat, pad]).reshape(-1, p, 3)

        extras = () if prepare is None else tuple(
            t.reshape((-1, p) + t.shape[1:])
            for t in prepare(ro.reshape(-1, 3), rd.reshape(-1, 3)))
    return _packets(ray_fn, (ro, rd) + extras, sel, n, n_eval, white_bkgd)


def _packets(ray_fn, packets, sel, n, n_eval, white_bkgd):
    """One `ray_fn` call a packet (`packets`: per-ray tensors [packets, p, ...],
    the rays first), then the maps stacked and scattered over the background."""
    outs = []
    for i in range(packets[0].shape[0]):
        with profiling.annotate("mofanerf.sweep.packet"):
            outs.append(ray_fn(*(t[i] for t in packets)))
    with profiling.annotate("mofanerf.sweep.assemble"):
        maps = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return scatter_background(maps, sel, n, n_eval, white_bkgd)


def sweep_made(
    ray_fn: Callable[..., Dict[str, torch.Tensor]],
    made,
    packet_size: int,
    hit_fraction: float | None = 1.0,
    white_bkgd: bool = False,
    packet_multiple: int = 1,
) -> Dict[str, torch.Tensor]:
    """`sweep_rays(prepare=...)` on rays made with their operands
    (ops/serve_rays.py::serve_rays): `made` holds `made.n` rays and the padding
    rows that `packet_plan` adds after them, `aux[:, 2]` their hit mask and
    `n_hit` its count on the device. hit_fraction=None reads the count (one
    `profiling.host_read`) and buckets `hit_share` as compact_rays buckets the
    hit share. Under a budget below 1 the kept rays and their operands are
    gathered alike (the padding rows with them where the budget keeps every
    ray). Each packet gets `ray_fn(o, d, aux, dirf)`. Returns flat [n, ...] maps.

    Spans as sweep_rays': `mofanerf.sweep.prepare` for the read and the
    gather, then the packets and the assembly."""
    with profiling.annotate("mofanerf.sweep.prepare"):
        n = made.n
        p, rows = packet_plan(n, packet_size, packet_multiple)
        tensors = (made.rays_o, made.rays_d, made.aux, made.dirf)
        if tensors[0].shape[0] != rows:
            raise ValueError(f"{tensors[0].shape[0]} rows made for {n} rays in packets of "
                             f"{p}, which take {rows}")
        if hit_fraction is None:
            hit_fraction = bucket_fraction(hit_share(profiling.host_read(made.n_hit), n))
        sel, n_eval = None, n
        if hit_fraction < 1.0:
            sel, n_eval = _kept(made.aux[:n, 2] > 0, p, hit_fraction)
            pad = (-n_eval) % p
            rows_kept = sel if not pad else torch.cat(
                [sel, torch.arange(n, n + pad, device=sel.device)])
            tensors = tuple(t[rows_kept] for t in tensors)
        packets = tuple(t.reshape((-1, p) + t.shape[1:]) for t in tensors)
    return _packets(ray_fn, packets, sel, n, n_eval, white_bkgd)


def sweep_frame(
    ray_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
    H: int,
    W: int,
    K: torch.Tensor,
    c2w: torch.Tensor,
    packet_size: int,
    **kw,
) -> Dict[str, torch.Tensor]:
    """Render a full frame by sweeping `ray_fn` over fixed-size packets.
    Returns [H, W, ...] maps."""
    with profiling.annotate("mofanerf.sweep.rays"):
        rays_o, rays_d = get_rays(H, W, K, c2w)
    out = sweep_rays(ray_fn, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                     packet_size, **kw)
    return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()}
