"""Fixed-shape full-frame packet sweep with slab-test ray compaction
(counterpart of mofanerf_tpu/ops/sweep.py).

A closed-form ray/AABB slab test orders face-hitting rays first, only the
first `hit_fraction` of rays (rounded up to whole packets) are rendered, and
the rest scatter back as analytic background. hit_fraction=None measures the
hit count on the host (`profiling.host_read`: the card's queued work is
waited for) and buckets it up to a canonical fraction, so no foreground ray
is dropped. Packets run in a Python loop, one call of
`ray_fn` each, with the same packet shapes and padding as the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

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
        # hits first, in their original order (a stable sort, as jnp.argsort)
        order = torch.sort((~hit).to(torch.uint8), stable=True).indices
        # round the budget up to whole packets, clamped to the ray count
        m = min(int(-(-int(n * hit_fraction) // p) * p), n)
        sel = order[:m]
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
        p = min(packet_size, n)
        p = -(-p // packet_multiple) * packet_multiple
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
    outs = []
    for i in range(ro.shape[0]):
        with profiling.annotate("mofanerf.sweep.packet"):
            outs.append(ray_fn(ro[i], rd[i], *(t[i] for t in extras)))
    with profiling.annotate("mofanerf.sweep.assemble"):
        maps = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return scatter_background(maps, sel, n, n_eval, white_bkgd)


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
