"""Distilled-student serving renderer (counterpart of mofanerf_tpu/render/serve.py).

A per-avatar student renders with dense samples packed inside each ray's
analytic AABB interval. With `fused=True` (the default here) every packet
goes through the fused serving kernel (`render_packet_fused`), which launches
on the card and runs its plain PyTorch version on the CPU; the tensors' device
decides, with no flag. The kernel's weight operands are cast and tiled once
a frame or path (`pack_student`) and shared by its packets, and the rays of
every pose with their operands and hit count are made by one `serve_rays`
call (a kernel on the card, the plain chain of `get_rays` and `ray_operands`
on the CPU) before the sweep (`sweep_made`). The mesh route makes its rays
pose by pose and their operands after its compaction (`ray_operands`).
`fused=False` runs `render_rays_bounded`, the plain path that also serves
softplus density and skip students.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from mofanerf_tpu_torch.models.student import StudentConfig, fold_student_code, point_apply
from mofanerf_tpu_torch.ops.bounds import (
    DEFAULT_AABB_MAX,
    DEFAULT_AABB_MIN,
    bounded_z_vals,
    ray_aabb_interval,
)
from mofanerf_tpu_torch.ops.composite import composite
from mofanerf_tpu_torch.ops.embed import fourier_embed
from mofanerf_tpu_torch.ops.rays import get_rays
from mofanerf_tpu_torch.ops.serve_kernel import (
    _BLOCK_R,
    StudentPack,
    pack_student,
    ray_operands,
    render_packet_fused,
)
from mofanerf_tpu_torch.ops.serve_rays import serve_rays
from mofanerf_tpu_torch.ops.sweep import (compact_rays, packet_plan, scatter_background,
                                          sweep_frame, sweep_made, sweep_rays)
from mofanerf_tpu_torch.parallel.collectives import data_rows, gather_blocks, pad_rows, padded_len
from mofanerf_tpu_torch.parallel.mesh import axis_size
from mofanerf_tpu_torch.utils import profiling
from mofanerf_tpu_torch.utils.device import to_device

Params = Dict[str, Any]


def render_rays_bounded(
    params: Params,
    cfg,
    cond,
    rays_o: torch.Tensor,   # [N, 3]
    rays_d: torch.Tensor,   # [N, 3]
    near: float,
    far: float,
    n_samples: int = 32,
    aabb_min=DEFAULT_AABB_MIN,
    aabb_max=DEFAULT_AABB_MAX,
    white_bkgd: bool = False,
    uniforms: torch.Tensor | None = None,
    perturb: float = 0.0,
    sigma_activation: str = "relu",
) -> Dict[str, torch.Tensor]:
    """Bounded-interval render of a ray packet through one field, in plain
    PyTorch. perturb > 0 takes injected [N, S] `uniforms` (see
    bounded_z_vals). Returns {rgb, disp, acc, depth}."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    de = fourier_embed(viewdirs, cfg.multires_views)
    dirf = de @ params["view"]["w_dirs"]

    t0, t1, hit = ray_aabb_interval(rays_o, rays_d, aabb_min, aabb_max, near, far)
    z = bounded_z_vals(uniforms, t0, t1, n_samples, perturb)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    pe = fourier_embed(pts.reshape(-1, 3), cfg.multires)
    raw_rgb, raw_sigma = point_apply(params, cond, pe, dirf, cfg, samples_per_ray=n_samples)
    n = rays_o.shape[0]
    raw_rgb = raw_rgb.reshape(n, n_samples, 3)
    raw_sigma = raw_sigma.reshape(n, n_samples)
    # miss rays carry a degenerate interval; the final 1e10-distance slot
    # would light up on positive sigma, so force them transparent
    raw_sigma = torch.where(hit[:, None], raw_sigma,
                            torch.full_like(raw_sigma, -1e10))

    c = composite(raw_rgb, raw_sigma, z, rays_d, 0.0, white_bkgd, None,
                  sigma_activation=sigma_activation)
    return {"rgb": c.rgb, "disp": c.disp, "acc": c.acc, "depth": c.depth}


def _packet_fn(cfg, near, far, n_samples, white_bkgd, fused, sigma_activation):
    """(params, cond, aabb_lo, aabb_hi, o, d, *operands) -> maps: the one
    per-packet program that the frame and path renderers share. Fused, params
    is the student's `pack_student` and the operands are the packet's
    `(aux, dirf)` (`ray_operands`); see `_packed`."""
    if fused:
        if sigma_activation != "relu":
            raise ValueError(
                "the fused serving kernel is relu-only; pass fused=False "
                f"for sigma_activation={sigma_activation!r}"
            )

        def packet(pack, cond, lo, hi, o, d, aux, dirf):
            if cond is not None:
                raise ValueError("the fused path takes folded params (cond=None)")
            return render_packet_fused(pack, cfg, o, d, aux, dirf, n_samples, white_bkgd)
    else:
        def packet(params, cond, lo, hi, o, d):
            return render_rays_bounded(params, cfg, cond, o, d, near, far, n_samples,
                                       lo, hi, white_bkgd,
                                       sigma_activation=sigma_activation)
    return packet


def _fused_block_multiple(fused: bool) -> int:
    return _BLOCK_R if fused else 1


def _params_device(params) -> torch.device:
    return params.w0.device if isinstance(params, StudentPack) else params["input"]["w"].device


def _packed(params: Params, cfg, fused: bool):
    """What every packet reads, made once a frame or path: the fused kernel's
    weight operands, or the params when not fused."""
    if not fused or isinstance(params, StudentPack):
        return params
    return pack_student(params, cfg)


def _sweep_made(ray_fn, pack, cfg, H, W, K, poses, near, far, lo, hi, packet_size,
                hit_fraction, white_bkgd):
    """The fused route: the rays of every pose `[F, 3|4, 4]`, their operands and
    hit count made by one `serve_rays` call (the span `mofanerf.sweep.rays`),
    padded to whole packets, then swept. Flat [F*H*W, ...] maps."""
    _, rows = packet_plan(poses.shape[0] * H * W, packet_size, _BLOCK_R)
    with profiling.annotate("mofanerf.sweep.rays"):
        made = serve_rays(pack, cfg, H, W, K.contiguous(), poses.contiguous(), near, far, lo,
                          hi, rows)
    return sweep_made(ray_fn, made, packet_size, hit_fraction, white_bkgd, _BLOCK_R)


def render_frame_serve(
    params: Params,
    cfg,
    cond,
    H: int,
    W: int,
    K,
    c2w,
    near: float = 8.0,
    far: float = 26.0,
    n_samples: int = 32,
    aabb_min=DEFAULT_AABB_MIN,
    aabb_max=DEFAULT_AABB_MAX,
    white_bkgd: bool = False,
    packet_size: int = 8192,
    hit_fraction: float | None = None,
    fused: bool = True,
    sigma_activation: str = "relu",
) -> Dict[str, torch.Tensor]:
    """Full-frame serving render: bounded-interval ray packets plus
    frame-level slab compaction (auto-budgeted when hit_fraction is None).
    Renders on the params' device; K and c2w may be numpy arrays.

    For a code-conditioned student (cfg.cond_dim > 0), pass the code as
    `cond`; it folds into biases here so every packet runs as an
    unconditioned student's. `params` may also be the `pack_student` of
    folded params (cond None), so that a server packs an avatar once for
    all its frames.

    The body is the span `mofanerf.serve.frame`; the frame's set-up here is
    a `mofanerf.sweep.prepare` beside the sweep's own (ops/sweep.py)."""
    with profiling.annotate("mofanerf.serve.frame"):
        with profiling.annotate("mofanerf.sweep.prepare"):
            if isinstance(cfg, StudentConfig) and cond is not None:
                params, cond = fold_student_code(params, cond), None
            pf = _packet_fn(cfg, near, far, n_samples, white_bkgd, fused, sigma_activation)
            dev = _params_device(params)
            lo, hi = to_device(aabb_min, dev), to_device(aabb_max, dev)
            K, c2w = to_device(K, dev), to_device(c2w, dev)
            packed = _packed(params, cfg, fused)
        ray_fn = lambda o, d, *ops: pf(packed, cond, lo, hi, o, d, *ops)  # noqa: E731
        if fused:
            out = _sweep_made(ray_fn, packed, cfg, H, W, K, c2w[None], near, far, lo, hi,
                              packet_size, hit_fraction, white_bkgd)
            return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()}
        return sweep_frame(ray_fn, H, W, K, c2w, packet_size, aabb_min=lo, aabb_max=hi,
                           near=near, far=far, hit_fraction=hit_fraction, white_bkgd=white_bkgd)


def render_path_serve(
    params: Params,
    cfg,
    cond,
    poses,                 # [F, 3|4, 4] c2w stack
    H: int,
    W: int,
    K,
    near: float = 8.0,
    far: float = 26.0,
    n_samples: int = 32,
    aabb_min=DEFAULT_AABB_MIN,
    aabb_max=DEFAULT_AABB_MAX,
    white_bkgd: bool = False,
    packet_size: int = 16384,
    hit_fraction: float | None = None,
    fused: bool = True,
    sigma_activation: str = "relu",
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Multi-frame serving render: all frames' rays form one packet stream,
    so small frames still fill big packets and compaction pools background
    across the path. Returns [F, H, W, ...] maps.

    mesh (parallel/mesh.py): the multi-card path. Every rank compacts the
    whole stream alike, the compacted rays are padded to packets x n_data
    and split over the mesh's `data` axis, each rank sweeps its block, and
    the maps are gathered on every rank before the background scatter: the
    same maps as one card's.

    The body is the span `mofanerf.serve.path`, its rays `mofanerf.sweep.rays`
    and its set-up a `mofanerf.sweep.prepare`, as render_frame_serve's."""
    with profiling.annotate("mofanerf.serve.path"):
        with profiling.annotate("mofanerf.sweep.prepare"):
            if isinstance(cfg, StudentConfig) and cond is not None:
                params, cond = fold_student_code(params, cond), None
            dev = _params_device(params)
            lo, hi = to_device(aabb_min, dev), to_device(aabb_max, dev)
            K, poses = to_device(K, dev), to_device(poses, dev)
            pf = _packet_fn(cfg, near, far, n_samples, white_bkgd, fused, sigma_activation)
            packed = _packed(params, cfg, fused)

        F = poses.shape[0]
        ray_fn = lambda o, d, *ops: pf(packed, cond, lo, hi, o, d, *ops)  # noqa: E731
        if fused and mesh is None:
            out = _sweep_made(ray_fn, packed, cfg, H, W, K, poses, near, far, lo, hi,
                              packet_size, hit_fraction, white_bkgd)
            return {k: v.reshape((F, H, W) + v.shape[1:]) for k, v in out.items()}

        with profiling.annotate("mofanerf.sweep.rays"):
            ro, rd = [], []
            for i in range(F):
                o, d = get_rays(H, W, K, poses[i][:3])
                ro.append(o.reshape(-1, 3))
                rd.append(d.reshape(-1, 3))
            ro = torch.cat(ro)
            rd = torch.cat(rd)

        prepare = (lambda o, d: ray_operands(packed, cfg, o, d, near, far, lo, hi)) if fused \
            else None
        kw = dict(aabb_min=lo, aabb_max=hi, near=near, far=far, hit_fraction=hit_fraction,
                  white_bkgd=white_bkgd, packet_multiple=_fused_block_multiple(fused),
                  prepare=prepare)
        if mesh is None:
            out = sweep_rays(ray_fn, ro, rd, packet_size, **kw)
        else:
            out = _sharded_sweep(ray_fn, ro, rd, packet_size, mesh, **kw)
        return {k: v.reshape((F, H, W) + v.shape[1:]) for k, v in out.items()}


def _sharded_sweep(ray_fn, ro, rd, packet_size, mesh, aabb_min, aabb_max, near, far,
                   hit_fraction, white_bkgd, packet_multiple, prepare):
    """sweep_rays over the mesh's `data` axis (the JAX package's
    `_sharded_sweep`): p = min(packet_size, max(1, n // n_data)) rounded up
    to the packet multiple, the global compaction, the compacted stream
    padded to p x n_data, this rank's block swept, the blocks gathered on
    every rank, then the background scattered."""
    n_data = axis_size(mesh, "data")
    n = ro.shape[0]
    p = min(packet_size, max(1, n // n_data))
    p = -(-p // packet_multiple) * packet_multiple
    ro_c, rd_c, sel, n_eval = compact_rays(ro, rd, p, aabb_min, aabb_max, near, far,
                                            hit_fraction)
    n_total = padded_len(n_eval, p * n_data)
    with torch.no_grad():
        o, d = (data_rows(pad_rows(r, n_total), mesh) for r in (ro_c, rd_c))
        local = sweep_rays(ray_fn, o, d, p, packet_multiple=packet_multiple, prepare=prepare)
        whole = gather_blocks([(v, 0) for v in local.values()], mesh)
    maps = {k: v[None] for k, v in zip(local, whole)}
    return scatter_background(maps, sel, n, n_eval, white_bkgd)
