"""Occupancy-grid sample culling, the fast render path (counterpart of
mofanerf_tpu/ops/occupancy.py).

1. A boolean G^3 grid over the head's box marks the cells whose activated
   density exceeds a threshold, dilated by one cell (a 3^3 max filter) so
   that a thin occupied shell stays thicker than the ray march's probe
   spacing. Production grids probe the COARSE field (`build_proposal_grid`):
   a two-pass-trained fine field is only constrained on its importance
   samples. Training keeps the grid current with an EMA of the probed
   density (`update_occupancy_grid`) and saves it beside its checkpoints.
2. `render_rays_occupancy` places `s_probe` evenly spaced depths a ray,
   looks each up in the grid (gathers, no field), respaces `k_keep` samples
   over the band between the first and last occupied probe, and runs only
   those through the fine field: on the card the fused field kernel, packed
   once a frame (`ops/field_kernel.py`). Rays that hit nothing park past the
   far plane and composite as background.

Density probing is plain PyTorch (`apply_field_sigma`, no gradient), as the
JAX package probes in XLA. The grid file is the JAX package's `.npz` (the
occupancy bits `packbits`-packed), so a grid moves between the packages.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.models.field import FieldConfig, apply_field_sigma
from mofanerf_tpu_torch.ops.composite import composite, sigma_act
from mofanerf_tpu_torch.ops.embed import fourier_embed
from mofanerf_tpu_torch.ops.field_kernel import FusedParams, fused_field_apply, pack_fused_params
from mofanerf_tpu_torch.ops.sampling import _unit_steps, stratified_z_vals
from mofanerf_tpu_torch.ops.sweep import sweep_frame
from mofanerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


class OccupancyGrid(NamedTuple):
    occ: torch.Tensor       # [G, G, G] bool
    aabb_min: torch.Tensor  # [3] f32
    aabb_max: torch.Tensor  # [3] f32


def dilate_occupancy(occ: torch.Tensor, cells: int = 1) -> torch.Tensor:
    """Morphological dilation of a boolean [G, G, G] grid: a (2 cells + 1)^3
    max filter, zero outside the grid."""
    if cells <= 0:
        return occ
    k = 2 * cells + 1
    x = F.max_pool3d(occ.float()[None, None], k, stride=1, padding=cells)
    return x[0, 0] > 0.0


def probe_density(params: Params, cfg: FieldConfig, cond: Params, grid: OccupancyGrid,
                  chunk: int = 65536) -> torch.Tensor:
    """The field's raw sigma at every cell centre of `grid`, [G^3] f32 in the
    grid's C order, through the sigma-only apply (no rgb trunk or view head)."""
    G = grid.occ.shape[0]
    lo, hi = grid.aabb_min, grid.aabb_max
    t = (torch.arange(G, device=lo.device) + 0.5) / G
    X, Y, Z = torch.meshgrid(lo[0] + t * (hi[0] - lo[0]), lo[1] + t * (hi[1] - lo[1]),
                             lo[2] + t * (hi[2] - lo[2]), indexing="ij")
    pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
    with torch.no_grad():
        sig = [apply_field_sigma(params, cond, fourier_embed(pts[i:i + chunk], cfg.multires),
                                 cfg)[:, 0] for i in range(0, pts.shape[0], chunk)]
    return torch.cat(sig).float()


def build_occupancy_grid(params: Params, cfg: FieldConfig, cond: Params, resolution: int = 64,
                         aabb_min=(-5.0, -5.0, -5.0), aabb_max=(5.0, 5.0, 5.0),
                         density_threshold: float = 1.0, chunk: int = 65536,
                         sigma_activation: str = "relu", dilate_cells: int = 1) -> OccupancyGrid:
    """Probe a field's density at the cell centres of a `resolution`^3 grid
    over the box, keep the cells whose ACTIVATED density exceeds the
    threshold, dilate. The default box covers the FaceScape head at world
    scale 1/50."""
    G = resolution
    dev = params["xyz"]["b"].device
    lo = torch.as_tensor(aabb_min, dtype=torch.float32).to(dev)
    hi = torch.as_tensor(aabb_max, dtype=torch.float32).to(dev)
    shell = OccupancyGrid(torch.zeros((G, G, G), dtype=torch.bool, device=lo.device), lo, hi)
    sig = sigma_act(sigma_activation)(probe_density(params, cfg, cond, shell, chunk))
    occ = dilate_occupancy((sig > density_threshold).reshape(G, G, G), dilate_cells)
    return OccupancyGrid(occ, lo, hi)


def build_proposal_grid(params: Params, spec, cond, **kw) -> OccupancyGrid:
    """The grid of the COARSE (proposal) field of a two-pass model: the coarse
    net is trained on stratified samples along every ray, so it is the field
    that answers "is this cell empty?". `params`/`spec`/`cond` are the full
    model's (with .coarse); kw goes to build_occupancy_grid."""
    kw.setdefault("sigma_activation", spec.render.sigma_activation)
    return build_occupancy_grid(params["coarse"], spec.coarse, cond.coarse, **kw)


def update_occupancy_grid(grid: OccupancyGrid, density_ema: torch.Tensor, params: Params,
                          cfg: FieldConfig, cond: Params, decay: float = 0.95,
                          density_threshold: float = 1.0, sigma_activation: str = "relu",
                          dilate_cells: int = 1):
    """Training-time upkeep: re-probe every cell, keep max(ema * decay,
    fresh) of the ACTIVATED density, threshold and dilate again. Returns
    (new grid, new density_ema [G^3])."""
    fresh = sigma_act(sigma_activation)(probe_density(params, cfg, cond, grid))
    ema = torch.maximum(density_ema * decay, fresh)
    G = grid.occ.shape[0]
    occ = dilate_occupancy((ema > density_threshold).reshape(G, G, G), dilate_cells)
    return OccupancyGrid(occ, grid.aabb_min, grid.aabb_max), ema


def occupancy_lookup(grid: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> bool occupancy (False outside the box)."""
    G = grid.occ.shape[0]
    u = (pts - grid.aabb_min) / (grid.aabb_max - grid.aabb_min)
    idx = torch.floor(u * G).to(torch.int64)
    inside = ((idx >= 0) & (idx < G)).all(dim=-1)
    idx = torch.clamp(idx, 0, G - 1)
    return grid.occ[idx[..., 0], idx[..., 1], idx[..., 2]] & inside


def render_rays_occupancy(params_fine: Params, cfg: FieldConfig, cond_fine: Params,
                          grid: OccupancyGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          near: float, far: float, s_probe: int = 64, k_keep: int = 32,
                          white_bkgd: bool = False, sigma_activation: str = "relu",
                          fused: FusedParams | None = None) -> Dict[str, torch.Tensor]:
    """Deterministic occupancy-culled render of a ray packet through the fine
    field: {rgb, disp, acc, depth}. `fused` holds the kernel's operands for
    `cond_fine` (a frame packs them once); made here when None."""
    n, dev = rays_o.shape[0], rays_o.device
    with torch.no_grad():
        if fused is None:
            fused = pack_fused_params(params_fine, cond_fine, cfg)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        dirf = fourier_embed(viewdirs, cfg.multires_views) @ params_fine["view"]["w_dirs"]

        z = stratified_z_vals(None, torch.full((n, 1), near, device=dev),
                              torch.full((n, 1), far, device=dev), s_probe, perturb=0.0)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        occ = occupancy_lookup(grid, pts)   # [N, S]

        # respace k_keep samples evenly over the ray's occupied band [first
        # occupied probe, last occupied probe]; rays that hit nothing park
        # past the far plane
        any_occ = occ.any(dim=-1)
        t0 = torch.where(occ, z, torch.full_like(z, torch.inf)).amin(dim=-1)
        t1 = torch.where(occ, z, torch.full_like(z, -torch.inf)).amax(dim=-1)
        t0 = torch.where(any_occ, t0, torch.full_like(t0, far + 1.0))
        t1 = torch.where(any_occ, t1, torch.full_like(t1, far + 2.0))
        frac = _unit_steps(k_keep, dev)
        zk = t0[:, None] * (1.0 - frac) + t1[:, None] * frac
        keep_mask = zk <= far
        zk = torch.clamp(zk, max=far)

        pts_k = rays_o[:, None, :] + rays_d[:, None, :] * zk[..., None]
        pe = fourier_embed(pts_k.reshape(-1, 3), cfg.multires).contiguous()
        raw_rgb, raw_sigma = fused_field_apply(fused, pe, dirf.contiguous(), cfg, k_keep)
        raw_rgb = raw_rgb.reshape(n, k_keep, 3)
        # culled slots contribute nothing even where the field disagrees with
        # the grid. The respaced band samples themselves are not looked up in
        # the grid again: the JAX package's behaviour, kept
        raw_sigma = torch.where(keep_mask, raw_sigma.reshape(n, k_keep),
                                torch.full_like(zk, -1e10))
        c = composite(raw_rgb, raw_sigma, zk, rays_d, 0.0, white_bkgd, None,
                      sigma_activation=sigma_activation)
    return {"rgb": c.rgb, "disp": c.disp, "acc": c.acc, "depth": c.depth}


def grid_aabb(grid: OccupancyGrid, margin_cells: int = 1):
    """Tight box of the grid's occupied cells plus a margin, on the host:
    (min, max) tuples of floats; the grid's whole box when nothing is
    occupied. It bounds distillation's sampling and the serving box."""
    occ = grid.occ.cpu().numpy()
    G = occ.shape[0]
    lo = grid.aabb_min.cpu().numpy().astype(np.float64)
    hi = grid.aabb_max.cpu().numpy().astype(np.float64)
    if not occ.any():
        return tuple(lo.tolist()), tuple(hi.tolist())
    cell = (hi - lo) / G
    idx = np.stack(np.nonzero(occ), axis=-1)   # [K, 3]
    cmin = np.maximum(idx.min(axis=0) - margin_cells, 0)
    cmax = np.minimum(idx.max(axis=0) + 1 + margin_cells, G)
    return tuple((lo + cmin * cell).tolist()), tuple((lo + cmax * cell).tolist())


def save_grid(path: str, grid: OccupancyGrid, density_ema: torch.Tensor | None = None) -> None:
    """Write a grid (and the EMA density it carries) as a compressed `.npz`,
    the JAX package's format."""
    arrs = dict(
        resolution=grid.occ.shape[0],
        occ=np.packbits(grid.occ.cpu().numpy()),
        aabb_min=grid.aabb_min.cpu().numpy(),
        aabb_max=grid.aabb_max.cpu().numpy(),
    )
    if density_ema is not None:
        arrs["density_ema"] = density_ema.detach().cpu().numpy().astype(np.float32)
    np.savez_compressed(path, **arrs)


def load_grid(path: str, device="cuda"):
    """Inverse of save_grid: (OccupancyGrid, density_ema or None) on `device`."""
    dev = resolve_device(device)
    with np.load(path) as d:
        G = int(d["resolution"])
        bits = np.unpackbits(d["occ"])[: G ** 3].reshape(G, G, G).astype(bool)
        grid = OccupancyGrid(torch.from_numpy(bits).to(dev),
                             torch.from_numpy(np.asarray(d["aabb_min"], np.float32)).to(dev),
                             torch.from_numpy(np.asarray(d["aabb_max"], np.float32)).to(dev))
        ema = (torch.from_numpy(np.asarray(d["density_ema"], np.float32)).to(dev)
               if "density_ema" in d else None)
    return grid, ema


def ray_aabb_hit(grid: OccupancyGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near: float, far: float) -> torch.Tensor:
    """Slab test: does each ray's [near, far] segment meet the grid's box? [N] bool."""
    inv = 1.0 / torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    t0 = (grid.aabb_min - rays_o) * inv
    t1 = (grid.aabb_max - rays_o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return (tmax >= tmin) & (tmax >= near) & (tmin <= far)


def render_frame_fast(params: Params, spec, cond_fine: Params, grid: OccupancyGrid, H: int,
                      W: int, K, c2w, s_probe: int = 64, k_keep: int = 32,
                      hit_fraction: float | None = None) -> Dict[str, torch.Tensor]:
    """Full-frame occupancy-culled render through the fine field, in packets
    of `spec.render.packet_size` rays, with the kernel's operands packed once.
    `hit_fraction` compacts background rays by the slab test against the
    grid's box; None (default) measures the frame's hit share and buckets it
    up (ops/sweep.py), so no foreground ray is dropped. K and c2w may be numpy
    arrays. Returns [H, W, ...] maps."""
    dev = grid.occ.device
    rc = spec.render
    K = torch.as_tensor(K, dtype=torch.float32).to(dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32).to(dev)
    with torch.no_grad():
        fused = pack_fused_params(params["fine"], cond_fine, spec.fine)

        def packet(o, d):
            return render_rays_occupancy(params["fine"], spec.fine, cond_fine, grid, o, d,
                                         rc.near, rc.far, s_probe, k_keep, rc.white_bkgd,
                                         rc.sigma_activation, fused=fused)

        return sweep_frame(packet, H, W, K, c2w, rc.packet_size,
                           aabb_min=grid.aabb_min, aabb_max=grid.aabb_max,
                           near=rc.near, far=rc.far, hit_fraction=hit_fraction,
                           white_bkgd=rc.white_bkgd)
