"""The distilled student served over a ray's own interval in the head's box,
in plain PyTorch and f32: a ReLU MLP on the positional encoding, a density
head, a feature head that the view direction's encoding joins, an rgb head;
samples evenly spaced between the ray's entry into and exit from the box
(clipped to near / far); alpha compositing. A ray that misses the box is
empty."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nerf import embed
from benchmark.reference.precision import Precision


def box_interval(rays_o, rays_d, lo, hi, near: float, far: float):
    """(t0, t1, hit) of each ray against the box [lo, hi] (the slab test)."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=rays_o.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=rays_o.device)
    inv = 1.0 / torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    ta, tb = (lo - rays_o) * inv, (hi - rays_o) * inv
    t0 = torch.minimum(ta, tb).amax(-1).clamp(min=near)
    t1 = torch.maximum(ta, tb).amin(-1).clamp(max=far)
    return t0, t1, t1 > t0


def render(params: dict, cfg: dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
           p: Precision) -> dict:
    """{'rgb' [N, 3], 'acc' [N]} of the student `params` (a tree of f32
    weights [in, out]) along each ray."""
    n, S = rays_o.shape[0], cfg["n_samples"]
    t0, t1, hit = box_interval(rays_o, rays_d, cfg["aabb_min"], cfg["aabb_max"], cfg["near"],
                               cfg["far"])
    t = torch.linspace(0.0, 1.0, S, device=rays_o.device)
    z = t0[:, None] + (t1 - t0)[:, None] * t
    pts = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3)
    h = F.relu(p.mm(embed(pts, cfg["multires"]), params["input"]["w"]) + params["input"]["b"])
    for layer in params["layers"]:
        h = F.relu(p.mm(h, layer["w"]) + layer["b"])
    sigma = (p.mm(h, params["sigma"]["w"]) + params["sigma"]["b"]).reshape(n, S)
    viewdirs = rays_d / rays_d.norm(dim=-1, keepdim=True)
    dirf = p.mm(embed(viewdirs, cfg["multires_views"]), params["view"]["w_dirs"])
    feat = (p.mm(h, params["feat"]["w"]) + params["feat"]["b"]).reshape(n, S, -1)
    view = F.relu(feat + dirf[:, None]).reshape(n * S, -1)
    rgb = torch.sigmoid(p.mm(view, params["rgb"]["w"]) + params["rgb"]["b"]).reshape(n, S, 3)
    sigma = torch.where(hit[:, None], F.relu(sigma), torch.zeros_like(sigma))
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * rays_d.norm(dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[:, :-1]
    w = alpha * trans
    acc = w.sum(-1)
    out = (w[..., None] * rgb).sum(1)
    if cfg.get("white_bkgd"):
        out = out + (1.0 - acc[:, None])
    return {"rgb": out, "acc": acc}
