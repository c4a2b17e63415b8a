"""MoFaNeRF as published (arXiv:2112.02308), in plain PyTorch and f32.

Each layer that the paper writes as `concat([code, features]) @ W` is
computed so, on the concatenation, from the weight blocks the benchmark made
(the program folds the codes into biases instead). The texture encoder,
the identity-specific modulation (ISM), the positional encodings, the two
passes of stratified and inverse-CDF sampling and the compositing follow
the reference implementation (github.com/zhuhao-nju/mofanerf).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision


def embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(x f0), cos(x f0), sin(x f1), ...] with bands 2^0 .. 2^(n-1)."""
    out = [x]
    for k in range(n_freqs):
        f = float(2 ** k)
        out += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(out, dim=-1)


def _rows(code: torch.Tensor, n: int) -> torch.Tensor:
    return code.reshape(1, -1).expand(n, -1)


def _dense(p: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return p.mm(x, w) + b


def _trunk(t: dict, code: torch.Tensor, feat: torch.Tensor, p: Precision) -> torch.Tensor:
    """skipMLP on [code, feat]: a first layer, the middle layers, the skip
    layer on [code, feat, h], the layers after it; ReLU after each."""
    n = feat.shape[0]
    c = _rows(code, n)
    h = F.relu(_dense(p, torch.cat([c, feat], -1), torch.cat([t["w_code0"], t["w_feat0"]]),
                      t["b0"]))
    for layer in t["mid"]:
        h = F.relu(_dense(p, h, layer["w"], layer["b"]))
    h = F.relu(_dense(p, torch.cat([c, feat, h], -1),
                      torch.cat([t["w_skip_code"], t["w_skip_feat"], t["w_skip_h"]]),
                      t["b_skip"]))
    for layer in t["post"]:
        h = F.relu(_dense(p, h, layer["w"], layer["b"]))
    return h


def field(params: dict, pts: torch.Tensor, dirs_embed: torch.Tensor, shape: torch.Tensor,
          exp_mod: torch.Tensor, tex: torch.Tensor, multires: int,
          p: Precision) -> tuple:
    """pts [N, 3], dirs_embed [N, 27] (a row a point) -> (raw rgb [N, 3],
    raw sigma [N])."""
    n = pts.shape[0]
    pe = embed(pts, multires)
    x = params["xyz"]
    h = F.relu(_dense(p, torch.cat([pe, _rows(exp_mod, n)], -1),
                      torch.cat([x["w_pts"], x["w_exp"]]), x["b"]))
    for layer in x["layers"]:
        h = F.relu(_dense(p, h, layer["w"], layer["b"]))
    s = params["sigma"]
    sigma_feat = _trunk(s, shape, h, p)
    sigma = _dense(p, sigma_feat, s["alpha"]["w"], s["alpha"]["b"])[:, 0]
    rgb_feat = _trunk(params["rgb"], tex, sigma_feat, p)
    v = params["view"]
    view = F.relu(_dense(p, torch.cat([dirs_embed, rgb_feat], -1),
                         torch.cat([v["w_dirs"], v["w_feat"]]), v["b"]))
    rgb = _dense(p, view, v["rgb"]["w"], v["rgb"]["b"])
    return rgb, sigma


def ism(params: dict, shape: torch.Tensor, exp: torch.Tensor, p: Precision) -> torch.Tensor:
    """exp' = scale(shape) * exp + bias(shape), a 4-layer ReLU MLP."""
    h = shape.reshape(1, -1)
    for layer in params["layers"]:
        h = F.relu(_dense(p, h, layer["w"], layer["b"]))
    scale = _dense(p, h, params["scale"]["w"], params["scale"]["b"])[0]
    bias = _dense(p, h, params["bias"]["w"], params["bias"]["b"])[0]
    return scale * exp + bias


def tex_encoder(state: dict, uv: torch.Tensor) -> torch.Tensor:
    """UV map [S, S, 3] -> texture code [256]: seven 4x4 stride-2
    convolutions with LeakyReLU(0.2), the flatten in (row, column, channel)
    order, FC 512 with LeakyReLU(0.2), `mu`, three LeakyReLU(0.1) layers."""
    x = uv.permute(2, 0, 1)[None]
    k = 0
    while f"convs.{k}.weight" in state:
        x = F.leaky_relu(F.conv2d(x, state[f"convs.{k}.weight"], state[f"convs.{k}.bias"],
                                  stride=2, padding=1), 0.2)
        k += 1
    x = x.permute(0, 2, 3, 1).reshape(1, -1)
    x = F.leaky_relu(F.linear(x, state["fc.weight"], state["fc.bias"]), 0.2)
    h = F.linear(x, state["mu.weight"], state["mu.bias"])
    k = 0
    while f"decoding.{k}.weight" in state:
        h = F.leaky_relu(F.linear(h, state[f"decoding.{k}.weight"], state[f"decoding.{k}.bias"]),
                         0.1)
        k += 1
    return h[0]


def codes(params: dict, shape: torch.Tensor, expression: int, uv: torch.Tensor,
          p: Precision) -> tuple:
    """(shape code, modulated expression code, texture code) of a frame."""
    exp = params["exp_codes"][expression]
    return shape, ism(params["ism"], shape, exp, p), tex_encoder(params["tex_encoder"], uv)


def stratified(n_rays: int, n: int, near: float, far: float, u, device) -> torch.Tensor:
    """n depths a ray in [near, far], jittered within their strata by the
    uniforms `u` [n_rays, n] (evenly spaced when u is None)."""
    t = torch.linspace(0.0, 1.0, n, device=device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n)
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int, u) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf of `weights` over
    `bins` (the reference's sample_pdf: a 1e-5 floor on the weights, evenly
    spaced quantiles when u is None)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(cdf.shape[0], n)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return (bins_b + (u - cdf_b) / denom * (bins_a - bins_b)).detach()


def composite(raw_rgb, raw_sigma, z, rays_d, white_bkgd: bool) -> dict:
    """Alpha compositing with ReLU density; the last interval reaches 1e10."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * rays_d.norm(dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-F.relu(raw_sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[:, :-1]
    w = alpha * trans
    rgb = (w[..., None] * torch.sigmoid(raw_rgb)).sum(1)
    acc = w.sum(-1)
    if white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "acc": acc, "weights": w, "depth": (w * z).sum(-1)}


def render_rays(params: dict, cfg: dict, frame_codes: tuple, rays_o: torch.Tensor,
                rays_d: torch.Tensor, p: Precision, draws: dict | None = None,
                white_bkgd: bool = False) -> dict:
    """Both passes over a batch of rays: the coarse field at N_samples
    stratified depths, N_importance more by inverse CDF of its weights, the
    fine field on the union. `draws` ({'strat', 'pdf'}: uniforms) jitter the
    depths as in training; without them the depths are deterministic.
    Returns {'rgb', 'rgb0', 'acc'}."""
    shape, exp_mod, tex = frame_codes
    n = rays_o.shape[0]
    n_c, n_i, mr = cfg["N_samples"], cfg["N_importance"], cfg["multires"]
    draws = draws or {}
    viewdirs = rays_d / rays_d.norm(dim=-1, keepdim=True)
    de = embed(viewdirs, cfg["multires_views"])
    z = stratified(n, n_c, cfg["near"], cfg["far"], draws.get("strat"), rays_o.device)

    def run(name, zs):
        s = zs.shape[1]
        pts = (rays_o[:, None] + rays_d[:, None] * zs[..., None]).reshape(-1, 3)
        rgb, sigma = field(params[name], pts, de.repeat_interleave(s, 0), shape, exp_mod, tex,
                           mr, p)
        return composite(rgb.reshape(n, s, 3), sigma.reshape(n, s), zs, rays_d, white_bkgd)

    c = run("coarse", z)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    zi = sample_pdf(mids, c["weights"][:, 1:-1].detach(), n_i, draws.get("pdf"))
    f = run("fine", torch.sort(torch.cat([z, zi], -1), -1).values)
    return {"rgb": f["rgb"], "rgb0": c["rgb"], "acc": f["acc"]}
