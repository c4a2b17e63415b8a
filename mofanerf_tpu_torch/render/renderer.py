"""Two-pass volume renderer of the teacher model (counterpart of
mofanerf_tpu/render/renderer.py).

Stratified coarse pass, compositing, inverse-CDF importance resampling, fine
pass, coarse + fine outputs. Everything is an explicit argument; a frame is a
Python loop over fixed-size ray packets. Conditioning codes are folded once a
frame into per-layer biases (`prepare_conditioning`), and the view-direction
features are computed once a ray.

Both fields run through `ops/field_kernel.py::fused_field_apply` on every
device: on the card that is the hand-written CUDA kernel, on the CPU its plain
PyTorch version. So the renderer follows the kernel's precision contract
(products in the compute dtype summed in f32, f32 bias adds, f32 outputs): at
compute_dtype float32 that is the JAX renderer's arithmetic; at bfloat16 it
is close to, not equal to, the JAX XLA path, which also adds biases in
bfloat16. The kernel's operands (`pack_fused_params`, a cast of every weight)
are made once a frame by `pack_frame` and handed down to the packets.

Training asks for the other route explicitly (`render_rays(autograd=True)`):
both fields run `models/field.py::apply_field_folded`, plain differentiable
tensor code in the compute dtype, as the JAX train step differentiates its
XLA field and not the Pallas kernel. Inference keeps the kernel.

`render_frame_sharded` splits a frame's rays over a mesh's `data` axis
(parallel/mesh.py): each rank sweeps its block through the kernel and every
rank gets the whole frame.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from mofanerf_tpu_torch.models.field import (FieldConfig, apply_field_folded, column_axis,
                                             fold_conditioning, init_field_params)
from mofanerf_tpu_torch.models.ism import init_ism_params, modulate_expression
from mofanerf_tpu_torch.models.tex_encoder import TextureEncoder, init_tex_encoder_params
from mofanerf_tpu_torch.ops.composite import composite
from mofanerf_tpu_torch.ops.embed import fourier_embed
from mofanerf_tpu_torch.ops.field_kernel import FusedParams, fused_field_apply, pack_fused_params
from mofanerf_tpu_torch.ops.rays import get_rays
from mofanerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from mofanerf_tpu_torch.parallel.collectives import (ModelAxis, data_rows, gather_blocks, pad_rows,
                                                     padded_len)
from mofanerf_tpu_torch.parallel.mesh import axis_size, gather_params
from mofanerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

N_EXPRESSIONS = 20  # FaceScape expression count
N_EXP_SLOTS = 21    # +1 fitting slot


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering hyperparameters (defaults = configs/exp_mofanerf.txt and the
    canonical camera)."""

    n_coarse: int = 64
    n_importance: int = 64
    perturb: float = 1.0          # 0 for eval
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    near: float = 8.0
    far: float = 26.0
    lindisp: bool = False
    packet_size: int = 8192       # rays a packet of a full frame
    sigma_activation: str = "relu"  # 'relu' (reference) or 'softplus'
    fine_on_union: bool = True    # the fine net sees coarse + importance samples;
                                  # False: only the importance samples


@dataclasses.dataclass(frozen=True)
class MoFaNeRF:
    """Static model spec: coarse + fine field configs + render config
    (reference dims: coarse 8x256, fine 10x1024)."""

    coarse: FieldConfig = FieldConfig(depth=8, width=256)
    fine: FieldConfig = FieldConfig(depth=10, width=1024)
    render: RenderConfig = RenderConfig()
    shape_dim: int = 50
    exp_dim: int = 30
    tex_dim: int = 256
    uv_size: int = 512  # UV map side; >= 128 (the encoder downsamples 2^7)


def init_model_params(generator: torch.Generator, spec: MoFaNeRF, device="cuda") -> Params:
    """Full trainable state: both fields, ISM, the texture encoder's state
    dict, and the expression latent bank [N_EXP_SLOTS, exp_dim] indexed by
    expression type. Draws come from a CPU `torch.Generator`."""
    dev = resolve_device(device)
    return {
        "coarse": init_field_params(generator, spec.coarse, device=dev),
        "fine": init_field_params(generator, spec.fine, device=dev),
        "ism": init_ism_params(generator, in_dim=spec.shape_dim, out_dim=spec.exp_dim,
                               device=dev),
        "tex_encoder": init_tex_encoder_params(generator, spec.tex_dim, spec.uv_size,
                                               device=dev),
        "exp_codes": torch.rand((N_EXP_SLOTS, spec.exp_dim), generator=generator,
                                dtype=torch.float32).to(dev),
    }


@functools.lru_cache(maxsize=None)
def _encoder(tex_dim: int, uv_size: int) -> TextureEncoder:
    # the layer structure only; its weights come from the param tree at call time
    return TextureEncoder(tex_dim, uv_size, device="meta")


def encode_texture(params: Params, spec: MoFaNeRF, uv_map: torch.Tensor) -> torch.Tensor:
    """uv_map [S, S, 3] or [B, S, S, 3] (S = spec.uv_size) -> tex code
    [tex_dim] / [B, tex_dim], in full f32 on the card too."""
    squeeze = uv_map.ndim == 3
    if squeeze:
        uv_map = uv_map[None]
    out = torch.func.functional_call(_encoder(spec.tex_dim, spec.uv_size),
                                     params["tex_encoder"], (uv_map,))
    return out[0] if squeeze else out


class FrameCond(NamedTuple):
    """Per-frame folded conditioning: compute once per (identity, expression,
    texture) with `prepare_conditioning`, then render any number of rays."""

    coarse: Params  # folded biases for the coarse field
    fine: Params    # folded biases for the fine field


def prepare_conditioning(
    params: Params,
    spec: MoFaNeRF,
    shape_code: torch.Tensor,   # [shape_dim]
    exp_code: torch.Tensor,     # [exp_dim] raw latent (pre-ISM)
    tex_code: torch.Tensor,     # [tex_dim]
    tp: ModelAxis | None = None,
) -> FrameCond:
    """ISM-modulate the expression latent and fold all codes into per-layer
    biases for both fields. Differentiable with respect to all three codes.
    With the model axis `tp` and the fine field's layers in column blocks
    (parallel/mesh.py::shard_params), the fine biases are this rank's blocks."""
    exp_mod = modulate_expression(params["ism"], shape_code, exp_code)
    fine_tp = column_axis(params["fine"]["sigma"]["w_feat0"], spec.fine.width, tp)
    return FrameCond(
        coarse=fold_conditioning(params["coarse"], shape_code, exp_mod, tex_code),
        fine=fold_conditioning(params["fine"], shape_code, exp_mod, tex_code, fine_tp),
    )


def exp_code_for(params: Params, exp_type) -> torch.Tensor:
    """Expression latent lookup by expression index (bank slot): an int, or
    an integer tensor on the bank's device, looked up on the device (indexing
    with a 0-dim tensor would read it back to the host and wait for the card)."""
    bank = params["exp_codes"]
    if isinstance(exp_type, torch.Tensor):
        return torch.index_select(bank, 0, exp_type.reshape(1))[0]
    return bank[exp_type]


class FramePack(NamedTuple):
    """The field kernel's operands for one frame's conditioning."""

    coarse: FusedParams
    fine: FusedParams


def pack_frame(params: Params, spec: MoFaNeRF, cond: FrameCond) -> FramePack:
    """Cast and stack both fields' weights for the kernel, once a frame."""
    return FramePack(pack_fused_params(params["coarse"], cond.coarse, spec.coarse),
                     pack_fused_params(params["fine"], cond.fine, spec.fine))


def _run_field(fused: FusedParams, cfg: FieldConfig, pts, dir_feat_ray, n_samples):
    """pts: [N, S, 3]; dir_feat_ray: [N, W//2]. Returns ([N,S,3], [N,S]) in
    f32 through the fused field kernel (its plain version on the CPU)."""
    n_rays = pts.shape[0]
    pe = fourier_embed(pts.reshape(-1, 3), cfg.multires)  # [N*S, 63]
    raw_rgb, raw_sigma = fused_field_apply(
        fused, pe.contiguous(), dir_feat_ray.contiguous(), cfg, n_samples)
    return raw_rgb.reshape(n_rays, n_samples, 3), raw_sigma.reshape(n_rays, n_samples)


def _run_field_autograd(field_params: Params, cfg: FieldConfig, cond: Params, pts,
                        dir_feat_ray, n_samples, tp: ModelAxis | None = None):
    """The differentiable route: apply_field_folded, outputs in the compute dtype."""
    n_rays = pts.shape[0]
    pe = fourier_embed(pts.reshape(-1, 3), cfg.multires)
    raw_rgb, raw_sigma = apply_field_folded(field_params, cond, pe, dir_feat_ray, cfg,
                                            samples_per_ray=n_samples, tp=tp)
    return raw_rgb.reshape(n_rays, n_samples, 3), raw_sigma.reshape(n_rays, n_samples)


def train_draws(generator: torch.Generator, spec: MoFaNeRF, n: int, device,
                draws: Dict[str, torch.Tensor] | None = None) -> Dict[str, torch.Tensor]:
    """The random numbers of render_rays(train=True) for n rays: `draws`,
    and those missing drawn from `generator` (on its device) in this order:
    "strat" U(0,1) [n, n_coarse] when perturb > 0, "noise_c" N(0,1)
    [n, n_coarse] when raw_noise_std > 0, then with importance samples "pdf"
    U(0,1) [n, n_importance] and "noise_f" N(0,1) [n, fine samples] under
    the same conditions. render_rays draws through this function, so the
    train step under a mesh, which draws a whole batch's numbers here and
    cuts them by rank, trains on the numbers one card would."""
    rc = spec.render
    n_fine = rc.n_importance + (rc.n_coarse if rc.fine_on_union else 0)
    wanted = []
    if rc.perturb > 0.0:
        wanted.append(("strat", torch.rand, rc.n_coarse))
    if rc.raw_noise_std > 0.0:
        wanted.append(("noise_c", torch.randn, rc.n_coarse))
    if rc.n_importance > 0 and rc.perturb > 0.0:
        wanted.append(("pdf", torch.rand, rc.n_importance))
    if rc.n_importance > 0 and rc.raw_noise_std > 0.0:
        wanted.append(("noise_f", torch.randn, n_fine))
    out = dict(draws or {})
    for name, draw, k in wanted:
        if name not in out:
            out[name] = draw((n, k), generator=generator, dtype=torch.float32,
                             device=generator.device).to(device)
    return out


def render_rays(
    params: Params,
    spec: MoFaNeRF,
    cond: FrameCond,
    rays_o: torch.Tensor,     # [N, 3]
    rays_d: torch.Tensor,     # [N, 3]
    generator: torch.Generator | None = None,
    train: bool = False,
    draws: Dict[str, torch.Tensor] | None = None,
    pack: FramePack | None = None,
    autograd: bool = False,
    tp: ModelAxis | None = None,
) -> Dict[str, torch.Tensor]:
    """Render a packet of rays. Deterministic when train=False (perturb=0,
    det importance sampling). With train=True the random numbers are injected
    through `draws` ({"strat": U(0,1) [N, n_coarse], "pdf": U(0,1)
    [N, n_importance], "noise_c"/"noise_f": N(0,1) [N, samples]}), and any
    that is missing is drawn from `generator` (`train_draws`).

    `pack` holds the kernel's operands for `cond`; frames pass it so that
    the weights are cast once, not once a packet. `autograd=True` runs both
    fields through apply_field_folded instead of the kernel, so that the
    render can be differentiated (the train step's route); there the model
    axis `tp` runs a field whose layers are column blocks tensor-parallel."""
    rc = spec.render
    n = rays_o.shape[0]
    dev = rays_o.device
    if autograd:
        def field(name, pts, dirf, n_samples):
            return _run_field_autograd(params[name], getattr(spec, name), getattr(cond, name),
                                       pts, dirf, n_samples, tp)
    else:
        if pack is None:
            pack = pack_frame(params, spec, cond)

        def field(name, pts, dirf, n_samples):
            return _run_field(getattr(pack, name), getattr(spec, name), pts, dirf, n_samples)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    de = fourier_embed(viewdirs, spec.coarse.multires_views)  # [N, 27]
    # the fine field may use a different view-embedding bandwidth
    de_fine = (de if spec.fine.multires_views == spec.coarse.multires_views
               else fourier_embed(viewdirs, spec.fine.multires_views))

    perturb = rc.perturb if train else 0.0
    noise_std = rc.raw_noise_std if train else 0.0
    if train and generator is not None:
        draws = train_draws(generator, spec, n, dev, draws)
    draws = draws or {}

    def normal(name):
        if noise_std <= 0.0:
            return None
        if name not in draws:
            raise ValueError("sigma noise requires injected draws or a torch.Generator")
        return draws[name]

    near = torch.full((n, 1), rc.near, dtype=torch.float32, device=dev)
    far = torch.full((n, 1), rc.far, dtype=torch.float32, device=dev)
    z_vals = stratified_z_vals(draws.get("strat"), near, far, rc.n_coarse, perturb,
                               rc.lindisp)

    # --- coarse pass
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dirf_c = de @ params["coarse"]["view"]["w_dirs"]
    raw_rgb, raw_sigma = field("coarse", pts, dirf_c, rc.n_coarse)
    c = composite(raw_rgb, raw_sigma, z_vals, rays_d, noise_std, rc.white_bkgd,
                  normal("noise_c"), rc.sigma_activation)

    out = {}
    if rc.n_importance > 0:
        out["rgb0"], out["disp0"], out["acc0"] = c.rgb, c.disp, c.acc

        # --- importance resample (the weights' end points dropped)
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(draws.get("pdf"), z_mid, c.weights[..., 1:-1], rc.n_importance,
                               det=(perturb == 0.0))
        if rc.fine_on_union:
            z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        else:
            z_all = torch.sort(z_samples, dim=-1).values
        n_fine = z_all.shape[-1]

        # --- fine pass
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
        dirf_f = de_fine @ params["fine"]["view"]["w_dirs"]
        f_rgb, f_sigma = field("fine", pts, dirf_f, n_fine)
        cf = composite(f_rgb, f_sigma, z_all, rays_d, noise_std, rc.white_bkgd,
                       normal("noise_f"), rc.sigma_activation)
        out["rgb"], out["disp"], out["acc"] = cf.rgb, cf.disp, cf.acc
        out["depth"] = cf.depth
        out["z_std"] = torch.std(z_samples, dim=-1, unbiased=False)
    else:
        out["rgb"], out["disp"], out["acc"] = c.rgb, c.disp, c.acc
        out["depth"] = c.depth
    return out


def _params_device(params: Params) -> torch.device:
    return params["exp_codes"].device


def _sweep(params: Params, spec: MoFaNeRF, cond: FrameCond, pack: FramePack, H: int, W: int,
           K, c2w, p: int, n_total: int, mesh=None) -> Dict[str, torch.Tensor]:
    """A frame's rays padded with rays of ones to n_total (under `mesh`: cut
    to this data rank's block) and rendered packet by packet, p rays each;
    the maps flat."""
    dev = _params_device(params)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    rays = (pad_rows(r.reshape(-1, 3), n_total) for r in get_rays(H, W, K, c2w))
    ro, rd = (r if mesh is None else data_rows(r, mesh) for r in rays)
    maps = [render_rays(params, spec, cond, o, d, train=False, pack=pack)
            for o, d in zip(ro.reshape(-1, p, 3), rd.reshape(-1, p, 3))]
    return {k: torch.cat([m[k] for m in maps]) for k in maps[0]}


def _frame_maps(flat: Dict[str, torch.Tensor], H: int, W: int) -> Dict[str, torch.Tensor]:
    return {k: v[:H * W].reshape((H, W) + v.shape[1:]) for k, v in flat.items()}


def render_frame(
    params: Params,
    spec: MoFaNeRF,
    cond: FrameCond,
    H: int,
    W: int,
    K,
    c2w,
    pack: FramePack | None = None,
) -> Dict[str, torch.Tensor]:
    """Render a full HxW frame deterministically, on the params' device (K
    and c2w may be numpy arrays). Rays are padded with rays of ones to a
    multiple of `packet_size` and swept packet by packet; the kernel's
    operands are packed once, before the sweep. Returns maps reshaped to
    [H, W, ...]. No autograd graph is built."""
    with torch.no_grad():
        if pack is None:
            pack = pack_frame(params, spec, cond)
        p = min(spec.render.packet_size, H * W)
        flat = _sweep(params, spec, cond, pack, H, W, K, c2w, p, padded_len(H * W, p))
    return _frame_maps(flat, H, W)


def _gather_model(params: Params, spec: MoFaNeRF, cond: FrameCond, rules: Params, mesh):
    """Whole params and conditioning from this rank's model shards: the fine
    field's weights (`rules`) and its folded biases (those narrower than the
    field's width)."""
    params = gather_params(params, rules, mesh)
    keys = [k for k, v in cond.fine.items() if v.shape[-1] != spec.fine.width]
    whole = gather_blocks([(cond.fine[k], 0) for k in keys], mesh, "model")
    return params, FrameCond(cond.coarse, {**cond.fine, **dict(zip(keys, whole))})


def render_frame_sharded(
    params: Params,
    spec: MoFaNeRF,
    cond: FrameCond,
    H: int,
    W: int,
    K,
    c2w,
    mesh,
    rules: Params | None = None,
) -> Dict[str, torch.Tensor]:
    """Multi-card full-frame render: the frame's rays, padded with rays of
    ones to packets x n_data (p = min(packet_size, max(1, n // n_data)), as
    the JAX package pads them), are split over the mesh's `data` axis; every
    rank renders its contiguous block packet by packet through the field
    kernel, with no collective, and the maps are gathered on every rank and
    cut to [H, W, ...].

    Every rank passes the same params and conditioning: whole, or, with
    `rules` (shard_params_rules of the whole tree), its model shards, which
    are gathered once a frame before the kernel's operands are packed (the
    kernel runs every layer of a block in one CTA; it is not split)."""
    n_data = axis_size(mesh, "data")
    with torch.no_grad():
        if rules is not None:
            params, cond = _gather_model(params, spec, cond, rules, mesh)
        p = min(spec.render.packet_size, max(1, H * W // n_data))
        local = _sweep(params, spec, cond, pack_frame(params, spec, cond), H, W, K, c2w, p,
                       padded_len(H * W, p * n_data), mesh)
        whole = gather_blocks([(v, 0) for v in local.values()], mesh)
    return _frame_maps(dict(zip(local, whole)), H, W)


def render_path(
    params: Params,
    spec: MoFaNeRF,
    conds,                       # FrameCond or list of FrameCond (one a pose)
    poses,                       # [N, 3, 4] or [N, 4, 4] c2w sequence
    hwf,                         # (H, W, focal)
    render_factor: int = 0,
):
    """Render a camera path; `render_factor` downsamples for fast previews.
    Returns (rgbs [N,H,W,3], disps [N,H,W]) as numpy. One shared FrameCond is
    packed for the kernel once for the whole path."""
    H, W, focal = hwf
    if render_factor:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32)
    per_pose = isinstance(conds, (list, tuple)) and not isinstance(conds, FrameCond)
    with torch.no_grad():
        shared = None if per_pose else pack_frame(params, spec, conds)
    rgbs, disps = [], []
    for i, c2w in enumerate(poses):
        cond = conds[i] if per_pose else conds
        out = render_frame(params, spec, cond, H, W, K, np.asarray(c2w)[:3], pack=shared)
        rgbs.append(out["rgb"].cpu().numpy())
        disps.append(out["disp"].cpu().numpy())
    return np.stack(rgbs), np.stack(disps)
