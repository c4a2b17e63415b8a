"""The conditioned NeRF field in block-parameter form (counterpart of
mofanerf_tpu/models/field.py).

    xyz_code   = xyzEncode([pts_embed(63), exp'(30)])          # skipMLP D=3
    sigma_feat = linear_BiM_xyz([shape(50), xyz_code])          # skipMLP D, skip=4
    alpha      = alpha_linear(sigma_feat)                       # W -> 1
    rgb_feat   = linear_uv_xyzBiM([tex(256), sigma_feat])       # skipMLP D, skip=4
    view_feat  = relu(Linear([dirs_embed(27), rgb_feat]))       # -> W/2
    rgb        = rgb_linear(view_feat)                          # W/2 -> 3

Every `concat([code, features]) @ W` is stored as separate weight blocks
`features @ W_f + code @ W_c + b`. The codes are constant over a frame, so
`fold_conditioning` computes `code @ W_c + b` once a frame and the per-point
hot loop (`apply_field_folded`) is a plain dense MLP on 63-dim inputs with
folded biases; the view-direction contribution is folded once a ray.

Params are a plain dict of f32 tensors laid out as the JAX package's param
tree, weights [in, out], so `x @ W` and the bridge map one to one. The
functions here are differentiable tensor code: on the card in bf16 each
hidden layer is one fused op (`ops/fused_linear.py`), elsewhere plain
PyTorch; the renderer's inference path runs the same math through
`ops/field_kernel.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.ops.embed import embed_dim, fourier_embed
from mofanerf_tpu_torch.ops.fused_linear import linear_relu
from mofanerf_tpu_torch.parallel.collectives import ModelAxis, copy_to_model, gather_from_model
from mofanerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static architecture config (defaults = reference coarse dims)."""

    depth: int = 8               # netdepth (coarse 8 / fine 10)
    width: int = 256             # netwidth (coarse 256 / fine 1024)
    skip: int = 4                # skip-concat layer index inside trunks
    xyz_depth: int = 3           # xyzEncode depth (D=3 => 4 linear layers)
    multires: int = 10           # xyz positional encoding bands -> 63 dims
    multires_views: int = 4      # viewdir encoding bands -> 27 dims
    shape_dim: int = 50          # FaceScape identity factors
    exp_dim: int = 30            # expression latent length
    tex_dim: int = 256           # texture code length
    compute_dtype: Any = torch.float32  # bfloat16 for the hot path

    @property
    def pts_embed_dim(self) -> int:
        return embed_dim(3, self.multires)

    @property
    def views_embed_dim(self) -> int:
        return embed_dim(3, self.multires_views)


def _trunk_shapes(cfg: FieldConfig, code_dim: int) -> Params:
    W = cfg.width
    dense = {"w": (W, W), "b": (W,)}
    return {
        "w_code0": (code_dim, W), "w_feat0": (W, W), "b0": (W,),
        "mid": [dict(dense) for _ in range(cfg.skip)],
        "w_skip_code": (code_dim, W), "w_skip_feat": (W, W), "w_skip_h": (W, W),
        "b_skip": (W,),
        "post": [dict(dense) for _ in range(cfg.depth - cfg.skip - 2)],
    }


def field_param_shapes(cfg: FieldConfig) -> Params:
    """The param tree of `cfg` with shapes as leaves, as init_field_params
    lays it out; the bridge checks leaves against it."""
    W, pe, ve = cfg.width, cfg.pts_embed_dim, cfg.views_embed_dim
    sigma = _trunk_shapes(cfg, cfg.shape_dim)
    sigma["alpha"] = {"w": (W, 1), "b": (1,)}
    return {
        "xyz": {"w_pts": (pe, W), "w_exp": (cfg.exp_dim, W), "b": (W,),
                "layers": [{"w": (W, W), "b": (W,)} for _ in range(cfg.xyz_depth)]},
        "sigma": sigma,
        "rgb": _trunk_shapes(cfg, cfg.tex_dim),
        "view": {"w_dirs": (ve, W // 2), "w_feat": (W, W // 2), "b": (W // 2,),
                 "rgb": {"w": (W // 2, 3), "b": (3,)}},
    }


def init_field_params(generator: torch.Generator, cfg: FieldConfig,
                      device="cuda") -> Params:
    """Xavier-uniform (ReLU gain) weights whose bound is over each layer's
    full *concatenated* fan-in, so the block form has the init statistics of
    the concat form, and torch-Linear bias bounds U(+-1/sqrt(fan_in)). The
    draws come from a CPU `torch.Generator`, so the values differ from JAX's."""
    dev = resolve_device(device)
    W, D, skip = cfg.width, cfg.depth, cfg.skip
    pe, ve = cfg.pts_embed_dim, cfg.views_embed_dim
    gain = np.sqrt(2.0)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).to(dev)

    def block(total_in, out, block_in):
        return uniform((block_in, out), gain * np.sqrt(6.0 / (total_in + out)))

    def bias(fan_in, out):
        return uniform((out,), 1.0 / np.sqrt(fan_in))

    def dense(total_in, out):
        return {"w": block(total_in, out, total_in), "b": bias(total_in, out)}

    xyz_in = pe + cfg.exp_dim
    xyz = {
        "w_pts": block(xyz_in, W, pe),
        "w_exp": block(xyz_in, W, cfg.exp_dim),
        "b": bias(xyz_in, W),
        "layers": [dense(W, W) for _ in range(cfg.xyz_depth)],
    }

    def trunk(code_dim):
        # skipMLP(D, W, input_ch=code_dim+W, skip): layer0 + `skip` mid layers,
        # a skip layer on [code, feat_in, h], then D-skip-2 post layers
        t_in = code_dim + W
        sk_in = t_in + W
        return {
            "w_code0": block(t_in, W, code_dim),
            "w_feat0": block(t_in, W, W),
            "b0": bias(t_in, W),
            "mid": [dense(W, W) for _ in range(skip)],
            "w_skip_code": block(sk_in, W, code_dim),
            "w_skip_feat": block(sk_in, W, W),
            "w_skip_h": block(sk_in, W, W),
            "b_skip": bias(sk_in, W),
            "post": [dense(W, W) for _ in range(D - skip - 2)],
        }

    sigma = trunk(cfg.shape_dim)
    sigma["alpha"] = dense(W, 1)
    rgb = trunk(cfg.tex_dim)

    view_in = ve + W
    view = {
        "w_dirs": block(view_in, W // 2, ve),
        "w_feat": block(view_in, W // 2, W),
        "b": bias(view_in, W // 2),
        "rgb": dense(W // 2, 3),
    }
    return {"xyz": xyz, "sigma": sigma, "rgb": rgb, "view": view}


def field_param_count(params: Params) -> int:
    if isinstance(params, dict):
        return sum(field_param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(field_param_count(v) for v in params)
    return int(params.numel())


def fold_conditioning(
    params: Params,
    shape_code: torch.Tensor,  # [shape_dim]
    exp_code: torch.Tensor,    # [exp_dim] (already ISM-modulated)
    tex_code: torch.Tensor,    # [tex_dim]
    tp: ModelAxis | None = None,
) -> Params:
    """The codes' contributions to every code-consuming layer, as per-frame
    bias vectors. Differentiable with respect to the codes, so fitting by
    gradient flows through the fold. With `tp` (`column_axis`) the weights
    are this rank's column blocks and so are the biases; the codes' gradients
    are summed over the model axis."""
    if tp is not None:
        shape_code, exp_code, tex_code = (copy_to_model(c, tp)
                                          for c in (shape_code, exp_code, tex_code))
    x, s, r = params["xyz"], params["sigma"], params["rgb"]
    return {
        "xyz_b": x["b"] + exp_code @ x["w_exp"],
        "sigma_b0": s["b0"] + shape_code @ s["w_code0"],
        "sigma_bskip": s["b_skip"] + shape_code @ s["w_skip_code"],
        "rgb_b0": r["b0"] + tex_code @ r["w_code0"],
        "rgb_bskip": r["b_skip"] + tex_code @ r["w_skip_code"],
    }


def column_axis(w: torch.Tensor, width: int, tp: ModelAxis | None) -> ModelAxis | None:
    """`tp` when the weight `w` of a layer with `width` output columns holds
    this rank's column block (parallel/mesh.py::shard_params_rules), else
    None: the layer then runs whole."""
    return None if tp is None or w.shape[-1] == width else tp


def _layer(pairs, b, dt, tp: ModelAxis | None = None):
    """sum(x @ w for x, w in pairs) + b in the compute dtype. Under `tp` each
    w is this rank's column block: the inputs enter through copy_to_model and
    the output block is gathered over the model axis."""
    y = None
    for x, w in pairs:
        p = (x if tp is None else copy_to_model(x, tp)) @ w.to(dt)
        y = p if y is None else y + p
    y = y + b.to(dt)
    return y if tp is None else gather_from_model(y, tp)


def _relu_layer(pairs, b, dt, tp: ModelAxis | None = None):
    """relu(_layer(pairs, b, dt, tp)): on the card in bf16 without `tp`, one
    fused op (ops/fused_linear.py: the bias and the ReLU in the product's
    epilogue; the ReLU's mask and the bias gradient in one backward pass);
    elsewhere `_layer`, then ReLU."""
    if tp is None and dt == torch.bfloat16 and pairs[0][0].is_cuda:
        return linear_relu(pairs, b)
    return F.relu(_layer(pairs, b, dt, tp))


def _trunk_apply(t: Params, feat_in, b0, bskip, dtype, tp: ModelAxis | None = None):
    """Run a skip trunk on per-point features with folded code biases."""
    h = _relu_layer([(feat_in, t["w_feat0"])], b0, dtype, tp)
    for layer in t["mid"]:
        h = _relu_layer([(h, layer["w"])], layer["b"], dtype, tp)
    h = _relu_layer([(feat_in, t["w_skip_feat"]), (h, t["w_skip_h"])], bskip, dtype, tp)
    for layer in t["post"]:
        h = _relu_layer([(h, layer["w"])], layer["b"], dtype, tp)
    return h


def _xyz_apply(params: Params, cond: Params, pts_embed, dt, tp: ModelAxis | None = None):
    xyz = params["xyz"]
    h = _relu_layer([(pts_embed.to(dt), xyz["w_pts"])], cond["xyz_b"], dt, tp)
    for layer in xyz["layers"]:
        h = _relu_layer([(h, layer["w"])], layer["b"], dt, tp)
    return h


def apply_field_folded(
    params: Params,
    cond: Params,
    pts_embed: torch.Tensor,   # [N, pts_embed_dim]
    dir_feat: torch.Tensor,    # [N, W//2], or [R, W//2] with N = R*S
    cfg: FieldConfig,
    samples_per_ray: int | None = None,
    tp: ModelAxis | None = None,
):
    """Embedded points -> (raw_rgb [N,3], raw_sigma [N,1]) in the compute
    dtype. `dir_feat` is `dirs_embed @ view.w_dirs`; with `samples_per_ray`
    it is per ray and broadcast over each ray's samples at the view layer.

    With the model axis `tp`, the layers that shard_params_rules splits
    (xyz encoder, trunks, the view layer; `dir_feat` then holds the rank's
    columns of the view layer) run column-parallel, each output gathered;
    the heads alpha and view.rgb run whole on the gathered features."""
    dt = cfg.compute_dtype
    trunk_tp = column_axis(params["sigma"]["w_feat0"], cfg.width, tp)
    xyz_code = _xyz_apply(params, cond, pts_embed, dt, trunk_tp)

    s = params["sigma"]
    sigma_feat = _trunk_apply(s, xyz_code, cond["sigma_b0"], cond["sigma_bskip"], dt, trunk_tp)
    raw_sigma = sigma_feat @ s["alpha"]["w"].to(dt) + s["alpha"]["b"].to(dt)

    rgb_feat = _trunk_apply(params["rgb"], sigma_feat, cond["rgb_b0"], cond["rgb_bskip"], dt,
                            trunk_tp)

    v = params["view"]
    view_tp = column_axis(v["w_feat"], cfg.width // 2, tp)
    x = rgb_feat if view_tp is None else copy_to_model(rgb_feat, view_tp)
    pre_view = x @ v["w_feat"].to(dt) + v["b"].to(dt)
    if samples_per_ray is not None:
        n_rays = dir_feat.shape[0]
        w2 = pre_view.shape[-1]
        pre_view = pre_view.reshape(n_rays, samples_per_ray, w2)
        view_feat = F.relu(pre_view + dir_feat.to(dt)[:, None, :]).reshape(-1, w2)
    else:
        view_feat = F.relu(pre_view + dir_feat.to(dt))
    if view_tp is not None:
        view_feat = gather_from_model(view_feat, view_tp)
    raw_rgb = view_feat @ v["rgb"]["w"].to(dt) + v["rgb"]["b"].to(dt)
    return raw_rgb, raw_sigma


def apply_field_sigma(
    params: Params,
    cond: Params,
    pts_embed: torch.Tensor,  # [N, pts_embed_dim]
    cfg: FieldConfig,
) -> torch.Tensor:
    """Density only: xyz encoder, sigma trunk and alpha head, without the rgb
    trunk and view head (about half the operations). For occupancy probing."""
    dt = cfg.compute_dtype
    h = _xyz_apply(params, cond, pts_embed, dt)
    s = params["sigma"]
    sigma_feat = _trunk_apply(s, h, cond["sigma_b0"], cond["sigma_bskip"], dt)
    return sigma_feat @ s["alpha"]["w"].to(dt) + s["alpha"]["b"].to(dt)


def apply_field(
    params: Params,
    pts: torch.Tensor,         # [N, 3]
    viewdirs: torch.Tensor,    # [N, 3] unit vectors
    shape_code: torch.Tensor,  # [shape_dim]
    exp_code: torch.Tensor,    # [exp_dim] (ISM-modulated)
    tex_code: torch.Tensor,    # [tex_dim]
    cfg: FieldConfig,
):
    """Unfolded apply from raw points and codes (the parity and testing path)."""
    pe = fourier_embed(pts, cfg.multires)
    de = fourier_embed(viewdirs, cfg.multires_views)
    cond = fold_conditioning(params, shape_code, exp_code, tex_code)
    dir_feat = de @ params["view"]["w_dirs"]
    return apply_field_folded(params, cond, pe, dir_feat, cfg)
