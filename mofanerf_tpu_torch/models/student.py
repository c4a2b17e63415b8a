"""Lean point field served by the distilled-student path (counterpart of
mofanerf_tpu/models/student.py).

embed -> depth x (W dense, one optional skip) -> sigma head + view-conditioned
rgb head. Params are a plain dict of f32 tensors laid out as the JAX
package's param tree, weights [in, out], so `x @ W` and the bridge map one to
one. A code-conditioned student (cond_dim > 0) folds its code into biases
(`fold_student_code`), after which it serves exactly like an unconditioned one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.models.field import (FieldConfig, apply_field_folded, fold_conditioning,
                                             init_field_params)
from mofanerf_tpu_torch.ops.embed import embed_dim
from mofanerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StudentConfig:
    depth: int = 4               # dense trunk layers after the input layer
    width: int = 128
    skip: int = -1               # trunk index to re-inject pe (-1 = none)
    multires: int = 8
    multires_views: int = 4
    cond_dim: int = 0            # >0: a code of this size adds a bias to the
                                 # input layer and every trunk layer
    compute_dtype: Any = torch.bfloat16

    @property
    def pts_embed_dim(self) -> int:
        return embed_dim(3, self.multires)

    @property
    def views_embed_dim(self) -> int:
        return embed_dim(3, self.multires_views)


def student_param_shapes(cfg: StudentConfig) -> Params:
    """The param tree of `cfg` with shapes as leaves, as init_student_params
    lays it out; the bridge and the artifact loader check leaves against it."""
    W, pe, ve, cd = cfg.width, cfg.pts_embed_dim, cfg.views_embed_dim, cfg.cond_dim
    tree = {
        "input": {"w": (pe, W), "b": (W,)},
        "layers": [{"w": (W + (pe if i == cfg.skip else 0), W), "b": (W,)}
                   for i in range(cfg.depth)],
        "sigma": {"w": (W, 1), "b": (1,)},
        "feat": {"w": (W, W // 2), "b": (W // 2,)},
        "view": {"w_dirs": (ve, W // 2)},
        "rgb": {"w": (W // 2, 3), "b": (3,)},
    }
    if cd:
        tree["cond"] = {"w_in": (cd, W), "w_layers": (cfg.depth, cd, W)}
    return tree


def init_student_params(generator: torch.Generator, cfg: StudentConfig,
                        device="cuda") -> Params:
    """Xavier-uniform (ReLU gain) weights over each layer's full concat
    fan-in and torch-Linear bias bounds, as the JAX init; the draws come from
    a CPU `torch.Generator`, so the values differ from JAX's."""
    dev = resolve_device(device)
    W = cfg.width
    pe, ve, cd = cfg.pts_embed_dim, cfg.views_embed_dim, cfg.cond_dim
    gain = np.sqrt(2.0)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).to(dev)

    def xavier(total_in, out, block_in):
        return uniform((block_in, out), gain * np.sqrt(6.0 / (total_in + out)))

    def dense(total_in, out, block_in=None):
        return {"w": xavier(total_in, out, block_in or total_in),
                "b": uniform((out,), 1.0 / np.sqrt(total_in))}

    layers = [dense(W + (pe if i == cfg.skip else 0), W) for i in range(cfg.depth)]
    params = {
        # conditioned: the input layer's true fan-in is concat([pe, code])
        "input": dense(pe + cd, W, block_in=pe) if cd else dense(pe, W),
        "layers": layers,
        "sigma": dense(W, 1),
        "feat": dense(W, W // 2),
        "view": {"w_dirs": xavier(ve + W, W // 2, ve)},
        "rgb": dense(W // 2, 3),
    }
    if cd:
        params["cond"] = {
            "w_in": xavier(pe + cd, W, cd),
            # trunk injections start at zero, as in the JAX init
            "w_layers": torch.zeros((cfg.depth, cd, W), dtype=torch.float32, device=dev),
        }
    return params


def fold_student_code(params: Params, code: torch.Tensor) -> Params:
    """Fold a conditioning code [cond_dim] into plain student params:
    `b0' = b0 + code @ w_in`, `bl_i' = bl_i + code @ w_layers[i]`. The result
    has the layout of an unconditioned student."""
    if "cond" not in params:
        return params
    c = params["cond"]
    folded = {k: v for k, v in params.items() if k != "cond"}
    folded["input"] = {
        "w": params["input"]["w"],
        "b": params["input"]["b"] + code @ c["w_in"],
    }
    folded["layers"] = [
        {"w": l["w"], "b": l["b"] + code @ c["w_layers"][i]}
        for i, l in enumerate(params["layers"])
    ]
    return folded


def student_param_count(params: Params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(count(v) for v in t)
        return int(t.numel())
    return count(params)


def apply_student(
    params: Params,
    pts_embed: torch.Tensor,   # [N, pe]
    dir_feat: torch.Tensor,    # [N or R, W//2] (= dirs_embed @ view.w_dirs)
    cfg: StudentConfig,
    samples_per_ray: int | None = None,
):
    """(pe, dirf) -> (raw_rgb [N,3], raw_sigma [N,1]) in the compute dtype,
    with the per-ray dir_feat broadcast over samples when
    `samples_per_ray` is given."""
    dt = cfg.compute_dtype
    x = pts_embed.to(dt)
    h = F.relu(x @ params["input"]["w"].to(dt) + params["input"]["b"].to(dt))
    for i, layer in enumerate(params["layers"]):
        if i == cfg.skip:
            h = torch.cat([h, x], dim=-1)
        h = F.relu(h @ layer["w"].to(dt) + layer["b"].to(dt))
    raw_sigma = h @ params["sigma"]["w"].to(dt) + params["sigma"]["b"].to(dt)

    pre = h @ params["feat"]["w"].to(dt) + params["feat"]["b"].to(dt)
    if samples_per_ray is not None:
        n_rays = dir_feat.shape[0]
        w2 = pre.shape[-1]
        pre = pre.reshape(n_rays, samples_per_ray, w2)
        vf = F.relu(pre + dir_feat.to(dt)[:, None, :]).reshape(-1, w2)
    else:
        vf = F.relu(pre + dir_feat.to(dt))
    raw_rgb = vf @ params["rgb"]["w"].to(dt) + params["rgb"]["b"].to(dt)
    return raw_rgb, raw_sigma


def point_apply(params, cond, pts_embed, dir_feat, cfg, samples_per_ray=None):
    """(pe, dirf) -> (raw_rgb, raw_sigma) for either field family. For
    StudentConfig, `cond` is the conditioning code [cond_dim] (folded into
    biases here) or None; for FieldConfig it is the folded conditioning."""
    if isinstance(cfg, StudentConfig):
        if cond is not None:
            params = fold_student_code(params, cond)
        return apply_student(params, pts_embed, dir_feat, cfg, samples_per_ray)
    return apply_field_folded(params, cond, pts_embed, dir_feat, cfg, samples_per_ray)


def _zero_code_cond(params: Params, cfg: FieldConfig) -> Params:
    dev = params["xyz"]["b"].device
    zeros = [torch.zeros(n, dtype=torch.float32, device=dev)
             for n in (cfg.shape_dim, cfg.exp_dim, cfg.tex_dim)]
    return fold_conditioning(params, *zeros)


def init_point_field(generator: torch.Generator, cfg, device="cuda"):
    """Init either family. Returns (params, cond): cond None for students, the
    folded zero-code conditioning for a FieldConfig (the field-arch student)."""
    if isinstance(cfg, StudentConfig):
        return init_student_params(generator, cfg, device=device), None
    params = init_field_params(generator, cfg, device=device)
    return params, _zero_code_cond(params, cfg)


def refold_cond(params: Params, cfg):
    """The zero-code conditioning of a FieldConfig's params, recomputed after
    an update (the folded biases are functions of the params); None for
    students."""
    if isinstance(cfg, StudentConfig):
        return None
    return _zero_code_cond(params, cfg)
