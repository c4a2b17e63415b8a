"""The teacher as the program takes it: its spec from a configuration file
and its trainable tree made on the device from the seed."""
from __future__ import annotations

import torch

from benchmark.common import HEAD_WEIGHTS, device_generator, he_rule, init_uniform
from mofanerf_tpu_torch.config import Config
from mofanerf_tpu_torch.models.field import field_param_shapes
from mofanerf_tpu_torch.models.tex_encoder import TextureEncoder
from mofanerf_tpu_torch.render.renderer import N_EXP_SLOTS

CONFIG_KEYS = ("netdepth", "netwidth", "netdepth_fine", "netwidth_fine", "multires",
               "multires_views", "N_samples", "N_importance", "N_rand", "precrop_iters",
               "precrop_frac", "use_viewdirs", "white_bkgd", "lrate", "lrate_decay",
               "input_ch_shapeCodes", "input_ch_textureCodes", "input_ch_expCodes", "uv_size",
               "compute_dtype", "packet_size", "near", "far", "perturb", "raw_noise_std",
               "sigma_activation", "lm_frac", "lm_frac_anneal_iters")


def program_config(cfg: dict, **flags) -> Config:
    """The program's Config of a configuration file, with run flags on top."""
    return Config(**{**{k: cfg[k] for k in CONFIG_KEYS if k in cfg}, **flags})


def tree_shapes(spec) -> dict:
    """The trainable tree's shapes in the program's layout."""
    width, depth = 256, 4
    ism, d_in = [], spec.shape_dim
    for _ in range(depth):
        ism.append({"w": (d_in, width), "b": (width,)})
        d_in = width
    enc = TextureEncoder(spec.tex_dim, spec.uv_size, device="meta").state_dict()
    return {
        "coarse": field_param_shapes(spec.coarse),
        "fine": field_param_shapes(spec.fine),
        "ism": {"layers": ism,
                "scale": {"w": (width, spec.exp_dim), "b": (spec.exp_dim,)},
                "bias": {"w": (width, spec.exp_dim), "b": (spec.exp_dim,)}},
        "tex_encoder": {k: tuple(v.shape) for k, v in enc.items()},
        "exp_codes": (N_EXP_SLOTS, spec.exp_dim),
    }


def make_params(spec, seed: int, device) -> dict:
    """Every trainable tensor of the teacher, in f32 on `device`, from `seed`."""
    return init_uniform(tree_shapes(spec), he_rule, device_generator(seed, 1, device=device),
                        device, HEAD_WEIGHTS)


def tree_items(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_items(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_items(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
