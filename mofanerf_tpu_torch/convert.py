"""Reference-checkpoint converter: the reference's PyTorch `.tar` -> the
port's model params (counterpart of mofanerf_tpu/convert.py).

Reads the reference training checkpoint layout (run_train.py:370-379):
  network_fn_state_dict / network_fine_state_dict   (NeRF modules)
  network_render_textureEncoder                     (EnDeUVmap)
  network_render_idSpecific                         (StyleModule)
  expression_latent_codes_sigma                     (list of [1, 30] tensors)
and gives the tree `init_model_params` gives (`coarse`, `fine`, `ism`,
`tex_encoder`, `exp_codes`), the layout `bridge.model_params_to_torch` makes
of the JAX converter's output, on the device asked for.

Layout facts this mapping depends on (those of the JAX converter):
- a torch Linear weight is [out, in]; the field's and the ISM's are [in, out];
- xyzEncode's input is cat([pts_embed 63, exp' 30]), the sigma trunk's
  cat([shape 50, xyz_code W]), the rgb trunk's cat([tex 256, sigma_feat W]),
  a skip layer's cat([x, h]) with x the trunk's whole input, and the view
  layer's cat([dirs 27, rgb_feat W]): each concat-input matrix is split into
  its per-input blocks;
- DataParallel's `module.` prefixes are dropped.
The texture encoder keeps torch's layout (OIHW convolutions, [out, in]
linears), but the port flattens its last feature map channels-last (NHWC)
where the reference flattens NCHW, so the first linear's input columns are
permuted. Optimizer state is not converted: Adam moments do not carry over.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from mofanerf_tpu_torch.models.field import FieldConfig
from mofanerf_tpu_torch.render.renderer import N_EXP_SLOTS
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.tree import map_tree

Params = Dict[str, Any]

REFERENCE_KEYS = ("network_fn_state_dict", "network_fine_state_dict",
                  "network_render_textureEncoder", "network_render_idSpecific",
                  "expression_latent_codes_sigma")


def _strip_module(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Drop DataParallel 'module.' prefixes; f32 CPU tensors."""
    return {k[len("module."):] if k.startswith("module.") else k:
            torch.as_tensor(v).detach().to("cpu", torch.float32) for k, v in sd.items()}


def _dense(w, dev) -> torch.Tensor:
    """A torch [out, in] block -> [in, out], contiguous, on `dev`."""
    return w.t().contiguous().to(dev)


def _linear(sd, prefix):
    return sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]


def convert_field(sd: Dict[str, Any], cfg: FieldConfig, device="cuda") -> Params:
    """A NeRF state dict -> the port's field params."""
    dev = resolve_device(device)
    sd = _strip_module(sd)
    W, D, skip = cfg.width, cfg.depth, cfg.skip
    pe, ve = cfg.pts_embed_dim, cfg.views_embed_dim

    def layer(prefix):
        w, b = _linear(sd, prefix)
        return {"w": _dense(w, dev), "b": b.to(dev)}

    w0, b0 = _linear(sd, "xyzEncode.linears1.Linear0")
    xyz = {"w_pts": _dense(w0[:, :pe], dev), "w_exp": _dense(w0[:, pe:], dev), "b": b0.to(dev),
           "layers": [layer(f"xyzEncode.linears1.Linear{i + 1}") for i in range(cfg.xyz_depth)]}

    def trunk(name: str, code_dim: int) -> Params:
        w0, b0 = _linear(sd, f"{name}.linears1.Linear0")
        ws, bs = _linear(sd, f"{name}.linears2.Linear0")
        return {
            "w_code0": _dense(w0[:, :code_dim], dev), "w_feat0": _dense(w0[:, code_dim:], dev),
            "b0": b0.to(dev),
            "mid": [layer(f"{name}.linears1.Linear{i + 1}") for i in range(skip)],
            # the skip layer's input is cat([x, h]) = [code, feat, h]
            "w_skip_code": _dense(ws[:, :code_dim], dev),
            "w_skip_feat": _dense(ws[:, code_dim:code_dim + W], dev),
            "w_skip_h": _dense(ws[:, code_dim + W:], dev), "b_skip": bs.to(dev),
            "post": [layer(f"{name}.linears2.Linear{i + 1}") for i in range(D - skip - 2)],
        }

    sigma = trunk("linear_BiM_xyz", cfg.shape_dim)
    sigma["alpha"] = layer("alpha_linear.0")
    wv, bv = _linear(sd, "linear_view_xyBMuv.0")
    view = {"w_dirs": _dense(wv[:, :ve], dev), "w_feat": _dense(wv[:, ve:], dev),
            "b": bv.to(dev), "rgb": layer("rgb_linear")}
    return {"xyz": xyz, "sigma": sigma, "rgb": trunk("linear_uv_xyzBiM", cfg.tex_dim),
            "view": view}


def convert_ism(sd: Dict[str, Any], depth: int = 4, device="cuda") -> Params:
    """A StyleModule state dict -> the port's ISM params."""
    dev = resolve_device(device)
    sd = _strip_module(sd)

    def layer(prefix):
        w, b = _linear(sd, prefix)
        return {"w": _dense(w, dev), "b": b.to(dev)}

    return {"layers": [layer(f"linears1.Linear{i}") for i in range(depth)],
            "scale": layer("linears_scale"), "bias": layer("linears_bias")}


def convert_tex_encoder(sd: Dict[str, Any], device="cuda") -> Params:
    """An EnDeUVmap state dict -> the state dict of the port's TextureEncoder.

    The reference's convolutions are encoder.down1.0.{0,2,...,12} of an
    nn.Sequential that interleaves LeakyReLUs, its linears encoder.down2.0,
    encoder.mu and encoder.decoding.{0,2,4}. encoder.down2.0 sees the NCHW
    flatten of the last [C, S, S] feature map, the port's fc its NHWC flatten."""
    dev = resolve_device(device)
    sd = _strip_module(sd)
    out: Dict[str, torch.Tensor] = {}
    for n, ci in enumerate(range(0, 14, 2)):
        out[f"convs.{n}.weight"] = sd[f"encoder.down1.0.{ci}.weight"]
        out[f"convs.{n}.bias"] = sd[f"encoder.down1.0.{ci}.bias"]
    w, b = _linear(sd, "encoder.down2.0")
    c = sd["encoder.down1.0.12.weight"].shape[0]
    side = int(round((w.shape[1] // c) ** 0.5))
    if c * side * side != w.shape[1]:
        raise ValueError(f"encoder.down2.0 takes {w.shape[1]} inputs, not a {c}-channel square map")
    # NHWC column (h, w, c) reads the NCHW column c*S*S + h*S + w
    perm = torch.arange(c * side * side).reshape(c, side, side).permute(1, 2, 0).reshape(-1)
    out["fc.weight"], out["fc.bias"] = w[:, perm], b
    out["mu.weight"], out["mu.bias"] = _linear(sd, "encoder.mu")
    for i, di in enumerate((0, 2, 4)):
        out[f"decoding.{i}.weight"], out[f"decoding.{i}.bias"] = _linear(sd, f"encoder.decoding.{di}")
    return {k: v.contiguous().to(dev) for k, v in out.items()}


def convert_exp_codes(latents: List[Any], n_slots: int = N_EXP_SLOTS, exp_dim: int = 30,
                      device="cuda") -> torch.Tensor:
    """A list of [1, exp_dim] tensors (20 trained, and a fitting slot when
    present) -> the [n_slots, exp_dim] bank, zeros where the list ends."""
    bank = torch.zeros((n_slots, exp_dim), dtype=torch.float32)
    for i, t in enumerate(latents[:n_slots]):
        bank[i] = torch.as_tensor(t).detach().to("cpu", torch.float32).reshape(exp_dim)
    return bank.to(resolve_device(device))


def load_reference(tar_path: str) -> Dict[str, Any]:
    """The reference `.tar` as torch.load gives it, on the CPU."""
    ckpt = torch.load(tar_path, map_location="cpu", weights_only=False)
    missing = [k for k in REFERENCE_KEYS if k not in ckpt]
    if missing:
        raise ValueError(f"{tar_path} is not a reference checkpoint: no {missing}")
    return ckpt


def convert_checkpoint(tar_path: str, spec, device="cuda", ckpt=None) -> Params:
    """A reference `.tar` -> the port's model params for `spec` (a MoFaNeRF),
    on `device`, checked leaf by leaf against the spec's shapes. `ckpt` is the
    already loaded file, when the caller has it."""
    from mofanerf_tpu_torch.bridge import _check_shapes
    from mofanerf_tpu_torch.render.renderer import init_model_params

    ckpt = load_reference(tar_path) if ckpt is None else ckpt
    params = {
        "coarse": convert_field(ckpt["network_fn_state_dict"], spec.coarse, device),
        "fine": convert_field(ckpt["network_fine_state_dict"], spec.fine, device),
        "ism": convert_ism(ckpt["network_render_idSpecific"], device=device),
        "tex_encoder": convert_tex_encoder(ckpt["network_render_textureEncoder"], device),
        "exp_codes": convert_exp_codes(ckpt["expression_latent_codes_sigma"],
                                       exp_dim=spec.exp_dim, device=device),
    }
    like = init_model_params(torch.Generator(), spec, device="meta")
    _check_shapes(params, map_tree(lambda t: tuple(t.shape), like))
    return params
