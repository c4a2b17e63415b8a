"""Fused conditioned-field apply: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of mofanerf_tpu/ops/pallas_field.py).

`fused_field_apply` evaluates the whole point pipeline of the conditioned
field -- xyz encoder, sigma trunk with its skip pair, alpha head, rgb trunk,
view layer with the per-ray direction features, rgb head -- for a packet of
embedded points. On CUDA tensors it launches the hand-written kernel in
`csrc/field_kernel.cu` (built at first use); on CPU tensors it runs
`fused_field_apply_ref`, the same math in plain PyTorch with the same
rounding points. Any other device raises. Inference only: it builds no
autograd graph (training differentiates models/field.py::apply_field_folded).

Precision contract (the TPU kernel's): every product casts both operands to
the compute dtype and accumulates in f32; bias adds and ReLU are f32; each
layer's output is rounded to the compute dtype; the skip pair's first half
is not rounded before the sum; `pre + dir_feat` is f32, then ReLU, then the
compute dtype; the output head is f32. At compute_dtype float32 this is
`apply_field_folded` exactly.

Layer plan of `w_stack` (skip=4, xyz_depth=3):
  [0..2]            xyz hidden layers
  [3]               sigma trunk L0 (bias = folded shape code)
  [4..7]            sigma mid
  [8], [9]          sigma skip pair: xyz_code @ W8 + h @ W9 (+ folded bias)
  [10..10+D-7]      sigma post
  ...               the same again for the rgb trunk (folded texture code)
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.models.field import FieldConfig

Params = Dict[str, Any]

# kernel launches made by `fused_field_apply` in this process
launch_count = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WIDTH = 1024
_K_ALIGN = 16        # the embedding's fan-in is zero-padded to the mma depth
_REF_CHUNK = 65536   # rows the plain version upcasts to f32 at a time


class FusedParams(NamedTuple):
    """Stacked parameters of one field for one frame's conditioning."""

    w_stack: torch.Tensor   # [L, W, W] compute dtype: the hidden layers, in plan order
    b_stack: torch.Tensor   # [L, W] f32 biases (conditioning folded in)
    w_pts: torch.Tensor     # [pe padded to 16, W] compute dtype (padding rows zero)
    b_pts: torch.Tensor     # [W] f32 (the folded expression bias)
    w_view: torch.Tensor    # [W, W/2] compute dtype
    b_view: torch.Tensor    # [W/2] f32
    w_out: torch.Tensor     # [W + W/2, 4] compute dtype: alpha (rows :W -> col 3)
                            # and rgb (rows W: -> cols 0..2), the fused output head
    b_out: torch.Tensor     # [4] f32


def _plan_len(cfg: FieldConfig) -> int:
    # xyz hidden + 2 trunks of (L0 + skip mid + skip pair (2) + post)
    per_trunk = 1 + cfg.skip + 2 + (cfg.depth - cfg.skip - 2)
    return cfg.xyz_depth + 2 * per_trunk


def _padded_pe(cfg: FieldConfig) -> int:
    return -(-cfg.pts_embed_dim // _K_ALIGN) * _K_ALIGN


def pack_fused_params(params: Params, cond: Params, cfg: FieldConfig) -> FusedParams:
    """Field params + folded conditioning -> the kernel's operand set. This
    casts the whole weight stack; do it once a frame, not once a packet."""
    W, W2, pe = cfg.width, cfg.width // 2, cfg.pts_embed_dim
    dt, f32 = cfg.compute_dtype, torch.float32
    x, s, v = params["xyz"], params["sigma"], params["view"]
    dev = x["w_pts"].device
    ws, bs = [], []

    def push(w, b):
        ws.append(w.to(dt))
        bs.append(b.to(f32))

    for layer in x["layers"]:
        push(layer["w"], layer["b"])

    def push_trunk(t, b0_folded, bskip_folded):
        push(t["w_feat0"], b0_folded)
        for layer in t["mid"]:
            push(layer["w"], layer["b"])
        # the pair's bias is carried by its second half
        push(t["w_skip_feat"], torch.zeros(W, dtype=f32, device=dev))
        push(t["w_skip_h"], bskip_folded)
        for layer in t["post"]:
            push(layer["w"], layer["b"])

    push_trunk(s, cond["sigma_b0"], cond["sigma_bskip"])
    push_trunk(params["rgb"], cond["rgb_b0"], cond["rgb_bskip"])
    if len(ws) != _plan_len(cfg):
        raise ValueError(f"param tree has {len(ws)} hidden layers, the config's plan "
                         f"{_plan_len(cfg)}")

    w_pts = torch.zeros((_padded_pe(cfg), W), dtype=dt, device=dev)
    w_pts[:pe] = x["w_pts"].to(dt)
    # out[:, 0:3] = rgb from the view features, out[:, 3] = sigma from sigma_feat
    w_out = torch.zeros((W + W2, 4), dtype=dt, device=dev)
    w_out[:W, 3:4] = s["alpha"]["w"].to(dt)
    w_out[W:, 0:3] = v["rgb"]["w"].to(dt)
    b_out = torch.cat([v["rgb"]["b"], s["alpha"]["b"]]).to(f32)
    return FusedParams(
        torch.stack(ws).contiguous(), torch.stack(bs).contiguous(), w_pts,
        cond["xyz_b"].to(f32).contiguous(), v["w_feat"].to(dt).contiguous(),
        v["b"].to(f32).contiguous(), w_out, b_out.contiguous())


def _ref_rows(fused: FusedParams, x, dirf_rows, cfg: FieldConfig):
    """The kernel's math on a block of rows: x [n, pe] f32, dirf_rows
    [n, W/2] f32 -> [n, 4] f32."""
    dt, f32 = cfg.compute_dtype, torch.float32
    W, pe = cfg.width, cfg.pts_embed_dim

    def mm(a, w):
        # operands rounded to the compute dtype, products summed in f32
        return a.to(dt).to(f32) @ w.to(f32)

    def dense(h, l):
        return F.relu(mm(h, fused.w_stack[l]) + fused.b_stack[l]).to(dt)

    h = F.relu(mm(x, fused.w_pts[:pe]) + fused.b_pts).to(dt)
    li = 0
    for _ in range(cfg.xyz_depth):
        h = dense(h, li)
        li += 1

    def trunk(saved, li):
        h = dense(saved, li)
        li += 1
        for _ in range(cfg.skip):
            h = dense(h, li)
            li += 1
        part = mm(saved, fused.w_stack[li])          # no bias, no rounding
        h = F.relu(part + mm(h, fused.w_stack[li + 1]) + fused.b_stack[li + 1]).to(dt)
        li += 2
        for _ in range(cfg.depth - cfg.skip - 2):
            h = dense(h, li)
            li += 1
        return h, li

    sigma_feat, li = trunk(h, li)
    rgb_feat, li = trunk(sigma_feat, li)
    pre = mm(rgb_feat, fused.w_view) + fused.b_view
    view = F.relu(pre + dirf_rows).to(dt)
    return mm(sigma_feat, fused.w_out[:W]) + mm(view, fused.w_out[W:]) + fused.b_out


def fused_field_apply_ref(fused: FusedParams, pts_embed: torch.Tensor,
                          dir_feat: torch.Tensor, cfg: FieldConfig,
                          samples_per_ray: int):
    """Plain PyTorch version of the fused kernel, on any device: (raw_rgb
    [N, 3], raw_sigma [N, 1]) in f32. Rows go through in chunks, so the f32
    upcast of a [rows, W] activation stays small at packet sizes."""
    N = pts_embed.shape[0]
    dirf = dir_feat.to(torch.float32)
    outs = []
    for r0 in range(0, N, _REF_CHUNK):
        r1 = min(r0 + _REF_CHUNK, N)
        ray = torch.arange(r0, r1, device=pts_embed.device) // samples_per_ray
        outs.append(_ref_rows(fused, pts_embed[r0:r1].to(torch.float32), dirf[ray], cfg))
    out = torch.cat(outs) if outs else pts_embed.new_zeros((0, 4), dtype=torch.float32)
    return out[:, 0:3], out[:, 3:4]


def _check_config(cfg: FieldConfig) -> None:
    if not isinstance(cfg, FieldConfig):
        raise ValueError("the fused field kernel takes a FieldConfig")
    if cfg.compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"compute dtype {cfg.compute_dtype} is not float32 or bfloat16")
    if cfg.width % 64 or not 64 <= cfg.width <= _MAX_WIDTH:
        raise ValueError(f"the kernel takes widths that are multiples of 64 up to "
                         f"{_MAX_WIDTH}, got {cfg.width}")
    if cfg.skip < 0 or cfg.depth < cfg.skip + 2 or cfg.xyz_depth < 0:
        raise ValueError(f"the kernel needs depth >= skip + 2, skip >= 0 and "
                         f"xyz_depth >= 0; got depth={cfg.depth}, skip={cfg.skip}, "
                         f"xyz_depth={cfg.xyz_depth}")
    if _padded_pe(cfg) > cfg.width:
        raise ValueError(f"the embedding ({cfg.pts_embed_dim} dims) is wider than the "
                         f"field ({cfg.width})")


def _operand_shapes(cfg: FieldConfig, n_rows: int, n_rays: int) -> Dict[str, tuple]:
    W, W2, L = cfg.width, cfg.width // 2, _plan_len(cfg)
    return {"pts_embed": (n_rows, cfg.pts_embed_dim), "dir_feat": (n_rays, W2),
            "w_stack": (L, W, W), "b_stack": (L, W), "w_pts": (_padded_pe(cfg), W),
            "b_pts": (W,), "w_view": (W, W2), "b_view": (W2,),
            "w_out": (W + W2, 4), "b_out": (4,)}


_COMPUTE_DTYPE_OPERANDS = ("w_stack", "w_pts", "w_view", "w_out")


def _check_operands(fused: FusedParams, pts_embed, dir_feat, cfg: FieldConfig,
                    samples_per_ray: int) -> None:
    """Device, dtype, shape and contiguity of everything the kernel reads."""
    if samples_per_ray < 1:
        raise ValueError(f"samples_per_ray must be >= 1, got {samples_per_ray}")
    n_rows, n_rays = pts_embed.shape[0], dir_feat.shape[0]
    if n_rows != n_rays * samples_per_ray:
        raise ValueError(f"{n_rows} points are not {n_rays} rays x {samples_per_ray} samples")
    dev = pts_embed.device
    tensors = dict(fused._asdict(), pts_embed=pts_embed, dir_feat=dir_feat)
    for name, shape in _operand_shapes(cfg, n_rows, n_rays).items():
        t = tensors[name]
        want = cfg.compute_dtype if name in _COMPUTE_DTYPE_OPERANDS else torch.float32
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the points on {dev}")
        if t.dtype != want:
            raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _lib():
    from mofanerf_tpu_torch.utils.cuda_build import load

    lib = load("field_kernel")
    lib.field_apply.restype = ctypes.c_int
    lib.field_apply.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                                + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.field_block_rows.restype = ctypes.c_int
    lib.field_block_rows.argtypes = [ctypes.c_int] * 3
    return lib


def block_rows(cfg: FieldConfig) -> int:
    """Point rows one CTA of the CUDA kernel holds for `cfg` (each CTA streams
    the whole weight stack once, so this sets the kernel's weight traffic)."""
    _check_config(cfg)
    rows = _lib().field_block_rows(_DTYPE_CODE[cfg.compute_dtype], cfg.width,
                                   cfg.pts_embed_dim)
    if rows <= 0:
        raise ValueError(f"the kernel does not take width {cfg.width}")
    return rows


def _field_cuda(fused: FusedParams, pts_embed, dir_feat, cfg: FieldConfig,
                samples_per_ray: int) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands: [N, 4] f32 (rgb, sigma)."""
    global launch_count
    dev = pts_embed.device
    n_rows = pts_embed.shape[0]
    out = torch.empty((n_rows, 4), dtype=torch.float32, device=dev)
    fn = _lib().field_apply
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_DTYPE_CODE[cfg.compute_dtype], pts_embed.data_ptr(), dir_feat.data_ptr(),
                 fused.w_pts.data_ptr(), fused.b_pts.data_ptr(), fused.w_stack.data_ptr(),
                 fused.b_stack.data_ptr(), fused.w_view.data_ptr(), fused.b_view.data_ptr(),
                 fused.w_out.data_ptr(), fused.b_out.data_ptr(), out.data_ptr(),
                 n_rows, samples_per_ray, cfg.pts_embed_dim, cfg.width, cfg.depth,
                 cfg.skip, cfg.xyz_depth, stream)
    if err != 0:
        raise RuntimeError(f"field_apply kernel launch failed: cudaError {err}")
    if n_rows:
        launch_count += 1
    return out


def fused_field_apply(fused: FusedParams, pts_embed: torch.Tensor, dir_feat: torch.Tensor,
                      cfg: FieldConfig, samples_per_ray: int):
    """(raw_rgb [N, 3], raw_sigma [N, 1]) in f32 for N = R * samples_per_ray
    embedded points `pts_embed` [N, pe] (f32) and per-ray view features
    `dir_feat` [R, W/2] (f32): the contract of apply_field_folded.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (and raise if it cannot run); other devices raise."""
    _check_config(cfg)
    dev = pts_embed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_field_apply runs on cuda or cpu, not {dev}")
    _check_operands(fused, pts_embed, dir_feat, cfg, samples_per_ray)
    if dev.type == "cpu":
        return fused_field_apply_ref(fused, pts_embed, dir_feat, cfg, samples_per_ray)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*fused, pts_embed, dir_feat)):
        raise ValueError("an operand requires grad: the fused kernel is inference only; "
                         "call it under torch.no_grad(), or differentiate "
                         "models/field.py::apply_field_folded")
    out = _field_cuda(fused, pts_embed, dir_feat, cfg, samples_per_ray)
    return out[:, 0:3], out[:, 3:4]
