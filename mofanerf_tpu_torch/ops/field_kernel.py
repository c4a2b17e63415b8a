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

Any field that apply_field_folded takes runs: the wrapper maps a FieldConfig to
the kernel's (`kernel_config`: the depth lifted to skip + 2, since a trunk
with no post layers has that plan; the width raised to a multiple of 64 that
holds the padded embedding) and pads every weight, bias and the view features
with zeros, which add exactly 0 and stay 0 through ReLU: the outputs are
unchanged bit for bit.

Three designs of the kernel (csrc/field_kernel.cu picks one by dtype and
width, by the rules `uses_tf32` and `uses_wgmma` state here):
- f32, every width: the 3xTF32 design (`field_kernel_tf32.cuh`), one launch a
  layer over row chunks of a device-memory scratch (`tf32_scratch`). Its
  weights are a stream of tiles `[2, BN, 32]` f32: the high and the low TF32
  part of a `[32 k, BN output columns]` slice, transposed (K-major) and in the
  128-byte swizzle (`tile_weights_tf32`, made once a `pack_fused_params`;
  `tf32_plan` says which products, `untile_weights_tf32` is the inverse).
- bf16 at widths 256 and 1024: the wgmma design. It reads its weights as a
  stream of tiles, each the exact shared-memory image of one stage of its
  ring: `[256 output columns, 64 k]` bf16, K-major, in the 128-byte swizzle
  wgmma reads. `tile_weights` makes that stream once a `pack_fused_params`
  (`stream_plan` says which slice of which matrix each tile holds,
  `untile_weights` is the inverse).
- bf16 at the other widths: the mma.sync design, from the plain operands.
`FusedParams.w_tiles` carries the design's stream beside the plain operands,
whose layout is unchanged.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.models.field import FieldConfig
from mofanerf_tpu_torch.utils.device import aligned

Params = Dict[str, Any]

# kernel launches made by `fused_field_apply` in this process, and the same launches by
# shape: (dtype, depth, width of the kernel's config, rays, samples a ray) -> launches
launch_count = 0
launch_shapes: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WIDTH = 1024
_K_ALIGN = 16        # the embedding's fan-in is zero-padded to the mma depth
_REF_CHUNK = 65536   # rows the plain version upcasts to f32 at a time
TILE_N, TILE_K = 256, 64          # a weight tile of the wgmma design: [256 out, 64 in]
_WGMMA_ROWS = {256: 128, 1024: 64}   # point rows of a CTA of the wgmma design, by width
TF32_K = 32           # k of a weight tile of the 3xTF32 design: one 128-byte row of f32
TF32_ROWS = 128       # point rows of a CTA tile of the 3xTF32 design
_TF32_CHUNK_BYTES = 1 << 28   # bytes of one [chunk rows, W] f32 activation of its scratch


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
    w_tiles: torch.Tensor   # w_pts, w_stack and w_view once more as the design's stream:
                            # [tiles, 256, 64] compute dtype for the wgmma design
                            # (`tile_weights`), [tiles, 2, BN, 32] f32 for the 3xTF32
                            # design (`tile_weights_tf32`), no tiles for the mma.sync one


def _plan_len(cfg: FieldConfig) -> int:
    # xyz hidden + 2 trunks of (L0 + skip mid + skip pair (2) + post); a trunk has
    # range(depth - skip - 2) post layers, none when that is negative
    per_trunk = 1 + cfg.skip + 2 + max(0, cfg.depth - cfg.skip - 2)
    return cfg.xyz_depth + 2 * per_trunk


def _padded_pe(cfg: FieldConfig) -> int:
    return -(-cfg.pts_embed_dim // _K_ALIGN) * _K_ALIGN


def kernel_config(cfg: FieldConfig) -> FieldConfig:
    """The config the kernel runs for the field `cfg`: the depth lifted to
    skip + 2 (a trunk with no post layers has that layer plan) and the width
    raised to the smallest multiple of 64 that holds the padded embedding.
    The field's weights are zero-padded to it (`pack_fused_params`)."""
    width = -(-max(cfg.width, _padded_pe(cfg)) // 64) * 64
    depth = max(cfg.depth, cfg.skip + 2)
    if (width, depth) == (cfg.width, cfg.depth):
        return cfg
    return dataclasses.replace(cfg, width=width, depth=depth)


def _pad(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """`t` cast to `dtype` in the leading corner of zeros of `shape`; `t` itself
    where that changes nothing and it starts on a 16-byte boundary, else a copy."""
    t = t.to(dtype)
    if tuple(t.shape) == tuple(shape):
        return aligned(t)
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def pack_fused_params(params: Params, cond: Params, cfg: FieldConfig) -> FusedParams:
    """Field params + folded conditioning -> the kernel's operand set, padded
    with zeros to `kernel_config(cfg)`. This casts the whole weight stack; do it
    once a frame, not once a packet."""
    kcfg = kernel_config(cfg)
    W, W2, w2 = kcfg.width, kcfg.width // 2, cfg.width // 2
    dt, f32 = cfg.compute_dtype, torch.float32
    x, s, v = params["xyz"], params["sigma"], params["view"]
    dev = x["w_pts"].device
    ws, bs = [], []

    def push(w, b):
        ws.append(_pad(w, (W, W), dt))
        bs.append(_pad(b, (W,), f32))

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
    if len(ws) != _plan_len(kcfg):
        raise ValueError(f"param tree has {len(ws)} hidden layers, the config's plan "
                         f"{_plan_len(kcfg)}")

    w_pts = _pad(x["w_pts"], (_padded_pe(cfg), W), dt)
    # out[:, 0:3] = rgb from the view features, out[:, 3] = sigma from sigma_feat
    w_out = torch.zeros((W + W2, 4), dtype=dt, device=dev)
    w_out[:cfg.width, 3:4] = s["alpha"]["w"].to(dt)
    w_out[W:W + w2, 0:3] = v["rgb"]["w"].to(dt)
    b_out = torch.cat([v["rgb"]["b"], s["alpha"]["b"]]).to(f32)
    w_stack = torch.stack(ws).contiguous()
    w_view = _pad(v["w_feat"], (W, W2), dt).contiguous()
    return FusedParams(
        w_stack, torch.stack(bs).contiguous(), w_pts,
        _pad(cond["xyz_b"], (W,), f32).contiguous(), w_view,
        _pad(v["b"], (W2,), f32).contiguous(), w_out, b_out.contiguous(),
        tile_weights(w_pts, w_stack, w_view, kcfg))


def _cond_rows(cfg: FieldConfig) -> Dict[str, int]:
    """Rows of `b_stack` that carry a folded conditioning bias: each trunk's L0
    and the second half of its skip pair."""
    cfg = kernel_config(cfg)
    sigma, rgb = cfg.xyz_depth, cfg.xyz_depth + cfg.depth + 1
    return {"sigma_b0": sigma, "sigma_bskip": sigma + cfg.skip + 2,
            "rgb_b0": rgb, "rgb_bskip": rgb + cfg.skip + 2}


def rebias_fused_params(fused: FusedParams, cond: Params, cfg: FieldConfig) -> FusedParams:
    """`fused` for another folded conditioning of the same field: the
    conditioning enters only `b_pts` and four rows of `b_stack`, so the cast
    and tiled weights are shared, not made again (distillation draws a new
    conditioning every step)."""
    b_stack = fused.b_stack.clone()
    for key, row in _cond_rows(cfg).items():
        b_stack[row, :cfg.width] = cond[key]
    b_pts = _pad(cond["xyz_b"], fused.b_pts.shape, torch.float32).contiguous()
    return fused._replace(b_stack=b_stack, b_pts=b_pts)


def uses_wgmma(cfg: FieldConfig) -> bool:
    """Whether the CUDA entry point runs the wgmma design for `cfg`: bf16 at
    the teacher's two widths (of the kernel's config), with an embedding that
    fits one 64-deep tile (csrc/field_kernel.cu::uses_wgmma states the same rule)."""
    cfg = kernel_config(cfg)
    return (cfg.compute_dtype == torch.bfloat16 and cfg.width in _WGMMA_ROWS
            and cfg.pts_embed_dim <= TILE_K)


def uses_tf32(cfg: FieldConfig) -> bool:
    """Whether the CUDA entry point runs the 3xTF32 design for `cfg`: f32 at
    every width (csrc/field_kernel.cu picks it for dtype 0)."""
    return cfg.compute_dtype == torch.float32


def product_layers(cfg: FieldConfig) -> list:
    """Indices into `w_stack` in the order the wgmma design multiplies by
    them. A trunk starts with the first half of its skip pair (saved @ W,
    taken while the running activation still is the saved one; the sum waits
    in f32), then L0, the mid layers, the pair's second half, the post layers."""
    cfg = kernel_config(cfg)
    order = list(range(cfg.xyz_depth))
    for trunk in range(2):
        base = cfg.xyz_depth + trunk * (cfg.depth + 1)
        order += [base + cfg.skip + 1, *range(base, base + cfg.skip + 1), base + cfg.skip + 2,
                  *range(base + cfg.skip + 3, base + cfg.depth + 1)]
    return order


def stream_plan(cfg: FieldConfig) -> list:
    """What each tile of the wgmma design's stream holds, in stream order:
    `(operand, layer, k0, n0)` for the `[k0:k0+64, n0:n0+256]` slice of
    `w_pts` (rows zero-padded to 64), `w_stack[layer]` or `w_view` (columns
    zero-padded to 256), stored transposed (`[256, 64]`) and swizzled.

    Width 256: a layer is one column tile wide, and its tiles run k block by
    k block. Width 1024: a CTA holds the accumulators of two column tiles at
    a time, so a product runs in rounds over k: column tiles 0 and 1 in the
    first, 2 and 3 in the second; its tiles run round, k block, tile of the
    pair."""
    cfg = kernel_config(cfg)
    W, W2 = cfg.width, cfg.width // 2
    pair = 2 if W > TILE_N else 1

    def product(operand, layer, k_dim, n_dim):
        rounds = max(1, n_dim // (TILE_N * pair))
        return [(operand, layer, k0, (r * pair + j) * TILE_N)
                for r in range(rounds) for k0 in range(0, k_dim, TILE_K) for j in range(pair)]

    plan = product("w_pts", None, TILE_K, W)
    for layer in product_layers(cfg):
        plan += product("w_stack", layer, W, W)
    return plan + product("w_view", None, W, W2)


def _swizzle(tiles: torch.Tensor) -> torch.Tensor:
    """[..., n, 128 bytes] (64 bf16 or 32 f32; n a multiple of 8) -> the same
    rows with the 16-byte chunk c of row r moved to chunk c ^ (r % 8): the
    128-byte swizzle. Its own inverse."""
    n, k = tiles.shape[-2:]
    rows = torch.arange(n, device=tiles.device)
    chunk = torch.arange(8, device=tiles.device)
    src = chunk[None, :] ^ (rows[:, None] & 7)                     # [n, 8]
    t = tiles.reshape(-1, n, 8, k // 8)
    return t[:, rows[:, None], src].reshape(tiles.shape)


def _to_tiles(w: torch.Tensor, pair: int) -> torch.Tensor:
    """[P, K, N] (K a multiple of 64, N of 256 * pair) -> [P * tiles, 256, 64]
    in the order round, k block, tile of the pair of `stream_plan`, transposed."""
    P, K, N = w.shape
    rounds = N // (TILE_N * pair)
    t = w.reshape(P, K // TILE_K, TILE_K, rounds, pair, TILE_N)
    return t.permute(0, 3, 1, 4, 5, 2).reshape(-1, TILE_N, TILE_K)


def tile_weights(w_pts: torch.Tensor, w_stack: torch.Tensor, w_view: torch.Tensor,
                 cfg: FieldConfig) -> torch.Tensor:
    """The wgmma design's weight stream `[tiles, 256, 64]` for `cfg` (see
    `stream_plan`), the 3xTF32 design's `[tiles, 2, BN, 32]` where
    `uses_tf32(cfg)` (`tile_weights_tf32`), no tiles for the mma.sync design.
    A copy of every weight: made once a `pack_fused_params`, never once a packet."""
    cfg = kernel_config(cfg)
    if uses_tf32(cfg):
        return tile_weights_tf32(w_pts, w_stack, w_view, cfg)
    if not uses_wgmma(cfg):
        return w_stack.new_zeros((0, TILE_N, TILE_K))
    W, W2 = cfg.width, cfg.width // 2
    pair = 2 if W > TILE_N else 1
    pts = w_stack.new_zeros((1, TILE_K, W))
    pts[0, :w_pts.shape[0]] = w_pts
    view = w_stack.new_zeros((1, W, max(W2, TILE_N)))
    view[0, :, :W2] = w_view
    order = torch.tensor(product_layers(cfg), device=w_stack.device)
    tiles = torch.cat([_to_tiles(pts, pair), _to_tiles(w_stack[order], pair),
                       _to_tiles(view, min(pair, view.shape[2] // TILE_N))])
    return _swizzle(tiles).contiguous()


def untile_weights(w_tiles: torch.Tensor, cfg: FieldConfig):
    """Inverse of `tile_weights`: (w_pts [64, W], w_stack [L, W, W], w_view
    [W, W/2]) from the stream (the padding dropped, but for w_pts' rows)."""
    cfg = kernel_config(cfg)
    W, W2 = cfg.width, cfg.width // 2
    tiles = _swizzle(w_tiles)
    w_pts = w_tiles.new_zeros((TILE_K, W))
    w_stack = w_tiles.new_zeros((_plan_len(cfg), W, W))
    w_view = w_tiles.new_zeros((W, max(W2, TILE_N)))
    for tile, (operand, layer, k0, n0) in zip(tiles, stream_plan(cfg)):
        dst = {"w_pts": w_pts, "w_view": w_view}.get(operand)
        dst = w_stack[layer] if dst is None else dst
        dst[k0:k0 + TILE_K, n0:n0 + TILE_N] = tile.t()
    return w_pts, w_stack, w_view[:, :W2].contiguous()


def wgmma_block_rows(cfg: FieldConfig) -> int:
    """Point rows of one CTA of the wgmma design, which share one read of the
    weight stream: what the running `[rows, W]` activation and a ring of 32 KB
    tiles leave room for in 227 KB of shared memory."""
    return _WGMMA_ROWS[kernel_config(cfg).width]


# ---- the 3xTF32 design (f32)

def tf32_cols(cfg: FieldConfig) -> int:
    """BN, the output columns of a CTA tile and of a weight tile of the 3xTF32
    design: 128, or 64 at the widths 128 does not divide."""
    return 128 if kernel_config(cfg).width % 128 == 0 else 64


def tf32_plan(cfg: FieldConfig) -> list:
    """The products of the 3xTF32 design in launch order, one launch each:
    `(pieces, n_cols)`, where `pieces` lists the `(operand, layer)` blocks of
    the product's weights stacked over k -- `w_pts` (rows zero-padded to 32),
    `w_stack[layer]`, `w_view` -- and `n_cols` its output columns. The skip
    pair is one product over k = 2W: `[saved, h] @ [W_a; W_b]`."""
    cfg = kernel_config(cfg)
    W = cfg.width
    plan = [([("w_pts", None)], W)]
    plan += [([("w_stack", li)], W) for li in range(cfg.xyz_depth)]
    for trunk in range(2):
        base = cfg.xyz_depth + trunk * (cfg.depth + 1)
        plan += [([("w_stack", li)], W) for li in range(base, base + cfg.skip + 1)]
        plan.append(([("w_stack", base + cfg.skip + 1), ("w_stack", base + cfg.skip + 2)], W))
        plan += [([("w_stack", li)], W)
                 for li in range(base + cfg.skip + 3, base + cfg.depth + 1)]
    return plan + [([("w_view", None)], W // 2)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 fraction bits), ties away from zero,
    as `cvt.rna.tf32.f32` rounds: the low 13 bits of the result are zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi). hi + lo is x within 2^-22 of
    |x|, and lo @ hi + hi @ lo + hi @ hi is an f32 product in three TF32 ones."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def _tf32_pieces(w_pts, w_stack, w_view, pieces, cfg: FieldConfig) -> torch.Tensor:
    """The [K, N] weights of one product of `tf32_plan`, zero-padded: k to a
    multiple of 32, N to one of BN."""
    bn = tf32_cols(cfg)
    mats = []
    for operand, layer in pieces:
        w = {"w_pts": w_pts, "w_view": w_view}.get(operand)
        mats.append(w_stack[layer] if w is None else w)
    w = torch.cat(mats)
    k, n = w.shape
    return _pad(w, (-(-k // TF32_K) * TF32_K, -(-n // bn) * bn), torch.float32)


def tile_weights_tf32(w_pts: torch.Tensor, w_stack: torch.Tensor, w_view: torch.Tensor,
                      cfg: FieldConfig) -> torch.Tensor:
    """The 3xTF32 design's weight stream `[tiles, 2, BN, 32]` f32: for each
    product of `tf32_plan`, column tile by column tile, k block by k block, the
    `[32 k, BN]` slice transposed to `[BN, 32]` (K-major: wgmma takes TF32
    operands in no other order), split into its high (`[t, 0]`) and low
    (`[t, 1]`) TF32 parts and swizzled, so that a stage of the kernel's ring is
    one contiguous copy."""
    cfg = kernel_config(cfg)
    bn = tf32_cols(cfg)
    tiles = []
    for pieces, _ in tf32_plan(cfg):
        w = _tf32_pieces(w_pts, w_stack, w_view, pieces, cfg)
        k, n = w.shape
        t = w.reshape(k // TF32_K, TF32_K, n // bn, bn).permute(2, 0, 3, 1)
        tiles.append(torch.stack(tf32_split(t.reshape(-1, bn, TF32_K)), dim=1))
    return _swizzle(torch.cat(tiles)).contiguous()


def untile_weights_tf32(w_tiles: torch.Tensor, cfg: FieldConfig) -> list:
    """Inverse of `tile_weights_tf32`: for each product of `tf32_plan`, its
    padded `[K, N]` weights as (hi, lo)."""
    cfg = kernel_config(cfg)
    bn, W = tf32_cols(cfg), cfg.width
    tiles, at, out = _swizzle(w_tiles), 0, []
    for pieces, n_cols in tf32_plan(cfg):
        k = -(-sum(_padded_pe(cfg) if op == "w_pts" else W for op, _ in pieces) // TF32_K)
        n = -(-n_cols // bn)
        t = tiles[at:at + n * k].reshape(n, k, 2, bn, TF32_K)
        at += n * k
        w = t.permute(2, 1, 4, 0, 3).reshape(2, k * TF32_K, n * bn)
        out.append((w[0], w[1]))
    if at != w_tiles.shape[0]:
        raise ValueError(f"the stream holds {w_tiles.shape[0]} tiles, the plan {at}")
    return out


def tf32_scratch(cfg: FieldConfig, n_rows: int) -> tuple:
    """(rows of a chunk, f32 elements of the scratch) of the 3xTF32 design for
    `n_rows` points: it runs a chunk of rows through one layer at a time, so it
    keeps the chunk's embedded points (k padded to 32) and three `[rows, W]`
    activations in device memory -- the running one, the one it writes, and
    the saved xyz_code or sigma_feat of the skip pair and the alpha head -- in
    tiles of `TF32_ROWS` rows. A chunk is at most 256 MB an activation."""
    cfg = kernel_config(cfg)
    W, kp = cfg.width, -(-cfg.pts_embed_dim // TF32_K) * TF32_K
    most = max(TF32_ROWS, _TF32_CHUNK_BYTES // (W * 4) // TF32_ROWS * TF32_ROWS)
    rows = min(most, max(TF32_ROWS, -(-n_rows // TF32_ROWS) * TF32_ROWS))
    return rows, rows * (kp + 3 * W)


def wgmma_scratch(cfg: FieldConfig, n_sms: int) -> tuple:
    """(most CTAs the wgmma design launches on a card of `n_sms` SMs, f32
    elements of its scratch): a CTA is persistent, one an SM, and parks the
    f32 sums of a skip pair's first half for its `[rows, W]` block."""
    return n_sms, n_sms * wgmma_block_rows(cfg) * kernel_config(cfg).width


def _ref_rows(fused: FusedParams, x, dirf_rows, cfg: FieldConfig, layer_mm=None):
    """The kernel's math on a block of rows: x [n, pe] f32, dirf_rows
    [n, W/2] f32 -> [n, 4] f32, for the kernel's config `cfg`. `layer_mm(a, w)`,
    if given, takes the place of the products of the layers (not the heads')."""
    dt, f32 = cfg.compute_dtype, torch.float32
    W, pe = cfg.width, cfg.pts_embed_dim

    def mm(a, w):
        # operands rounded to the compute dtype, products summed in f32
        return a.to(dt).to(f32) @ w.to(f32)

    head_mm, mm = mm, layer_mm or mm

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
    return head_mm(sigma_feat, fused.w_out[:W]) + head_mm(view, fused.w_out[W:]) + fused.b_out


def fused_field_apply_ref(fused: FusedParams, pts_embed: torch.Tensor,
                          dir_feat: torch.Tensor, cfg: FieldConfig,
                          samples_per_ray: int):
    """Plain PyTorch version of the fused kernel, on any device: (raw_rgb
    [N, 3], raw_sigma [N, 1]) in f32, on the operands padded to
    `kernel_config(cfg)` as the kernel reads them. Rows go through in chunks,
    so the f32 upcast of a [rows, W] activation stays small at packet sizes."""
    return _ref_apply(fused, pts_embed, dir_feat, cfg, samples_per_ray)


def _ref_apply(fused, pts_embed, dir_feat, cfg, samples_per_ray, layer_mm=None):
    N = pts_embed.shape[0]
    kcfg = kernel_config(cfg)
    dirf = _pad(dir_feat, (dir_feat.shape[0], kcfg.width // 2), torch.float32)
    outs = []
    for r0 in range(0, N, _REF_CHUNK):
        r1 = min(r0 + _REF_CHUNK, N)
        ray = torch.arange(r0, r1, device=pts_embed.device) // samples_per_ray
        outs.append(_ref_rows(fused, pts_embed[r0:r1].to(torch.float32), dirf[ray], kcfg,
                              layer_mm))
    out = torch.cat(outs) if outs else pts_embed.new_zeros((0, 4), dtype=torch.float32)
    return out[:, 0:3], out[:, 3:4]


def _check_config(cfg: FieldConfig) -> None:
    if not isinstance(cfg, FieldConfig):
        raise ValueError("the fused field kernel takes a FieldConfig")
    if cfg.compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"compute dtype {cfg.compute_dtype} is not float32 or bfloat16")
    width = kernel_config(cfg).width
    if width > _MAX_WIDTH:
        raise ValueError(f"the kernel takes widths up to {_MAX_WIDTH} (the field's, or its "
                         f"embedding's, rounded up to a multiple of 64), got {width} for "
                         f"width {cfg.width} and a {cfg.pts_embed_dim}-dim embedding")


def _stream_shape(cfg: FieldConfig) -> tuple:
    """Shape of `FusedParams.w_tiles` for the kernel's config `cfg`."""
    if uses_tf32(cfg):
        bn = tf32_cols(cfg)
        n = sum(-(-(_padded_pe(cfg) if pieces[0][0] == "w_pts" else len(pieces) * cfg.width)
                  // TF32_K) * -(-n_cols // bn) for pieces, n_cols in tf32_plan(cfg))
        return (n, 2, bn, TF32_K)
    return (len(stream_plan(cfg)) if uses_wgmma(cfg) else 0, TILE_N, TILE_K)


def _operand_shapes(cfg: FieldConfig, n_rows: int, n_rays: int) -> Dict[str, tuple]:
    """What the wrapper takes for the field `cfg`: the points and view features
    at the field's width, the packed operands at the kernel's."""
    kcfg = kernel_config(cfg)
    W, W2, L = kcfg.width, kcfg.width // 2, _plan_len(kcfg)
    return {"pts_embed": (n_rows, cfg.pts_embed_dim), "dir_feat": (n_rays, cfg.width // 2),
            "w_stack": (L, W, W), "b_stack": (L, W), "w_pts": (_padded_pe(kcfg), W),
            "b_pts": (W,), "w_view": (W, W2), "b_view": (W2,),
            "w_out": (W + W2, 4), "b_out": (4,), "w_tiles": _stream_shape(kcfg)}


_COMPUTE_DTYPE_OPERANDS = ("w_stack", "w_pts", "w_view", "w_out", "w_tiles")


def _check_operands(fused: FusedParams, pts_embed, dir_feat, cfg: FieldConfig,
                    samples_per_ray: int) -> None:
    """Device, dtype, shape, contiguity and 16-byte alignment of everything the
    kernel reads."""
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
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def _lib():
    from mofanerf_tpu_torch.utils.cuda_build import load

    lib = load("field_kernel")
    lib.field_apply.restype = ctypes.c_int
    lib.field_apply.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                                + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    for fn in (lib.field_block_rows, lib.field_uses_wgmma):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3
    return lib


def block_rows(cfg: FieldConfig) -> int:
    """Point rows that share one read of the weights in the CUDA kernel for
    `cfg`: a CTA's rows (the fused designs stream the whole weight stack once
    a row block, the 3xTF32 design a layer's column tile once a CTA tile),
    which sets the kernel's weight traffic. Asked of the built library;
    `wgmma_block_rows` and `TF32_ROWS` reckon the same here."""
    _check_config(cfg)
    kcfg = kernel_config(cfg)
    rows = _lib().field_block_rows(_DTYPE_CODE[cfg.compute_dtype], kcfg.width,
                                   cfg.pts_embed_dim)
    if rows <= 0:
        raise ValueError(f"the kernel does not take width {kcfg.width}")
    return rows


def _field_cuda(fused: FusedParams, pts_embed, dir_feat, cfg: FieldConfig,
                samples_per_ray: int) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands of the kernel's config `cfg`
    (`dir_feat` padded to it): [N, 4] f32 (rgb, sigma)."""
    global launch_count
    dev = pts_embed.device
    n_rows = pts_embed.shape[0]
    out = torch.empty((n_rows, 4), dtype=torch.float32, device=dev)
    lib = _lib()
    code = _DTYPE_CODE[cfg.compute_dtype]
    if bool(lib.field_uses_wgmma(code, cfg.width, cfg.pts_embed_dim)) != uses_wgmma(cfg):
        raise RuntimeError("the built library and ops/field_kernel.py disagree on the design "
                           f"for width {cfg.width}, {cfg.compute_dtype}")
    max_ctas, chunk, n_scratch = 0, 0, 0
    if uses_wgmma(cfg):
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        max_ctas, n_scratch = wgmma_scratch(cfg, n_sms)
    elif uses_tf32(cfg):
        chunk, n_scratch = tf32_scratch(cfg, n_rows)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.field_apply(
            code, pts_embed.data_ptr(), dir_feat.data_ptr(),
            fused.w_pts.data_ptr(), fused.b_pts.data_ptr(), fused.w_stack.data_ptr(),
            fused.b_stack.data_ptr(), fused.w_view.data_ptr(), fused.b_view.data_ptr(),
            fused.w_out.data_ptr(), fused.b_out.data_ptr(), fused.w_tiles.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            n_rows, samples_per_ray, cfg.pts_embed_dim, cfg.width, cfg.depth,
            cfg.skip, cfg.xyz_depth, max_ctas, chunk, stream)
    if err != 0:
        raise RuntimeError(f"field_apply kernel launch failed: cudaError {err}")
    if n_rows:
        launch_count += 1
        launch_shapes[(str(cfg.compute_dtype).removeprefix("torch."), cfg.depth, cfg.width,
                       n_rows // samples_per_ray, samples_per_ray)] += 1
    return out


def fused_field_apply(fused: FusedParams, pts_embed: torch.Tensor, dir_feat: torch.Tensor,
                      cfg: FieldConfig, samples_per_ray: int):
    """(raw_rgb [N, 3], raw_sigma [N, 1]) in f32 for N = R * samples_per_ray
    embedded points `pts_embed` [N, pe] (f32) and per-ray view features
    `dir_feat` [R, W/2] (f32): the contract of apply_field_folded, for any
    field it takes (the operands padded to `kernel_config(cfg)`).

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (and raise if it cannot run); other devices raise."""
    _check_config(cfg)
    dev = pts_embed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_field_apply runs on cuda or cpu, not {dev}")
    pts_embed, dir_feat = aligned(pts_embed), aligned(dir_feat)
    _check_operands(fused, pts_embed, dir_feat, cfg, samples_per_ray)
    if dev.type == "cpu":
        return fused_field_apply_ref(fused, pts_embed, dir_feat, cfg, samples_per_ray)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*fused, pts_embed, dir_feat)):
        raise ValueError("an operand requires grad: the fused kernel is inference only; "
                         "call it under torch.no_grad(), or differentiate "
                         "models/field.py::apply_field_folded")
    kcfg = kernel_config(cfg)
    dirf = _pad(dir_feat, (dir_feat.shape[0], kcfg.width // 2), torch.float32).contiguous()
    out = _field_cuda(fused, pts_embed, dirf, kcfg, samples_per_ray)
    return out[:, 0:3], out[:, 3:4]
