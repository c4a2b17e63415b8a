"""Fused bounded render of a distilled student: the CUDA kernel's wrapper and
its plain PyTorch version (counterpart of mofanerf_tpu/ops/pallas_serve.py).

`render_rays_bounded_fused` renders a packet of rays through a skipless
student with relu density and a folded code: sample placement inside each
ray's AABB interval, the positional encoding `sin(pts @ A + phase)`, the
whole MLP, the view head and alpha compositing. On a CUDA tensor it launches
the hand-written kernel in `csrc/serve_kernel.cu` (built at first use); on a
CPU tensor it runs `render_rays_bounded_fused_ref`, the same math in plain
PyTorch with the same rounding points. Any other device raises.

Precision contract (the TPU kernel's): products cast both operands to the
compute dtype and accumulate in f32, the input layer's world-space points
included; bias adds, ReLU and sigmoid are f32; each hidden layer's output is
cast back to the compute dtype; compositing is f32.

The operands come in two parts. `pack_student` casts, stacks and tiles the
weights once (a frame, a path); `ray_operands` makes a packet's per-ray
inputs (`aux`, `dirf`), which the serving path has `ops/serve_rays.py` make
for all of a frame's or a path's rays in one kernel. Two designs of the
kernel (csrc/serve_kernel.cu picks one by the rule `uses_wgmma` states
here): the wgmma design keeps the whole bf16 weight set resident in shared
memory, read from one image that `tile_student_weights` writes, K-major in
the 128-byte swizzle wgmma reads (`untile_student_weights` is the inverse);
the mma.sync design reads the plain operands.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.models.student import StudentConfig
from mofanerf_tpu_torch.ops.bounds import DEFAULT_AABB_MAX, DEFAULT_AABB_MIN, ray_aabb_interval
from mofanerf_tpu_torch.ops.embed import embed_freqs, fourier_embed
from mofanerf_tpu_torch.ops.field_kernel import TILE_K, _swizzle
from mofanerf_tpu_torch.utils.device import aligned

Params = Dict[str, Any]

# rays a packet is padded to a multiple of by the sweep, so that packet shapes
# (and padded rays) match the JAX package's; the CUDA kernel itself masks any
# ragged edge
_BLOCK_R = 256

# kernel launches made by `render_rays_bounded_fused` in this process, and the same
# launches by shape: (dtype, depth, width, multires, rays, samples a ray) -> launches
launch_count = 0
launch_shapes: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SAMPLES = {torch.float32: 128, torch.bfloat16: 256}  # sample rows a CTA holds
_MAX_WIDTH = 128
_COMPUTE_DTYPE_OPERANDS = ("dirf", "w0", "wl", "wsig", "wfeat", "wrgb", "w_tiles")
# the wgmma design: its width, the most hidden layers whose weights fit in shared
# memory beside the rest, the most samples a ray, and its heads' output columns
# (W/2 + 1 rounded up to a multiple of 8, the rgb head's 3 to wgmma's least n)
_WGMMA_WIDTH, _WGMMA_MAX_DEPTH, _WGMMA_MAX_SAMPLES = 128, 5, 128
RGB_N = 8


class StudentPack(NamedTuple):
    """A student's weights as the kernel reads them, made once by `pack_student`."""

    w0: torch.Tensor       # [3 + 6*mr, W] compute dtype
    b0: torch.Tensor       # [W] f32
    wl: torch.Tensor       # [D, W, W] compute dtype
    bl: torch.Tensor       # [D, W] f32
    wsig: torch.Tensor     # [W, 1] compute dtype
    bsig: torch.Tensor     # [1] f32
    wfeat: torch.Tensor    # [W, W/2] compute dtype
    bfeat: torch.Tensor    # [W/2] f32
    wrgb: torch.Tensor     # [W/2, 3] compute dtype
    brgb: torch.Tensor     # [3] f32
    w_dirs: torch.Tensor   # [views embedding, W/2] f32: a packet's view features
    w_tiles: torch.Tensor  # [image rows, 64] bf16: w0, wl, the heads once more as the
                           # wgmma design's image (`tile_student_weights`); no rows where
                           # `takes_tiles` is false


def _embed_constants(multires: int):
    """(A [3, 6*mr], phase [1, 6*mr]) with sin(pts @ A + phase) reproducing
    fourier_embed's channel order after the 3 identity dims: per band f_k,
    sin(x*f_k) [3] then cos(x*f_k) [3]."""
    mr = multires
    A = np.zeros((3, 6 * mr), np.float32)
    phase = np.zeros((1, 6 * mr), np.float32)
    for k, f in enumerate(embed_freqs(mr)):
        A[:, 6 * k:6 * k + 3] = np.eye(3, dtype=np.float32) * f
        A[:, 6 * k + 3:6 * k + 6] = np.eye(3, dtype=np.float32) * f
        phase[0, 6 * k + 3:6 * k + 6] = np.pi / 2
    return A, phase


def _refusal(cfg):
    """Why the kernel does not take the student `cfg`, or None where it does: a
    skipless StudentConfig in f32 or bf16, its width a multiple of 32 up to 128
    and its embedding no wider."""
    if not isinstance(cfg, StudentConfig) or cfg.skip != -1:
        return ("the fused serving kernel takes the skipless student "
                "(StudentConfig with skip == -1)")
    if cfg.compute_dtype not in _DTYPE_CODE:
        return f"compute dtype {cfg.compute_dtype} is not float32 or bfloat16"
    if cfg.width % 32 or cfg.width > _MAX_WIDTH or 3 + 6 * cfg.multires > _MAX_WIDTH:
        return (f"the kernel takes widths that are multiples of 32 up to {_MAX_WIDTH} and "
                f"3 + 6*multires <= {_MAX_WIDTH}; got width={cfg.width}, "
                f"multires={cfg.multires}")
    return None


def takes(cfg) -> bool:
    """Whether the kernel takes the student `cfg` (`_check_config` raises where not)."""
    return _refusal(cfg) is None


def _check_config(cfg) -> None:
    reason = _refusal(cfg)
    if reason is not None:
        raise ValueError(reason)


def takes_tiles(cfg: StudentConfig) -> bool:
    """Whether the wgmma design can hold `cfg`'s weights: bf16 at W = 128 with
    at most 5 hidden layers and an embedding that fits one 64-deep K block."""
    return (cfg.compute_dtype == torch.bfloat16 and cfg.width == _WGMMA_WIDTH
            and cfg.depth <= _WGMMA_MAX_DEPTH and cfg.pts_embed_dim <= TILE_K)


def uses_wgmma(cfg: StudentConfig, n_samples: int) -> bool:
    """Whether the CUDA entry point runs the wgmma design for `cfg` at
    `n_samples` a ray: weights it can hold (`takes_tiles`) and S dividing 64,
    or 128, so that a 64-row tile holds whole rays or a ray two whole tiles
    (csrc/serve_kernel.cu::uses_wgmma states the same rule)."""
    return (takes_tiles(cfg) and 1 <= n_samples <= _WGMMA_MAX_SAMPLES
            and (64 % n_samples == 0 or n_samples % 64 == 0))


def head_columns(width: int) -> int:
    """Output columns of the sigma|feat head tile: W/2 features, sigma, zeros."""
    return -(-(width // 2 + 1) // 8) * 8


def image_plan(cfg: StudentConfig) -> list:
    """The parts of the wgmma design's weight image, in order: `(name, layer,
    n, k)` for a `[k, n]` matrix stored as k // 64 K blocks of `[n, 64]`:
    the input layer (rows zero-padded to 64), the hidden layers, the
    sigma|feat head (`wfeat | wsig | zeros`), the rgb head (zero-padded to
    `[64, 8]`)."""
    W = cfg.width
    return ([("w0", None, W, TILE_K)] + [("wl", l, W, W) for l in range(cfg.depth)]
            + [("head", None, head_columns(W), W), ("wrgb", None, RGB_N, TILE_K)])


def image_rows(cfg: StudentConfig) -> int:
    """Rows of 64 bf16 (128 bytes) in the image of `cfg`."""
    return sum(n * (k // TILE_K) for _, _, n, k in image_plan(cfg))


def tile_student_weights(w0, wl, wsig, wfeat, wrgb, cfg: StudentConfig) -> torch.Tensor:
    """The wgmma design's weight image `[rows, 64]` bf16 (see `image_plan`):
    every matrix as K blocks of `[n, 64]`, transposed (K-major), the 16-byte
    chunk c of row r at chunk c ^ (r % 8). Every block starts on a multiple
    of 8 rows, so that is the 128-byte swizzle within each block."""
    W, W2 = cfg.width, cfg.width // 2
    dt, dev = torch.bfloat16, w0.device
    mats = []
    for name, layer, n, k in image_plan(cfg):
        m = torch.zeros((k, n), dtype=dt, device=dev)
        if name == "w0":
            m[:w0.shape[0]] = w0
        elif name == "wl":
            m[:] = wl[layer]
        elif name == "head":
            m[:, :W2] = wfeat
            m[:, W2:W2 + 1] = wsig
        else:
            m[:W2, :3] = wrgb
        mats.append(m.reshape(k // TILE_K, TILE_K, n).transpose(1, 2).reshape(-1, TILE_K))
    return _swizzle(torch.cat(mats)).contiguous()


def untile_student_weights(w_tiles: torch.Tensor, cfg: StudentConfig) -> Dict[str, torch.Tensor]:
    """Inverse of `tile_student_weights`: {w0 [64, W] (with its padding rows),
    wl [D, W, W], wsig [W, 1], wfeat [W, W/2], wrgb [W/2, 3]}."""
    W, W2 = cfg.width, cfg.width // 2
    rows = _swizzle(w_tiles)
    out = {"wl": w_tiles.new_zeros((cfg.depth, W, W))}
    at = 0
    for name, layer, n, k in image_plan(cfg):
        blocks = rows[at:at + n * (k // TILE_K)].reshape(k // TILE_K, n, TILE_K)
        m = blocks.transpose(1, 2).reshape(k, n)
        at += n * (k // TILE_K)
        if name == "w0":
            out["w0"] = m
        elif name == "wl":
            out["wl"][layer] = m
        elif name == "head":
            out["wfeat"], out["wsig"] = m[:, :W2], m[:, W2:W2 + 1]
        else:
            out["wrgb"] = m[:W2, :3]
    return {k: v.contiguous() for k, v in out.items()}


def pack_student(params: Params, cfg: StudentConfig) -> StudentPack:
    """A folded, skipless student's params -> the kernel's weight operands: the
    matrices cast to the compute dtype and the biases to f32, the hidden layers
    stacked, and the wgmma design's image tiled; every operand starts on a
    16-byte boundary (a leaf that does not is copied). A copy of every weight:
    do it once a frame or path, not once a packet."""
    _check_config(cfg)
    if "cond" in params:
        raise ValueError("conditioned student: fold the code first "
                         "(fold_student_code); the folded params run unchanged")
    dt, f32 = cfg.compute_dtype, torch.float32
    W = cfg.width
    dev = params["input"]["w"].device
    layers = params["layers"]

    def operand(t, dtype):
        # the kernels load 16 bytes at a time: a leaf that is a view at another offset is copied
        return aligned(t.to(dtype).contiguous())

    w = {
        "w0": operand(params["input"]["w"], dt),
        "wl": (operand(torch.stack([l["w"] for l in layers]), dt) if layers
               else torch.zeros((0, W, W), dtype=dt, device=dev)),
        "wsig": operand(params["sigma"]["w"], dt),
        "wfeat": operand(params["feat"]["w"], dt),
        "wrgb": operand(params["rgb"]["w"], dt),
    }
    tiles = (tile_student_weights(**w, cfg=cfg) if takes_tiles(cfg)
             else torch.zeros((0, TILE_K), dtype=dt, device=dev))
    return StudentPack(
        b0=operand(params["input"]["b"], f32),
        bl=(operand(torch.stack([l["b"] for l in layers]), f32) if layers
            else torch.zeros((0, W), dtype=f32, device=dev)),
        bsig=operand(params["sigma"]["b"], f32),
        bfeat=operand(params["feat"]["b"], f32),
        brgb=operand(params["rgb"]["b"], f32),
        w_dirs=operand(params["view"]["w_dirs"], f32), w_tiles=tiles, **w)


def _as_pack(params, cfg: StudentConfig) -> StudentPack:
    _check_config(cfg)
    return params if isinstance(params, StudentPack) else pack_student(params, cfg)


def ray_operands(pack: StudentPack, cfg: StudentConfig, rays_o, rays_d, near, far,
                 aabb_min, aabb_max):
    """A packet's per-ray inputs, as the TPU wrapper builds them: (aux
    [N, 4] = t0, t1, hit, |d| in f32; dirf [N, W/2], the view features in
    the compute dtype)."""
    t0, t1, hit = ray_aabb_interval(rays_o, rays_d, aabb_min, aabb_max, near, far)
    normd = torch.linalg.norm(rays_d, dim=-1)
    de = fourier_embed(rays_d / normd[:, None], cfg.multires_views)
    aux = torch.stack([t0, t1, hit.to(torch.float32), normd], dim=-1).contiguous()
    return aux, (de @ pack.w_dirs).to(cfg.compute_dtype).contiguous()


def _split(out: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"rgb": out[:, 0:3], "acc": out[:, 3], "depth": out[:, 4], "disp": out[:, 5]}


def _serve_ref(pack: StudentPack, aux, dirf, cfg: StudentConfig, rays_o, rays_d,
               n_samples: int, white_bkgd: bool) -> torch.Tensor:
    """The kernel's math in plain PyTorch, ray-major: [N, 8] f32."""
    dt = cfg.compute_dtype
    f32 = torch.float32
    S = n_samples
    N = rays_o.shape[0]
    t0, t1 = aux[:, 0], aux[:, 1]

    def mm(a, b):
        # operands rounded to the compute dtype, products summed in f32
        return a.to(dt).to(f32) @ b.to(dt).to(f32)

    u = torch.arange(S, dtype=f32, device=rays_o.device) / max(S - 1, 1)
    z = t0[:, None] + (t1 - t0)[:, None] * u                       # [N, S]
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    A, phase = _embed_constants(cfg.multires)
    A = torch.as_tensor(A, device=rays_o.device)
    phase = torch.as_tensor(phase, device=rays_o.device)
    emb = torch.sin(pts @ A + phase)                               # [N*S, 6*mr]

    h = mm(pts, pack.w0[:3]) + mm(emb, pack.w0[3:]) + pack.b0
    h = F.relu(h).to(dt)
    for i in range(cfg.depth):
        h = F.relu(mm(h, pack.wl[i]) + pack.bl[i]).to(dt)
    sig = (mm(h, pack.wsig) + pack.bsig).reshape(N, S)
    pre = F.relu(mm(h, pack.wfeat) + pack.bfeat + dirf.repeat_interleave(S, dim=0))   # f32
    rgb = torch.sigmoid(mm(pre, pack.wrgb) + pack.brgb).reshape(N, S, 3)
    return _composite_ref(sig, rgb, z, aux, white_bkgd)


def _composite_ref(sig, rgb, z, aux, white_bkgd: bool) -> torch.Tensor:
    """The plain version's composite (f32, serially in sample order) of raw sigma
    `[N, S]`, rgb `[N, S, 3]` at depths `z [N, S]`: [N, 8] f32."""
    N, S = sig.shape
    f32 = torch.float32
    t0, t1, hit, normd = aux[:, 0], aux[:, 1], aux[:, 2], aux[:, 3]
    # uniform spacing -> a constant per-ray delta
    sig = F.relu(sig) * hit[:, None]
    delta = (t1 - t0) / max(S - 1, 1) * normd
    alpha = 1.0 - torch.exp(-sig * delta[:, None])
    alpha_last = 1.0 - torch.exp(-sig[:, S - 1] * (1e10 * normd))
    trans = torch.ones(N, dtype=f32, device=sig.device)
    acc_rgb = torch.zeros((N, 3), dtype=f32, device=sig.device)
    acc_w = torch.zeros(N, dtype=f32, device=sig.device)
    acc_zw = torch.zeros(N, dtype=f32, device=sig.device)
    for s in range(S):
        a = alpha[:, s] if s < S - 1 else alpha_last
        w = a * trans
        acc_rgb = acc_rgb + w[:, None] * rgb[:, s]
        acc_w = acc_w + w
        acc_zw = acc_zw + w * z[:, s]
        trans = trans * (1.0 - a + 1e-10)
    disp = 1.0 / torch.clamp(acc_zw / torch.clamp(acc_w, min=1e-10), min=1e-10)
    if white_bkgd:
        acc_rgb = acc_rgb + (1.0 - acc_w[:, None])
    zero = torch.zeros_like(acc_w)
    return torch.stack([acc_rgb[:, 0], acc_rgb[:, 1], acc_rgb[:, 2],
                        acc_w, acc_zw, disp, zero, zero], dim=-1)


def render_rays_bounded_fused_ref(
    params,
    cfg: StudentConfig,
    rays_o: torch.Tensor,   # [N, 3]
    rays_d: torch.Tensor,   # [N, 3]
    near: float,
    far: float,
    n_samples: int = 32,
    aabb_min=DEFAULT_AABB_MIN,
    aabb_max=DEFAULT_AABB_MAX,
    white_bkgd: bool = False,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the fused kernel, on any device. `params` is
    a folded student's params or its `pack_student`."""
    pack = _as_pack(params, cfg)
    aux, dirf = ray_operands(pack, cfg, rays_o, rays_d, near, far, aabb_min, aabb_max)
    return _split(_serve_ref(pack, aux, dirf, cfg, rays_o, rays_d, n_samples, white_bkgd))


def _check_cuda_operand(name: str, t: torch.Tensor, dtype, device,
                        aligned16: bool = False) -> None:
    """Device, dtype and contiguity of an operand; with `aligned16` (the
    pack's operands, which `pack_student` aligns), its 16-byte alignment."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the rays on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if aligned16 and t.data_ptr() % 16:
        raise ValueError(f"{name} does not start on a 16-byte boundary")


@functools.lru_cache(maxsize=None)
def _lib():
    from mofanerf_tpu_torch.utils.cuda_build import load

    lib = load("serve_kernel")
    lib.serve_render.restype = ctypes.c_int
    lib.serve_render.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    lib.serve_uses_wgmma.restype = ctypes.c_int
    lib.serve_uses_wgmma.argtypes = [ctypes.c_int] * 5
    lib.serve_items_skipped.restype = ctypes.c_int
    lib.serve_items_skipped.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _library_uses_wgmma(code: int, width: int, depth: int, multires: int, n_samples: int) -> bool:
    """The built library's dispatch rule for one shape, asked once."""
    return bool(_lib().serve_uses_wgmma(code, width, depth, multires, n_samples))


def items_all_missing(hit: torch.Tensor, n_samples: int) -> int:
    """Items of the wgmma design (64 sample rows, or one ray of more samples) whose rays
    all miss, from a packet's hit mask `[N]`: the items its kernel skips."""
    per = max(64, n_samples) // n_samples
    pad = hit.new_zeros((-hit.numel()) % per)
    return int((~torch.cat([hit.reshape(-1), pad]).reshape(-1, per).any(dim=1)).sum())


def items_skipped(device, reset: bool = True) -> int:
    """Items the wgmma design's kernel skipped on `device` since the count was last reset
    (the kernel counts them); `reset` sets the count to 0. Waits for the card."""
    count = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        err = _lib().serve_items_skipped(ctypes.byref(count), int(reset))
    if err != 0:
        raise RuntimeError(f"serve_items_skipped failed: cudaError {err}")
    return int(count.value)


def _serve_cuda(pack: StudentPack, aux, dirf, cfg: StudentConfig, rays_o, rays_d,
                n_samples: int, white_bkgd: bool) -> torch.Tensor:
    """Launch the CUDA kernel on prepared operands: [N, 8] f32. Checks
    device, dtype, shape and contiguity, and raises if the launch fails."""
    global launch_count
    dev = rays_o.device
    dt = cfg.compute_dtype
    N = rays_o.shape[0]
    if rays_o.ndim != 2 or rays_o.shape[1] != 3 or rays_d.shape != rays_o.shape:
        raise ValueError(f"rays must be [N, 3]; got {tuple(rays_o.shape)}, {tuple(rays_d.shape)}")
    if not 1 <= n_samples <= _MAX_SAMPLES[dt]:
        raise ValueError(f"the kernel takes 1..{_MAX_SAMPLES[dt]} samples a ray "
                         f"in {dt}, got {n_samples}")
    _check_config(cfg)
    W, W2 = cfg.width, cfg.width // 2
    wgmma = uses_wgmma(cfg, n_samples)
    shapes = {"rays_o": (N, 3), "rays_d": (N, 3), "aux": (N, 4), "dirf": (N, W2),
              "w0": (3 + 6 * cfg.multires, W), "b0": (W,), "wl": (cfg.depth, W, W),
              "bl": (cfg.depth, W), "wsig": (W, 1), "bsig": (1,), "wfeat": (W, W2),
              "bfeat": (W2,), "wrgb": (W2, 3), "brgb": (3,),
              "w_tiles": (image_rows(cfg) if takes_tiles(cfg) else 0, TILE_K)}
    tensors = dict(pack._asdict(), aux=aux, dirf=dirf, rays_o=rays_o, rays_d=rays_d)
    for name, shape in shapes.items():
        t = tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _check_cuda_operand(name, t, dt if name in _COMPUTE_DTYPE_OPERANDS
                            else torch.float32, dev, aligned16=name in StudentPack._fields)

    code = _DTYPE_CODE[dt]
    if _library_uses_wgmma(code, W, cfg.depth, cfg.multires, n_samples) != wgmma:
        raise RuntimeError("the built library and ops/serve_kernel.py disagree on the design "
                           f"for {cfg} at {n_samples} samples")
    out = torch.empty((N, 8), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().serve_render(
            code, rays_o.data_ptr(), rays_d.data_ptr(), aux.data_ptr(), dirf.data_ptr(),
            pack.w0.data_ptr(), pack.b0.data_ptr(), pack.wl.data_ptr(), pack.bl.data_ptr(),
            pack.wsig.data_ptr(), pack.bsig.data_ptr(), pack.wfeat.data_ptr(),
            pack.bfeat.data_ptr(), pack.wrgb.data_ptr(), pack.brgb.data_ptr(),
            pack.w_tiles.data_ptr() if wgmma else None, out.data_ptr(), N, n_samples,
            cfg.depth, W, cfg.multires, int(white_bkgd), stream)
    if err != 0:
        raise RuntimeError(f"serve_render kernel launch failed: cudaError {err}")
    if N:
        launch_count += 1
        launch_shapes[(str(dt).removeprefix("torch."), cfg.depth, W, cfg.multires, N,
                       n_samples)] += 1
    return out


def render_rays_bounded_fused(
    params,
    cfg: StudentConfig,
    rays_o: torch.Tensor,   # [N, 3]
    rays_d: torch.Tensor,   # [N, 3]
    near: float,
    far: float,
    n_samples: int = 32,
    aabb_min=DEFAULT_AABB_MIN,
    aabb_max=DEFAULT_AABB_MAX,
    white_bkgd: bool = False,
) -> Dict[str, torch.Tensor]:
    """Fused equivalent of render_rays_bounded for a skipless student with a
    folded code. `params` is the folded params or their `pack_student` (what
    a frame's packets share). Returns {rgb [N,3], acc, depth, disp [N]} in f32.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (and raise if it cannot run); other devices raise."""
    pack = _as_pack(params, cfg)
    if rays_o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"render_rays_bounded_fused runs on cuda or cpu, not {rays_o.device}")
    aux, dirf = ray_operands(pack, cfg, rays_o, rays_d, near, far, aabb_min, aabb_max)
    return render_packet_fused(pack, cfg, rays_o, rays_d, aux, dirf, n_samples, white_bkgd)


def render_packet_fused(pack: StudentPack, cfg: StudentConfig, rays_o, rays_d, aux, dirf,
                        n_samples: int = 32, white_bkgd: bool = False) -> Dict[str, torch.Tensor]:
    """`render_rays_bounded_fused` on operands made beforehand: the weights by
    `pack_student`, the rays' `(aux, dirf)` by `ray_operands` (over a whole
    frame at once, as the serving sweep makes them). The same dispatch: the
    plain version on the CPU, the kernel on the card, a raise elsewhere."""
    dev = rays_o.device
    if dev.type == "cpu":
        return _split(_serve_ref(pack, aux, dirf, cfg, rays_o, rays_d, n_samples, white_bkgd))
    if dev.type != "cuda":
        raise ValueError(f"render_rays_bounded_fused runs on cuda or cpu, not {dev}")
    return _split(_serve_cuda(pack, aux, dirf, cfg, rays_o, rays_d, n_samples, white_bkgd))
