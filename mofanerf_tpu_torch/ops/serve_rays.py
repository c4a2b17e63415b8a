"""The serving path's rays and kernel B2's per-ray operands, made in one pass:
the CUDA kernel's wrapper and its plain PyTorch version.

`serve_rays` makes, for a stack of F camera poses, every input that the
serving sweep's compaction and kernel B2 read: the rays in `get_rays`'s
row-major order, frame after frame, then the sweep's padding rays (all ones);
each row's `aux` (t0, t1, hit, |d|) and view features `dirf`, as
`ray_operands` makes them; and the count of hit rays, kept on the device. On
a CUDA tensor it launches `csrc/serve_rays.cuh` (in the serving kernel's
library, built at first use); on a CPU tensor it runs `serve_rays_ref`, the
chain of `get_rays`, `ray_aabb_interval` and `ray_operands` that the
serving path ran before the kernel. Any other device raises.

No TPU kernel stands behind it: under jit, XLA fused that chain into one
program, where eager PyTorch launches dozens of small kernels a frame.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from mofanerf_tpu_torch.ops.embed import embed_dim
from mofanerf_tpu_torch.ops.rays import get_rays
from mofanerf_tpu_torch.ops.serve_kernel import (_DTYPE_CODE, StudentPack, _check_cuda_operand,
                                                 ray_operands)
from mofanerf_tpu_torch.utils import profiling

# kernel launches made by `serve_rays` in this process, and the same launches by shape:
# (dirf dtype, poses, H, W, view embedding, W/2, rows) -> launches
launch_count = 0
launch_shapes: collections.Counter = collections.Counter()


class ServeRays(NamedTuple):
    """Rays and their operands, `n` rays and the padding rows after them."""

    rays_o: torch.Tensor   # [rows, 3] f32
    rays_d: torch.Tensor   # [rows, 3] f32
    aux: torch.Tensor      # [rows, 4] f32: t0, t1, hit, |d|
    dirf: torch.Tensor     # [rows, W/2] compute dtype
    n_hit: torch.Tensor    # one integer: the hit rays among the first n
    n: int                 # F * H * W


def serve_rays_ref(pack: StudentPack, cfg, H: int, W: int, K, poses, near, far, aabb_min,
                   aabb_max, n_rows: int | None = None) -> ServeRays:
    """The plain version: `get_rays` pose by pose, the padding rays, then
    `ray_operands` over all rows. `poses` [F, 3|4, 4] and K [3, 3] lie on the
    device of `pack`."""
    n = poses.shape[0] * H * W
    rows = n if n_rows is None else n_rows
    rays = [get_rays(H, W, K, pose[:3]) for pose in poses]
    pad = torch.ones((rows - n, 3), dtype=torch.float32, device=K.device)
    ro = torch.cat([o.reshape(-1, 3) for o, _ in rays] + [pad])
    rd = torch.cat([d.reshape(-1, 3) for _, d in rays] + [pad])
    aux, dirf = ray_operands(pack, cfg, ro, rd, near, far, aabb_min, aabb_max)
    return ServeRays(ro, rd, aux, dirf, (aux[:n, 2] > 0).sum(), n)


@functools.lru_cache(maxsize=None)
def _fn():
    from mofanerf_tpu_torch.utils.cuda_build import load

    fn = load("serve_kernel").serve_rays
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def _serve_rays_cuda(pack: StudentPack, cfg, H, W, K, poses, near, far, lo, hi,
                     n_rows: int) -> ServeRays:
    """Launch the kernel: checks device, dtype, shape, contiguity and the
    alignment of `w_dirs`, and raises if the launch fails."""
    global launch_count
    dev, dt = pack.w_dirs.device, cfg.compute_dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"compute dtype {dt} is not float32 or bfloat16")
    F, n = poses.shape[0], poses.shape[0] * H * W
    E, W2 = embed_dim(3, cfg.multires_views), pack.w_dirs.shape[-1]
    if W2 % (16 // dt.itemsize):
        raise ValueError(f"the kernel stores view features 16 bytes at a time: W/2 = {W2} "
                         f"is not a multiple of {16 // dt.itemsize} in {dt}")
    shapes = {"K": (K, (3, 3)), "poses": (poses, (F, poses.shape[1], 4)),
              "aabb_min": (lo, (3,)), "aabb_max": (hi, (3,)), "w_dirs": (pack.w_dirs, (E, W2))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or (name == "poses" and shape[1] not in (3, 4)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        # the kernel copies w_dirs 16 bytes at a time: an offset view would fault
        _check_cuda_operand(name, t, torch.float32, dev, aligned16=name == "w_dirs")
    if n_rows < n:
        raise ValueError(f"{n_rows} rows cannot hold {n} rays")
    f32 = dict(dtype=torch.float32, device=dev)
    out = ServeRays(torch.empty((n_rows, 3), **f32), torch.empty((n_rows, 3), **f32),
                    torch.empty((n_rows, 4), **f32),
                    torch.empty((n_rows, W2), dtype=dt, device=dev),
                    torch.empty((1,), dtype=torch.int32, device=dev), n)
    with torch.cuda.device(dev):
        err = _fn()(_DTYPE_CODE[dt], K.data_ptr(), poses.data_ptr(), poses.stride(0),
                    lo.data_ptr(), hi.data_ptr(), pack.w_dirs.data_ptr(), out.rays_o.data_ptr(),
                    out.rays_d.data_ptr(), out.aux.data_ptr(), out.dirf.data_ptr(),
                    out.n_hit.data_ptr(), n, n_rows, H, W, cfg.multires_views, W2, near, far,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"serve_rays kernel launch failed: cudaError {err}")
    if n_rows:
        launch_count += 1
        launch_shapes[(str(dt).removeprefix("torch."), F, H, W, E, W2, n_rows)] += 1
        profiling.count("serve_rays_frames", F)
    return out


def serve_rays(pack: StudentPack, cfg, H: int, W: int, K, poses, near, far, aabb_min,
               aabb_max, n_rows: int | None = None) -> ServeRays:
    """The rays of F poses `[F, 3|4, 4]` at H x W pixels, intrinsics K `[3, 3]`,
    and their operands for the student packed in `pack`, with `n_rows - F*H*W`
    padding rows (all ones) after them; K, the poses and the box `[3]` are f32
    tensors on the pack's device.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise if it cannot run); other devices raise. Each launch adds F to
    `profiling.counters["serve_rays_frames"]` while tracing is on; the plain
    version counts nothing."""
    dev = pack.w_dirs.device
    n = poses.shape[0] * H * W
    rows = n if n_rows is None else n_rows
    if dev.type == "cpu":
        return serve_rays_ref(pack, cfg, H, W, K, poses, near, far, aabb_min, aabb_max, rows)
    if dev.type != "cuda":
        raise ValueError(f"serve_rays runs on cuda or cpu, not {dev}")
    return _serve_rays_cuda(pack, cfg, H, W, K, poses, near, far, aabb_min, aabb_max, rows)
