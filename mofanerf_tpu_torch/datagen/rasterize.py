"""Vectorized software rasterizer — z-buffered flat-shaded triangles, in torch.

The port of mofanerf_tpu/datagen/rasterize.py (plain JAX there, plain torch
operations here, on the card by default). It replaces the reference's
pyrender/OpenGL offscreen renderer (tools/train_data_pre/render.py:13-67).

Algorithm: every triangle rasterizes a fixed TILE x TILE pixel window
anchored at its screen bbox (faces in this dataset are small on screen);
inside/front tests via barycentrics; depths scatter-min into the z-buffer
(`scatter_reduce_(..., "amin")`). Colors: every fragment within 1e-6 of its
pixel's winning depth is a winner, as in JAX; of a pixel's winners the one
with the largest flat fragment index (triangle-major, then its window's
row-major pixel) gives the colour, by a scatter-max of the index. That is
deterministic on the card (a scatter of colours with duplicate indices is
not) and is the order XLA's serial CPU scatter leaves: the last write wins.

The edge functions and the depth interpolation round as XLA's CPU code does
(fused multiply-adds, `_fma`), so that edge-on triangles fall on the same side
of the inside test.

Limitations (as in JAX): triangles larger than TILE pixels on screen are
only partially filled — raise `tile` for close-ups.
"""
from __future__ import annotations

import numpy as np
import torch

from mofanerf_tpu_torch.utils.device import resolve_device

_SPILL = 1 << 16   # bins past the image for fragments that draw nothing


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the float64 product of two float32
    values is exact). XLA's CPU backend contracts the JAX rasterizer's
    multiply-adds into FMAs, in this pattern; on edge-on triangles the
    inside test's sign hangs on it."""
    return (a.double() * b.double() + c.double()).float()


def rasterize_fragments(verts_cam: torch.Tensor, faces: torch.Tensor, colors: torch.Tensor,
                        fx: float, fy: float, cx: float, cy: float, H: int, W: int, tile: int):
    """The rasterizer proper on tensors, all on one device, float32: camera-
    space vertices [V, 3], faces [F, 3] (int64), per-face colours [F, 3].
    Returns (rgb [H, W, 3], depth [H, W] (inf where no hit), hit [H, W])."""
    dev = verts_cam.device
    v = verts_cam[faces]                       # [F, 3, 3]
    z = -v[..., 2]                             # depth along view (camera looks down -z)
    valid_tri = (z > 1e-6).all(dim=1)
    px = cx + fx * v[..., 0] / z               # the pixel model of ops/rays.py::get_rays
    py = cy - fy * v[..., 1] / z

    x0 = torch.clamp(torch.floor(px.min(dim=1).values), 0, W - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(py.min(dim=1).values), 0, H - 1).to(torch.int64)
    d = torch.arange(tile, device=dev)
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    pxs = x0[:, None] + gx.reshape(-1)[None, :]          # [F, tile*tile]
    pys = y0[:, None] + gy.reshape(-1)[None, :]
    inb = (pxs < W) & (pys < H)
    fpx = pxs.to(torch.float32) + 0.5
    fpy = pys.to(torch.float32) + 0.5

    ax, ay = px[:, 0:1], py[:, 0:1]
    bx, by = px[:, 1:2], py[:, 1:2]
    cx_, cy_ = px[:, 2:3], py[:, 2:3]

    def edge(x0, y0, x1, y1, qx, qy):
        return _fma(qx - x0, y1 - y0, -((qy - y0) * (x1 - x0)))

    area = edge(ax, ay, bx, by, cx_, cy_)
    w0 = edge(bx, by, cx_, cy_, fpx, fpy)
    w1 = edge(cx_, cy_, ax, ay, fpx, fpy)
    w2 = edge(ax, ay, bx, by, fpx, fpy)
    denom = torch.where(area.abs() < 1e-9, torch.ones_like(area), area)
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = (((b0 >= 0) & (b1 >= 0) & (b2 >= 0)) | ((b0 <= 0) & (b1 <= 0) & (b2 <= 0))) \
        & (area.abs() > 1e-9)

    depth = _fma(b2, z[:, 2:3], _fma(b0, z[:, 0:1], b1 * z[:, 1:2]))
    ok = inside & inb & valid_tri[:, None] & (depth > 1e-6)
    depth = torch.where(ok, depth, torch.full_like(depth, float("inf")))

    # a fragment that draws nothing (its depth is inf) scatters to a spill bin past the
    # image, one of _SPILL by its index: JAX sends them all to pixel 0, which changes
    # nothing there, but one shared address serialises the card's atomics
    frag = torch.arange(ok.numel(), device=dev)
    spill = H * W + frag % _SPILL
    flat_idx = torch.where(ok.reshape(-1), (pys * W + pxs).reshape(-1), spill)
    zbuf = torch.full((H * W + _SPILL,), float("inf"), device=dev)
    zbuf.scatter_reduce_(0, flat_idx, depth.reshape(-1), "amin")

    won = ok.reshape(-1) & (depth.reshape(-1) <= zbuf[flat_idx] * (1 + 1e-6))
    last = torch.full((H * W + _SPILL,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, torch.where(won, flat_idx, spill), frag, "amax")
    zbuf, last = zbuf[:H * W], last[:H * W]
    hit = torch.isfinite(zbuf)
    img = torch.where((last >= 0)[:, None], colors[last.clamp(min=0) // (tile * tile)], 0.0)
    return img.reshape(H, W, 3), zbuf.reshape(H, W), hit.reshape(H, W)


def shade_faces(verts_cam: np.ndarray, faces: np.ndarray, light_dir, base_color, ambient,
                face_albedo) -> np.ndarray:
    """[F, 3] flat colours (host, float64): lambertian against a directional
    light in camera space, times the albedo."""
    tri = verts_cam[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    l = np.asarray(light_dir, np.float64)
    l = l / np.linalg.norm(l)
    lam = np.abs(n @ l)
    shade = np.clip(ambient + (1 - ambient) * lam, 0, 1)
    if face_albedo is not None:
        albedo = np.asarray(face_albedo, np.float64)
        assert albedo.shape == (faces.shape[0], 3), albedo.shape
    else:
        albedo = np.broadcast_to(np.asarray(base_color, np.float64), (faces.shape[0], 3))
    return shade[:, None] * albedo


def rasterize_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    c2w: np.ndarray,
    H: int = 512,
    W: int = 512,
    light_dir=(0.0, 0.0, 1.0),
    base_color=(0.75, 0.65, 0.6),
    ambient: float = 0.25,
    tile: int = 24,
    face_albedo: np.ndarray | None = None,
    device="cuda",
):
    """Flat-shaded render on `device`. Returns (rgb [H,W,3] float, depth
    [H,W], mask), numpy, as the JAX package does.

    Shading: lambertian against a headlight-style directional light in
    CAMERA space (matches the reference's directional-light flat shading,
    render.py:56-62). `face_albedo` [F, 3] overrides the uniform
    `base_color` with a per-face albedo (textured meshes, e.g. the
    synthetic face family in datagen/synthetic_faces.py)."""
    dev = resolve_device(device)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int32)
    R = np.asarray(c2w)[:3, :3]
    t = np.asarray(c2w)[:3, 3]
    verts_cam = (verts - t) @ R  # world -> camera
    colors = shade_faces(verts_cam, faces, light_dir, base_color, ambient, face_albedo)

    img, depth, mask = rasterize_fragments(
        torch.from_numpy(verts_cam.astype(np.float32)).to(dev),
        torch.from_numpy(faces.astype(np.int64)).to(dev),
        torch.from_numpy(colors.astype(np.float32)).to(dev),
        float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]),
        H, W, tile,
    )
    return img.cpu().numpy(), depth.cpu().numpy(), mask.cpu().numpy()
