"""Writes a training split in the FaceScape layout that the program's
loader reads (`data/facescape.py`): per identity `transforms_{train,val,test}_<id>.json`
with each frame's pose and expression, the frames as 8-bit RGB PNGs, one UV
map per identity, the identity codes and the landmarks. Everything comes
from numpy under the seed. The PNG rows all carry the Sub filter."""
from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np

from benchmark.common import draw_poses


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit RGB PNG, every row filtered with Sub (filter type 1)."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int16)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]
    raw = np.concatenate([np.ones((h, 1), np.uint8), (sub % 256).astype(np.uint8)], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def smooth_images(g: np.random.Generator, n: int, size: int, cell: int = 16) -> np.ndarray:
    """n [size, size, 3] uint8 images of random colour blocks `cell` pixels wide."""
    base = g.integers(0, 256, (n, size // cell, size // cell, 3), dtype=np.uint8)
    return base.repeat(cell, 1).repeat(cell, 2)


def write_split(root: str, g: np.random.Generator, n_ids: int, n_exps: int, n_views: int,
                size: int, focal: float, camera: dict, uv_size: int, shape_dim: int) -> dict:
    """Write the split under `root`; return what the reference reads of it:
    images [N, H, W, 3] uint8 in the loader's order, poses [N, 4, 4] f32,
    per-frame identity, expression and UV index, shape codes [n_ids, dim],
    UV maps [n_ids, S, S, 3] uint8, landmarks [n_ids, 20, 68, 3] f32 and the
    UV map paths."""
    os.makedirs(root, exist_ok=True)
    expressions = np.sort(g.choice(20, n_exps, replace=False))
    shape_codes = g.standard_normal((n_ids, shape_dim)).astype(np.float32)
    uv = smooth_images(g, n_ids, uv_size)
    landmarks = np.concatenate([g.uniform(-3, 3, (n_ids, 20, 68, 2)),
                                g.uniform(0, 4, (n_ids, 20, 68, 1))], -1).astype(np.float32)
    n_per = n_exps * n_views
    images = smooth_images(g, n_ids * n_per, size)
    poses = draw_poses(g, camera, n_ids * n_per)
    angle = 2 * math.atan(0.5 * size / focal)
    uv_paths, ids, exps = {}, [], []
    for pid in range(n_ids):
        os.makedirs(os.path.join(root, str(pid)), exist_ok=True)
        uv_paths[pid] = os.path.join(root, str(pid), "uv.png")
        write_png(uv_paths[pid], uv[pid])
        frames = []
        for k in range(n_per):
            j = pid * n_per + k
            rel = f"{pid}/train_{k:03d}"
            write_png(os.path.join(root, rel + ".png"), images[j])
            frames.append({"file_path": rel, "transform_matrix": poses[j].tolist(),
                           "expression": int(expressions[k // n_views])})
            ids.append(pid)
            exps.append(int(expressions[k // n_views]))
        for split, fr in (("train", frames), ("val", []), ("test", [])):
            with open(os.path.join(root, f"transforms_{split}_{pid}.json"), "w") as f:
                json.dump({"camera_angle_x": angle, "frames": fr}, f)
    return {"images": images, "poses": poses, "ids": np.asarray(ids),
            "exp_types": np.asarray(exps), "shape_codes": shape_codes, "uv_maps": uv,
            "landmarks": landmarks, "uv_paths": uv_paths, "camera_angle_x": angle}
