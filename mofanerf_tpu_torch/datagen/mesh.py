"""Minimal mesh IO + alignment ops (host-side NumPy; a copy of
mofanerf_tpu/datagen/mesh.py).

Capability parity with tools/train_data_pre/align_clip.py:7-89, which uses
trimesh (absent here): load a scan OBJ, apply the per-(id, exp) scale+Rt
aligning it to the TU bilinear-model frame, delete faces beyond a
per-identity radius, export OBJ.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse v/f lines -> (verts [V,3] f64, faces [F,3] int32, 0-based).
    Polygons are fan-triangulated; texture/normal indices are ignored."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def apply_rt_scale(verts: np.ndarray, scale: float, Rt: np.ndarray) -> np.ndarray:
    """Align scan to the model frame: X' = (R @ (s * X) + t)
    (align_clip.py's per-(id, exp) transform from Rt_scale_dict.json)."""
    Rt = np.asarray(Rt, np.float64)
    return (scale * verts) @ Rt[:3, :3].T + Rt[:3, 3]


def clip_faces_by_distance(
    verts: np.ndarray,
    faces: np.ndarray,
    max_distance: float,
    center: np.ndarray | None = None,
) -> np.ndarray:
    """Drop faces with any vertex beyond `max_distance` from `center`
    (align_clip.py:7-28 `deleteFace` behavior). Returns filtered faces."""
    c = np.zeros(3) if center is None else np.asarray(center)
    d = np.linalg.norm(verts - c, axis=1)
    keep = (d[faces] <= max_distance).all(axis=1)
    return faces[keep]
