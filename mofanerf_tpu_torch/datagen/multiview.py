"""Multiview training-data production (the port of
mofanerf_tpu/datagen/multiview.py; frames rasterized on `device`, written as
RGBA PNGs by the port's writer).

Capability parity with tools/train_data_pre/render.py:130-279: a 6-elevation
x 20-azimuth camera grid (120 views per expression), 20 random views held
out as test/val, per-identity `transforms_{train,val,test,all}_{id}.json`
in Blender-NeRF format with an `expression` index per frame, and a
multiprocessing fan-out across identities. Rendering uses the software
rasterizer (datagen/rasterize.py) instead of pyrender/OpenGL.

Camera intrinsics: K = [[1200,0,256],[0,1200,256],[0,0,1]] at 512x512
(render.py:148-157); world scale 1/50 with orbit radius 16.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.image_io import write_png

FOCAL = 1200.0
RES = 512
RADIUS = 16.0  # 800 / 50 world units

ELEVATIONS = list(range(-30, 46, 15))          # 6 elevations
AZIMUTHS = list(range(-90, 90, 9))             # 20 azimuths


def camera_grid() -> List[np.ndarray]:
    """120 c2w poses (render.py:130-140 `generate_Rt_fix_view`)."""
    return [
        pose_spherical(float(az), float(el), RADIUS)
        for el in ELEVATIONS
        for az in AZIMUTHS
    ]


def camera_angle_x(width: int = RES, focal: float = FOCAL) -> float:
    return float(2 * np.arctan(0.5 * width / focal))


def write_transforms_json(
    out_dir: str,
    pid: int,
    frames_by_split: Dict[str, List[dict]],
) -> None:
    all_frames = []
    for split, frames in frames_by_split.items():
        meta = {"camera_angle_x": camera_angle_x(), "frames": frames}
        with open(os.path.join(out_dir, f"transforms_{split}_{pid}.json"), "w") as f:
            json.dump(meta, f)
        all_frames.extend(frames)
    with open(os.path.join(out_dir, f"transforms_all_{pid}.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x(), "frames": all_frames}, f)


def render_identity(
    pid: int,
    meshes_by_exp: Dict[int, tuple],   # exp -> (verts, faces[, face_albedo])
    out_dir: str,
    n_holdout: int = 20,
    seed: int = 0,
    res: int = RES,
    view_stride: int = 1,
    device="cuda",
) -> None:
    """Render all expressions of one identity on `device` and write split
    JSONs. Resumable: skips when the identity's train JSON already exists.
    `view_stride` subsamples the 120-view camera grid (every k-th view) for
    cheaper synthetic studies."""
    dev = resolve_device(device)
    if os.path.exists(os.path.join(out_dir, f"transforms_train_{pid}.json")):
        print(f"skip existing id {pid}")
        return
    from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh

    os.makedirs(os.path.join(out_dir, str(pid)), exist_ok=True)
    rng = np.random.default_rng(seed + pid)
    K = np.array([[FOCAL * res / RES, 0, res / 2],
                  [0, FOCAL * res / RES, res / 2], [0, 0, 1]])
    poses = camera_grid()[:: max(1, view_stride)]
    frames: Dict[str, List[dict]] = {"train": [], "val": [], "test": []}

    for exp, mesh in sorted(meshes_by_exp.items()):
        verts, faces = mesh[0], mesh[1]
        albedo = mesh[2] if len(mesh) > 2 else None
        holdout = set(rng.choice(len(poses), size=min(n_holdout, len(poses)),
                                 replace=False).tolist())
        val_set = set(list(holdout)[: len(holdout) // 2])
        for vi, c2w in enumerate(poses):
            rgb, _, mask = rasterize_mesh(verts, faces, K, c2w, res, res,
                                          face_albedo=albedo, device=dev)
            rel = f"{pid}/{exp}_{vi:03d}"
            rgba = np.concatenate([rgb, mask[..., None].astype(np.float32)], axis=-1)
            write_png(os.path.join(out_dir, rel + ".png"),
                      (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            split = ("val" if vi in val_set else "test") if vi in holdout else "train"
            frames[split].append(
                {
                    "file_path": rel,
                    "transform_matrix": np.asarray(c2w).tolist(),
                    "expression": int(exp),
                }
            )
    write_transforms_json(out_dir, pid, frames)
    print(f"rendered id {pid}: {sum(len(v) for v in frames.values())} frames")


def render_identities_parallel(
    ids: Sequence[int],
    mesh_loader,           # pid -> {exp: (verts, faces)}
    out_dir: str,
    n_workers: int = 1,
    **kwargs,
) -> None:
    """Process fan-out over identities (render.py:248-255); `spawn` workers,
    each of which takes the device named in `kwargs` (the card by default)."""
    os.makedirs(out_dir, exist_ok=True)
    if n_workers <= 1:
        for pid in ids:
            render_identity(pid, mesh_loader(pid), out_dir, **kwargs)
        return
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(n_workers) as pool:
        pool.starmap(
            _render_one, [(pid, mesh_loader, out_dir, kwargs) for pid in ids]
        )


def _render_one(pid, mesh_loader, out_dir, kwargs):
    render_identity(pid, mesh_loader(pid), out_dir, **kwargs)
