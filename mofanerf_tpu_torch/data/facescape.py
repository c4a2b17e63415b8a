"""FaceScape multiview dataset loading, host-side (counterpart of
mofanerf_tpu/data/facescape.py).

Per-identity Blender-NeRF JSONs `transforms_{split}_{id}.json` with an
`expression` index per frame, image paths kept lazy (read per training
step), shape codes from `factors_id.npy` [300, 50], one UV texture map per
identity. Images are read by `utils/image_io.py` (PNG frames, JPEG UV maps);
`make_synthetic_dataset` writes a structurally identical tiny fixture.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.utils.image_io import image_size, imread, resize_area, write_jpeg, write_png

# FaceScape's 20 expression names
EXPRESSION_NAMES = [
    "neutral", "smile", "mouth_stretch", "anger", "jaw_left",
    "jaw_right", "jaw_forward", "mouth_left", "mouth_right", "dimpler",
    "chin_raiser", "lip_puckerer", "lip_funneler", "sadness", "lip_roll",
    "grin", "cheek_blowing", "eye_closed", "brow_raiser", "brow_lower",
]


@dataclasses.dataclass
class FacescapeDataset:
    image_paths: List[str]          # lazy: read per step
    poses: np.ndarray               # [N, 4, 4]
    id_codes: np.ndarray            # [N] identity index
    shape_codes: np.ndarray         # [N, 50]
    exp_types: np.ndarray           # [N] expression index 0..19
    render_poses: np.ndarray        # [40, 4, 4] orbit path
    hwf: tuple                      # (H, W, focal)
    i_split: tuple                  # (train_idx, val_idx, test_idx)
    uv_paths: Dict[int, str]        # identity -> UV map path


def load_shape_codes(path: str) -> np.ndarray:
    """factors_id.npy: [300, 50] FaceScape identity factors."""
    return np.load(path)


def load_uv_paths(uvdir: str, person_list: Sequence[int]) -> Dict[int, str]:
    """Identity -> neutral-expression UV texture path."""
    return {int(i): os.path.join(uvdir, f"{i}", "1_neutral.jpg") for i in person_list}


def valid_persons(datadir: str, n: Optional[int] = None) -> List[int]:
    """Identities with a train JSON present, the first `n` of them."""
    out = []
    for name in sorted(os.listdir(datadir)):
        if name.startswith("transforms_train_") and name.endswith(".json"):
            out.append(int(name[len("transforms_train_"):-len(".json")]))
    out = sorted(out)
    return out[:n] if n else out


def load_facescape_data(
    datadir: str,
    person_list: Sequence[int],
    shape_codes: np.ndarray,
    uvdir: Optional[str] = None,
    half_res: bool = False,
    testskip: int = 1,
) -> FacescapeDataset:
    splits = ["train", "val", "test"]
    all_paths, all_poses, all_ids, all_shapes, all_exps = [], [], [], [], []
    counts = [0]
    meta = None
    for s in splits:
        n_split = 0
        for pid in person_list:
            with open(os.path.join(datadir, f"transforms_{s}_{pid}.json")) as fp:
                meta = json.load(fp)
            skip = 1 if (s == "train" or testskip == 0) else testskip
            frames = meta["frames"][::skip]
            for frame in frames:
                all_paths.append(os.path.join(datadir, frame["file_path"] + ".png"))
                all_poses.append(np.asarray(frame["transform_matrix"], np.float32))
                all_ids.append(int(pid))
                all_shapes.append(shape_codes[int(pid)])
                all_exps.append(int(frame.get("expression", 0)))
            n_split += len(frames)
        counts.append(counts[-1] + n_split)
    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(3))

    H, W = image_size(all_paths[0])
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0

    # orbit render path: radius 800/50 = 16 world units
    render_poses = np.stack(
        [pose_spherical(a, 0.0, 800.0 / 50) for a in np.linspace(-180, 180, 41)[:-1]]
    )

    return FacescapeDataset(
        image_paths=all_paths,
        poses=np.stack(all_poses),
        id_codes=np.asarray(all_ids),
        shape_codes=np.stack(all_shapes).astype(np.float32),
        exp_types=np.asarray(all_exps),
        render_poses=render_poses,
        hwf=(H, W, focal),
        i_split=i_split,
        uv_paths=load_uv_paths(uvdir, person_list) if uvdir else {},
    )


def read_image(
    path: str,
    half_res: bool = False,
    white_bkgd: bool = False,
    is_uvmap: bool = False,
    uv_size: int = 512,
) -> np.ndarray:
    """Read and normalise an image to float32 [0, 1] HxWx3: optional half
    resolution, UV maps resized to `uv_size` (area resize), RGBA composited
    over white when white_bkgd, else its alpha dropped."""
    img = np.asarray(imread(path), np.float32) / 255.0
    H, W = img.shape[:2]
    if half_res:
        img = resize_area(img, (W // 2, H // 2))
    if is_uvmap and img.shape[0] != uv_size:
        img = resize_area(img, (uv_size, uv_size))
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[-1] == 4:
        if white_bkgd:
            img = img[..., :3] * img[..., -1:] + (1.0 - img[..., -1:])
        else:
            img = img[..., :3]
    return img.astype(np.float32)


def make_synthetic_dataset(
    out_dir: str,
    n_ids: int = 2,
    n_train: int = 3,
    n_test: int = 2,
    hw: int = 32,
    seed: int = 0,
) -> Sequence[int]:
    """Write a tiny FaceScape-shaped fixture: per-id transform JSONs, PNG
    frames, JPEG UV maps, shape codes and landmarks, from the same draws as
    the JAX package's fixture of the same seed. Returns the person list."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    uvdir = os.path.join(out_dir, "uv")
    camera_angle_x = 2 * np.arctan(0.5 * hw / (hw * 2.0))  # focal = 2*hw

    person_list = list(range(n_ids))
    for pid in person_list:
        os.makedirs(os.path.join(out_dir, str(pid)), exist_ok=True)
        os.makedirs(os.path.join(uvdir, str(pid)), exist_ok=True)
        uv = (rng.uniform(0, 255, (hw, hw, 3))).astype(np.uint8)
        write_jpeg(os.path.join(uvdir, str(pid), "1_neutral.jpg"), uv)
        counters = {"train": n_train, "val": n_test, "test": n_test}
        k = 0
        for split, n in counters.items():
            frames = []
            for f in range(n):
                img = (rng.uniform(0, 255, (hw, hw, 3))).astype(np.uint8)
                rel = f"{pid}/{split}_{f:03d}"
                write_png(os.path.join(out_dir, rel + ".png"), img)
                pose = pose_spherical(20.0 * k - 40, -10.0, 16.0)
                frames.append(
                    {
                        "file_path": rel,
                        "transform_matrix": pose.tolist(),
                        "expression": int(k % 20),
                    }
                )
                k += 1
            meta = {"camera_angle_x": float(camera_angle_x), "frames": frames}
            with open(os.path.join(out_dir, f"transforms_{split}_{pid}.json"), "w") as fp:
                json.dump(meta, fp)

    np.save(
        os.path.join(out_dir, "factors_id.npy"),
        rng.standard_normal((max(300, n_ids), 50)).astype(np.float32),
    )
    np.save(
        os.path.join(out_dir, "landmarks.npy"),
        rng.uniform(-1, 1, (max(300, n_ids), 20, 68, 3)).astype(np.float32) * 2,
    )
    return person_list
