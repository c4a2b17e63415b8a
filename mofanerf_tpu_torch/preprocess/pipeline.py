"""4-stage wild-photo preprocessing pipeline.

The port of mofanerf_tpu/preprocess/pipeline.py. Capability parity with
tools/wildData_preprocess.py:38-142: for every photo in a directory,
  ALIGN   -> detect landmarks, similarity-warp to the canonical 512 frame,
             estimate camera pose, write raw/<name>.png + pose_<name>.npy
             ({pose 4x4, kp 68x2}) consumed by run_fit (run_fit.py:102-113)
  MASK    -> BiSeNet face parsing -> mask/<name>.png
  SEGMENT -> zero background/clothes + row cutoff -> segRes/<name>.png
  RELIGHT -> Hourglass relight to canonical SH -> segRelRes/<name>.png

Stages degrade as in the JAX package when their weights are not given:
MASK falls back to the landmark convex hull, RELIGHT to a pass-through copy,
each fallback logged. The warp, the two networks and the Lab conversions run
on `device`; reading, landmarks, the pose fit and writing are the host's.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.preprocess.align import (
    CANONICAL_LANDMARKS_512,
    align_to_template,
    get_landmark_source,
)
from mofanerf_tpu_torch.preprocess.matting import apply_mask, hull_mask
from mofanerf_tpu_torch.preprocess.pose import estimate_pose_from_kp
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.image_io import imread, resize_linear, write_png

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
ROW_CUT = 450   # rows at and below are zeroed (tools/wildData_preprocess.py:110-113)


def _to8(img: torch.Tensor) -> np.ndarray:
    """(clip(img, 0, 1) * 255).astype(uint8) on the host: truncation, as the
    JAX package writes."""
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def preprocess_dir(
    file_path: str,
    landmarks_3d: Optional[np.ndarray] = None,   # [68, 3] template (id 1 neutral / 50)
    kp_dir: Optional[str] = None,
    dlib_predictor: Optional[str] = None,
    bisenet_variables=None,
    relight_variables=None,
    canonical_sh: Optional[np.ndarray] = None,
    stages=("align", "mask", "segment", "relight"),
    focal: float = 1200.0,
    device="cuda",
) -> None:
    """Preprocess every photo of `file_path`. `bisenet_variables` and
    `relight_variables` are the port's parameters, as the converters give
    them."""
    from mofanerf_tpu_torch.preprocess.relight import load_hourglass
    from mofanerf_tpu_torch.preprocess.segment import (face_mask_from_parsing, load_bisenet,
                                                       segment_face)

    dev = resolve_device(device)
    to_dev = lambda state: {k: v.to(dev) for k, v in state.items()}
    seg_net = None if bisenet_variables is None else load_bisenet(to_dev(bisenet_variables))
    relight_net = None if relight_variables is None \
        else load_hourglass(to_dev(relight_variables))
    out_raw = os.path.join(file_path, "raw")
    out_mask = os.path.join(file_path, "mask")
    out_seg = os.path.join(file_path, "segRes")
    out_rel = os.path.join(file_path, "segRelRes")
    for d in (out_raw, out_mask, out_seg, out_rel):
        os.makedirs(d, exist_ok=True)

    src = get_landmark_source(kp_dir or file_path, dlib_predictor)
    names = [
        f for f in sorted(os.listdir(file_path))
        if f.lower().endswith(IMG_EXTS) and os.path.isfile(os.path.join(file_path, f))
    ]

    for fname in names:
        name = os.path.splitext(fname)[0]
        img = imread(os.path.join(file_path, fname)).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3]

        # ---- ALIGN
        kp = src.detect(img, name) if src else None
        if kp is None:
            print(f"[{name}] no landmarks available; center-crop fallback "
                  f"(provide kp_{name}.npy or a dlib predictor for quality)")
            s = min(img.shape[:2])
            y0 = (img.shape[0] - s) // 2
            x0 = (img.shape[1] - s) // 2
            aligned = torch.from_numpy(
                resize_linear(img[y0:y0 + s, x0:x0 + s], (512, 512))).to(dev)
            kp_aligned = CANONICAL_LANDMARKS_512.copy()
        else:
            aligned, kp_aligned = align_to_template(torch.from_numpy(img).to(dev), kp)

        if landmarks_3d is not None:
            pose, residual = estimate_pose_from_kp(kp_aligned, landmarks_3d, focal)
        else:
            # frontal default at the canonical distance (focal/scale of the
            # FaceScape rig) when no 3D template is available
            pose, residual = pose_spherical(0.0, 0.0, 16.0), float("nan")
        if "align" in stages:
            write_png(os.path.join(out_raw, f"{name}.png"), _to8(aligned))
            # kp stored (row, col) as run_fit's LMModule expects
            np.save(os.path.join(file_path, f"pose_{name}.npy"),
                    {"pose": pose.astype(np.float32),
                     "kp": kp_aligned[:, ::-1].astype(np.float32)})

        # ---- MASK (always computed — SEGMENT/RELIGHT depend on it)
        if seg_net is not None:
            mask = face_mask_from_parsing(segment_face(aligned, seg_net))
        else:
            print(f"[{name}] BiSeNet weights unavailable; convex-hull mask fallback")
            mask = hull_mask(aligned.shape, kp_aligned)
        if "mask" in stages:
            write_png(os.path.join(out_mask, f"{name}.png"), mask * np.uint8(255))

        # ---- SEGMENT (always computed — RELIGHT consumes it)
        seg = apply_mask(aligned, torch.from_numpy(mask).to(dev))
        seg[ROW_CUT:, :] = 0
        if "segment" in stages:
            write_png(os.path.join(out_seg, f"{name}.png"), _to8(seg))

        # ---- RELIGHT
        if "relight" in stages:
            if relight_net is not None and canonical_sh is not None:
                from mofanerf_tpu_torch.preprocess.relight import relight_to_canonical

                relit, _ = relight_to_canonical(seg, relight_net, canonical_sh)
            else:
                print(f"[{name}] relight weights unavailable; pass-through")
                relit = seg
            write_png(os.path.join(out_rel, f"{name}.png"), _to8(relit))
        print(f"[{name}] done (pose residual {residual:.2f})")
