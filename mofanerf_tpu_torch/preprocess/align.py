"""Face alignment to the canonical MoFaNeRF 512x512 frame (the port of
mofanerf_tpu/preprocess/align.py; the warp runs on the image's device).

Capability parity with the reference's ALIGN stage
(tools/wild_fit_base.py:59-164 + tools/wildData_preprocess.py:70-91):
detect 68 landmarks, estimate a similarity transform to the canonical
landmark template, warp to 512x512.

The landmark DETECTOR is pluggable: the reference hard-requires dlib +
its 68-landmark .dat (both absent in this environment and git-LFS-missing
in the reference checkout). Sources, in preference order:
  1. DlibLandmarkSource — used when dlib and its predictor are available,
  2. PrecomputedLandmarkSource — reads `kp_<name>.npy` next to the photo
     (68x2, (row, col)), produced by any external detector,
  3. None — the pipeline then center-crops and assumes the template
     layout (explicitly logged as low-quality).
"""
from __future__ import annotations

import os
from typing import Optional, Protocol

import numpy as np
import torch

from mofanerf_tpu_torch.utils.image_io import warp_affine

# Canonical 68-landmark template at 512x512, (x, y) order — the target
# layout FaceScape-trained MoFaNeRF expects after alignment (calibration
# data from the reference's `glob_neutral_tmp_LM`, tools/wild_fit_base.py:9-19;
# required verbatim for domain compatibility with pretrained checkpoints).
CANONICAL_LANDMARKS_512 = np.array([
    [143, 214], [146, 244], [151, 273], [158, 302], [168, 328], [184, 352],
    [205, 371], [229, 386], [259, 390], [287, 385], [311, 371], [331, 352],
    [347, 329], [356, 303], [364, 274], [368, 245], [370, 214], [163, 186],
    [177, 172], [197, 168], [218, 173], [236, 182], [276, 180], [296, 168],
    [317, 163], [339, 167], [352, 184], [257, 206], [257, 226], [257, 246],
    [257, 267], [237, 286], [248, 288], [258, 289], [268, 288], [278, 285],
    [183, 210], [195, 203], [210, 204], [223, 215], [209, 217], [194, 217],
    [290, 213], [303, 203], [318, 201], [330, 207], [320, 214], [305, 215],
    [219, 328], [234, 320], [249, 314], [258, 317], [268, 314], [281, 320],
    [295, 328], [282, 338], [269, 342], [258, 343], [248, 343], [234, 339],
    [226, 328], [248, 326], [258, 327], [268, 326], [289, 328], [268, 327],
    [258, 328], [248, 327],
], dtype=np.float64)


def procrustes_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (scale+rotation+translation)
    mapping src -> dst points. Returns a [2, 3] affine matrix.

    Umeyama closed form — an independent derivation of what the reference's
    `transformation_from_points` computes."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, d])
    R = U @ D @ Vt
    var_s = (sc ** 2).sum() / src.shape[0]
    scale = (S * np.diag(D)).sum() / var_s
    t = mu_d - scale * R @ mu_s
    return np.concatenate([scale * R, t[:, None]], axis=1)


def align_to_template(
    img: torch.Tensor,
    kp_xy: np.ndarray,
    template: np.ndarray = CANONICAL_LANDMARKS_512,
    size: int = 512,
):
    """Warp `img` (a float [H, W, 3] tensor, on any device) so its landmarks
    land on the template.

    kp_xy: [68, 2] (x, y). Returns (aligned image [size,size,3], a tensor on
    img's device; warped landmarks [68, 2] (x, y), numpy)."""
    M = procrustes_similarity(kp_xy, template)
    aligned = warp_affine(img, M, (size, size))
    kp_h = np.concatenate([kp_xy, np.ones((kp_xy.shape[0], 1))], axis=1)
    warped = kp_h @ M.T
    return aligned, warped


class LandmarkSource(Protocol):
    def detect(self, img: np.ndarray, name: str) -> Optional[np.ndarray]:
        """Return [68, 2] (x, y) landmarks or None."""


class DlibLandmarkSource:
    """Reference behavior (tools/wild_fit_base.py:51-57) when dlib + the
    68-landmark predictor are available. `img` is the host float image."""

    def __init__(self, predictor_path: str):
        import dlib  # noqa: F401 — optional dependency

        self._dlib = dlib
        self.detector = dlib.get_frontal_face_detector()
        self.predictor = dlib.shape_predictor(predictor_path)

    def detect(self, img: np.ndarray, name: str) -> Optional[np.ndarray]:
        rects = self.detector((img * 255).astype(np.uint8) if img.dtype != np.uint8 else img, 1)
        if not rects:
            return None
        shape = self.predictor(img, rects[0])
        return np.array([[p.x, p.y] for p in shape.parts()], np.float64)


class PrecomputedLandmarkSource:
    """Reads kp_<name>.npy ([68, 2] (row, col) or (x, y) with `xy_order`)
    from `kp_dir`."""

    def __init__(self, kp_dir: str, xy_order: bool = False):
        self.kp_dir = kp_dir
        self.xy_order = xy_order

    def detect(self, img: np.ndarray, name: str) -> Optional[np.ndarray]:
        path = os.path.join(self.kp_dir, f"kp_{name}.npy")
        if not os.path.exists(path):
            return None
        kp = np.load(path).astype(np.float64)
        if not self.xy_order:  # (row, col) -> (x, y)
            kp = kp[:, ::-1]
        return kp


def get_landmark_source(
    kp_dir: Optional[str] = None,
    dlib_predictor: Optional[str] = None,
) -> Optional[LandmarkSource]:
    if dlib_predictor and os.path.exists(dlib_predictor):
        try:
            return DlibLandmarkSource(dlib_predictor)
        except ImportError:
            pass
    if kp_dir:
        return PrecomputedLandmarkSource(kp_dir)
    return None
