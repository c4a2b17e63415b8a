"""Camera-pose estimation from 2D landmarks.

Capability parity with the reference `pose_estimate`
(tools/wild_fit_base.py:167-343): fit an orthographic camera (scale,
translation, rotation) mapping the template's 3D landmarks onto detected
2D keypoints — alternating a closed-form scale/translation solve with a
Levenberg-Marquardt refinement over (scale, trans, rot_vec) — then convert
to a perspective c2w matrix with focal 1200 and depth = focal / scale.

Pure NumPy + SciPy on the host (pose fitting is 68 points): a copy of
mofanerf_tpu/preprocess/pose.py.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle [3] -> rotation matrix [3, 3]."""
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _project_ortho(lm3d, scale, trans, rot):
    """Orthographic projection: x' = s * (R @ X)[:2] + t (y flipped to
    image convention)."""
    p = (rot @ lm3d.T).T
    xy = p[:, :2] * np.array([1.0, -1.0])
    return scale * xy + trans


def fit_pose_orthographic(
    kp2d_xy: np.ndarray,
    lm3d: np.ndarray,
    n_rounds: int = 4,
):
    """kp2d_xy: [68, 2] detected (x, y); lm3d: [68, 3] template landmarks in
    model units. Returns (scale, trans [2], rot [3,3], residual)."""
    kp2d = np.asarray(kp2d_xy, np.float64)
    lm3d = np.asarray(lm3d, np.float64)
    rvec = np.zeros(3)
    rot = np.eye(3)
    scale, trans = 1.0, np.zeros(2)

    for _ in range(n_rounds):
        # closed-form scale/translation given rotation
        proj = _project_ortho(lm3d, 1.0, np.zeros(2), rot)
        pc = proj - proj.mean(0)
        kc = kp2d - kp2d.mean(0)
        denom = (pc ** 2).sum()
        scale = float((pc * kc).sum() / max(denom, 1e-12))
        trans = kp2d.mean(0) - scale * proj.mean(0)

        # LM refinement over (scale, trans, rvec)
        def resid(p):
            s, tx, ty = p[0], p[1], p[2]
            r = rodrigues(p[3:6])
            return (_project_ortho(lm3d, s, np.array([tx, ty]), r) - kp2d).ravel()

        x0 = np.concatenate([[scale], trans, rvec])
        sol = least_squares(resid, x0, method="lm", max_nfev=200)
        scale, trans, rvec = sol.x[0], sol.x[1:3], sol.x[3:6]
        rot = rodrigues(rvec)

    residual = float(np.sqrt(np.mean(sol.fun ** 2)))
    return scale, trans, rot, residual


def pose_to_c2w(
    scale: float,
    trans: np.ndarray,
    rot: np.ndarray,
    focal: float = 1200.0,
    img_size: int = 512,
) -> np.ndarray:
    """Orthographic fit -> perspective c2w [4, 4].

    The camera sits at distance depth = focal / scale along the rotated
    optical axis, offset so the orthographic image translation is
    reproduced at that depth (tools/wild_fit_base.py:223-289 behavior)."""
    depth = focal / max(scale, 1e-9)
    cx = cy = img_size / 2
    # Derivation: with X_c = rot @ X + t_c and the get_rays pixel model
    # u = cx + f*X_c.x/(-X_c.z), v = cy - f*X_c.y/(-X_c.z), choosing
    # t_c = [(t_x-cx)/s, -(t_y-cy)/s, -f/s] reproduces the orthographic
    # fit u = s*(rot@X).x + t_x, v = -s*(rot@X).y + t_y to first order in
    # object depth — no extra axis flips needed.
    t_c = np.array([
        (trans[0] - cx) / scale,
        -(trans[1] - cy) / scale,
        -depth,
    ])
    R_c2w = rot.T
    c2w = np.eye(4)
    c2w[:3, :3] = R_c2w
    c2w[:3, 3] = -R_c2w @ t_c
    return c2w


def estimate_pose_from_kp(
    kp2d_xy: np.ndarray,
    lm3d: np.ndarray,
    focal: float = 1200.0,
    img_size: int = 512,
):
    """End-to-end: detected landmarks -> (c2w [4,4], residual)."""
    scale, trans, rot, residual = fit_pose_orthographic(kp2d_xy, lm3d)
    return pose_to_c2w(scale, trans, rot, focal, img_size), residual
