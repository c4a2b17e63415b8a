"""Landmark-biased training ray sampling, host-side numpy (counterpart of
mofanerf_tpu/data/landmarks.py: `anneal_lm_frac`, `project_landmarks`,
`TrainRaySampler`, `FitRaySampler`).

Index selection is data preparation: it stays on the host on an
`np.random.Generator` and produces int32 (row, col) coordinates, drawn in
the JAX package's order so that one seed gives identical coordinates.
Landmarks are projected with the pinhole model of `ops/rays.py` (camera
down -z, y up); out-of-image samples are clipped into the image.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def anneal_lm_frac(i: int, target: float, anneal_iters: int) -> float:
    """Landmark-bias fraction schedule: ramp 0 -> `target` linearly over the
    first `anneal_iters` steps (uniform sampling first teaches the field
    where empty space is)."""
    if anneal_iters <= 0:
        return target
    return target * min(1.0, i / anneal_iters)


def project_landmarks(lm3d: np.ndarray, K: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Project [68, 3] world landmarks into (row, col) pixels."""
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    pc = (lm3d - t) @ R  # world -> camera (R orthonormal)
    # rays: dir_cam = [(i-cx)/fx, -(j-cy)/fy, -1] * s  =>
    # i = cx + fx * x / (-z), j = cy - fy * y / (-z)
    z = -pc[:, 2]
    z = np.where(np.abs(z) < 1e-8, 1e-8, z)
    col = K[0, 2] + K[0, 0] * pc[:, 0] / z
    row = K[1, 2] - K[1, 1] * pc[:, 1] / z
    return np.stack([row, col], axis=-1)


class TrainRaySampler:
    """Training-time sampler over a full image: 3/5 of the rays (by default)
    as Gaussian clouds around the 68 projected landmarks (sigma 2.5% of H),
    the rest uniform; a centre crop during precrop; without landmarks a
    foreground bias on the target image."""

    def __init__(self, landmarks: Optional[np.ndarray], H: int, W: int, lm_frac: float = 0.6):
        """landmarks: [n_ids, n_exps, 68, 3] world-space (already /50), or
        None for sampling without a landmark template."""
        self.landmarks = landmarks
        self.H, self.W = H, W
        self.lm_frac = lm_frac

    def sample(
        self,
        rng: np.random.Generator,
        n: int,
        K: np.ndarray,
        pose: np.ndarray,
        person_id: int,
        exp: int,
        precrop_frac: Optional[float] = None,
        target_img: Optional[np.ndarray] = None,
        lm_frac: Optional[float] = None,
    ) -> np.ndarray:
        """[n, 2] int32 (row, col) coordinates. `lm_frac` overrides the
        constructor's fraction for this call (the anneal schedule)."""
        H, W = self.H, self.W
        frac = self.lm_frac if lm_frac is None else lm_frac
        if precrop_frac:
            dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
            rows = rng.integers(H // 2 - dH, H // 2 + dH, n)
            cols = rng.integers(W // 2 - dW, W // 2 + dW, n)
            return np.stack([rows, cols], -1).astype(np.int32)

        if self.landmarks is None:
            # no landmark template: bias toward the target's foreground pixels
            if target_img is not None:
                fg_r, fg_c = np.nonzero(np.asarray(target_img).sum(-1) > 0.02)
                if fg_r.shape[0] > 0:
                    n_fg = int(n * frac)
                    pick = rng.integers(0, fg_r.shape[0], n_fg)
                    fg = np.stack([fg_r[pick], fg_c[pick]], -1)
                    uni = np.stack(
                        [rng.integers(0, H, n - n_fg), rng.integers(0, W, n - n_fg)], -1
                    )
                    return np.concatenate([fg, uni], 0).astype(np.int32)
            rows = rng.integers(0, H, n)
            cols = rng.integers(0, W, n)
            return np.stack([rows, cols], -1).astype(np.int32)

        lm3d = self.landmarks[person_id, exp]
        lm2d = project_landmarks(lm3d, K, pose)
        per_lm = int(n * frac) // 68
        sigma = H * 0.025
        jitter = rng.standard_normal((68, per_lm, 2)) * sigma
        lm_samples = (lm2d[:, None, :] + jitter).reshape(-1, 2)
        n_uniform = n - lm_samples.shape[0]
        uni = np.stack([rng.integers(0, H, n_uniform), rng.integers(0, W, n_uniform)], -1)
        coords = np.concatenate([lm_samples, uni], axis=0)
        coords[:, 0] = np.clip(coords[:, 0], 0, H - 1)
        coords[:, 1] = np.clip(coords[:, 1], 0, W - 1)
        return coords.astype(np.int32)


class FitRaySampler:
    """Fitting-time sampler around detected 2D keypoints (the reference's
    run_fit.py:35-82): Gaussian clouds around the 68 landmarks, kept where the
    target is not black, plus points along the jaw outline."""

    def __init__(self, kp2d: np.ndarray, H: int = 512):
        """kp2d: [68, 2] (row, col) detected landmarks at full resolution."""
        self.kp2d = np.asarray(kp2d, np.float64)
        self.H = H

    def sample(
        self,
        rng: np.random.Generator,
        n: int,
        scale: int = 1,
        target_img: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """[n, 2] int32 coords at the current pyramid scale (image side =
        H // scale)."""
        lm2d = self.kp2d / scale
        side = self.H // scale
        per_lm = max(1, n * 2 // 68)
        sigma = self.H * 0.025 / scale
        jitter = rng.standard_normal((68, per_lm, 2)) * sigma
        samples = (lm2d[:, None, :] + jitter).reshape(-1, 2)
        samples = np.clip(samples, 0, side - 1).astype(np.int64)

        if target_img is not None:
            mask = target_img.sum(axis=2)
            on_face = mask[samples[:, 0], samples[:, 1]] != 0
            samples = samples[on_face]
            # extra points along the jaw outline (run_fit.py:56-61)
            outline = np.concatenate([lm2d[1:5], lm2d[12:16]], axis=0)
            n_out = max(1, samples.shape[0] // 50 * scale)
            jit = rng.standard_normal((8, n_out, 2)) * sigma
            extra = (outline[:, None, :] + jit).reshape(-1, 2)
            extra = np.clip(extra, 0, side - 1).astype(np.int64)
            samples = np.concatenate([samples, extra], axis=0)

        if samples.shape[0] == 0:
            samples = np.stack(
                [rng.integers(0, side, n), rng.integers(0, side, n)], -1
            )
        if samples.shape[0] < n:
            reps = n // samples.shape[0] + 1
            samples = np.tile(samples, (reps, 1))[:n]
        else:
            samples = samples[rng.choice(samples.shape[0], n, replace=False)]
        return samples.astype(np.int32)
