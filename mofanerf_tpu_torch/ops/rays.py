"""Ray generation and camera-path helpers (counterpart of
mofanerf_tpu/ops/rays.py: `get_rays`, `get_rays_at`, `ndc_rays`,
`pose_spherical`).

Convention matches the reference: pixel grid in xy-indexing, camera looks
down -z, y up.
"""
from __future__ import annotations

import numpy as np
import torch


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Pinhole rays for an HxW image.

    K: [3,3] intrinsics; c2w: [3,4] or [4,4] camera-to-world, both f32
    tensors on the device the rays should live on.
    Returns (rays_o, rays_d), each [H, W, 3]."""
    dev = c2w.device
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
        dim=-1,
    )  # [H, W, 3] camera-frame directions
    rays_d = dirs @ c2w[:3, :3].T  # rotate into world frame
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_at(coords_ij: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor):
    """Rays through a set of pixel coordinates: coords_ij [N, 2] (row j,
    col i) as f32. Returns (rays_o [N, 3], rays_d [N, 3]), differentiable in
    c2w. A batch of training rays keeps one static [N] shape this way."""
    j = coords_ij[:, 0]
    i = coords_ij[:, 1]
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)], dim=-1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Shift rays to the near plane and project them to normalised device
    coordinates (the reference's models/model.py:293-310). Unused by the
    FaceScape path (ndc=False) but part of the public surface."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def _trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Spherical orbit camera pose in the FaceScape world frame: (0, 0, r)
    puts the camera frontal at +z looking down -z; theta = azimuth about y,
    phi = elevation about x. Returns a [4,4] c2w numpy matrix."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return c2w
