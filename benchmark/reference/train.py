"""A training step of MoFaNeRF in plain PyTorch and f32: the batch drawn on
the card from a step's seeds, the texture encoder, the ISM, both fields
under autograd, hierarchical sampling, compositing, MSE(fine) + MSE(coarse),
the gradients of every trainable tensor and an Adam update on the schedule
lrate * 0.1^(t / (lrate_decay * 1500)).

The random numbers are those of the training loop's generators: a step i of
a run of seed s draws its batch from a card generator seeded with
3 * b, its render's jitter from one seeded with 3 * b + 1, where
b = (s * 7919 + 13) * 1000003 + i, in the order written below. The
reference draws them again from those seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nerf
from benchmark.reference.precision import Precision


def step_seed(seed: int, i: int, use: int) -> int:
    return 3 * ((seed * 7919 + 13) * 1_000_003 + i) + use


def project_landmarks(lm3d: np.ndarray, K: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """[68, 3] world points -> (row, col) pixels of the pinhole camera that
    looks down its -z axis, in f32."""
    R, t = c2w[:3, :3], c2w[:3, 3]
    pc = (lm3d - t) @ R
    z = -pc[:, 2]
    z = np.where(np.abs(z) < 1e-8, 1e-8, z)
    return np.stack([K[1, 2] - K[1, 1] * pc[:, 1] / z, K[0, 2] + K[0, 0] * pc[:, 0] / z],
                    -1).astype(np.float32)


def batch(data: dict, cfg: dict, seed: int, i: int, device) -> dict:
    """The rays and targets of step i: one frame, then per ray a uniform
    pixel or, with probability lm_frac * min(1, i / lm_frac_anneal_iters)
    (none while i < precrop_iters, when the uniform pixels lie in the
    centre crop), a landmark's pixel jittered by 2.5% of H."""
    n, H, W = cfg["N_rand"], data["H"], data["W"]
    g = torch.Generator(device=device).manual_seed(step_seed(seed, i, 0))
    img = torch.randint(0, data["images"].shape[0], (1,), generator=g, device=device)
    box = torch.rand((n, 2), generator=g, device=device)
    pick = torch.randint(0, data["lm2d"].shape[1], (n,), generator=g, device=device)
    jit = torch.randn((n, 2), generator=g, device=device)
    mask = torch.rand((n,), generator=g, device=device)
    f32 = np.float32
    if i < cfg["precrop_iters"]:
        dH, dW = H // 2 * cfg["precrop_frac"], W // 2 * cfg["precrop_frac"]
        lo_r, hi_r, lo_c, hi_c = (f32(H / 2 - dH), f32(H / 2 + dH), f32(W / 2 - dW),
                                  f32(W / 2 + dW))
        frac = f32(0.0)
    else:
        lo_r, hi_r, lo_c, hi_c = f32(0), f32(H), f32(0), f32(W)
        frac = f32(cfg["lm_frac"]) * np.clip(f32(i) / f32(cfg["lm_frac_anneal_iters"]),
                                             f32(0), f32(1))
    rows = torch.floor(float(lo_r) + box[:, 0] * float(hi_r - lo_r))
    cols = torch.floor(float(lo_c) + box[:, 1] * float(hi_c - lo_c))
    k = int(img)
    lm = data["lm2d"][k][pick] + jit * (0.025 * H)
    use = mask < float(frac)
    rows = torch.floor(torch.clamp(torch.where(use, lm[:, 0], rows), 0, H - 1))
    cols = torch.floor(torch.clamp(torch.where(use, lm[:, 1], cols), 0, W - 1))
    K, c2w = data["K"], data["poses"][k]
    dirs = torch.stack([(cols - K[0, 2]) / K[0, 0], -(rows - K[1, 2]) / K[1, 1],
                        -torch.ones_like(cols)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    target = data["images"][k][rows.long(), cols.long()].float() / 255.0
    g1 = torch.Generator(device=device).manual_seed(step_seed(seed, i, 1))
    strat = torch.rand((n, cfg["N_samples"]), generator=g1, device=device)
    pdf = torch.rand((n, cfg["N_importance"]), generator=g1, device=device)
    return {"rays_o": rays_o, "rays_d": rays_d, "target": target, "frame": k,
            "draws": {"strat": strat, "pdf": pdf}}


def loss_and_grads(params: dict, leaves: list, data: dict, cfg: dict, b: dict,
                   p: Precision, keep: slice | None = None):
    """(loss, gradients of `leaves`, the fine colour's mean square error) of
    one batch (no gradients where `leaves` is None). `keep` takes a share of
    the rays only (a fault the comparison has to catch)."""
    k = b["frame"]
    rows = keep or slice(None)
    fc = nerf.codes(params, data["shape_codes"][k], int(data["exp_types"][k]),
                    data["uv_maps"][int(data["uv_index"][k])], p)
    draws = {name: d[rows] for name, d in b["draws"].items()}
    out = nerf.render_rays(params, cfg, fc, b["rays_o"][rows], b["rays_d"][rows], p, draws,
                           white_bkgd=cfg["white_bkgd"])
    t = b["target"][rows]
    fine = ((out["rgb"] - t) ** 2).mean()
    loss = fine + ((out["rgb0"] - t) ** 2).mean()
    if leaves is None:
        return loss.detach(), None, fine.detach()
    return loss.detach(), torch.autograd.grad(loss, leaves), fine.detach()


def adam(leaves, grads, mu, nu, count: int, cfg: dict, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update of `leaves` in place of new lists; `count` updates
    were made before it."""
    lr = cfg["lrate"] * 0.1 ** (count / (cfg["lrate_decay"] * 1500))
    t = count + 1
    new_p, new_mu, new_nu = [], [], []
    for x, g, m, v in zip(leaves, grads, mu, nu):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        new_p.append(x - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps))
        new_mu.append(m)
        new_nu.append(v)
    return new_p, new_mu, new_nu
