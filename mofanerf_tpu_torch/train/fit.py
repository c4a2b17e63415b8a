"""Inverse rendering: fit latent codes, camera pose and light to one photo
(counterpart of mofanerf_tpu/train/fit.py).

What is optimised, as in the reference's fitting script (run_fit.py:134-350):
{shape 50, texture 256, expression 30, camera pose 4x4, global light scale 2}
against one preprocessed 512x512 photo, with
- three Adam groups (light + pose and texture at `lr`, expression + shape at
  `lr_shape`), each on the staged decay `lr * (1/1.1)^(count // (iters/6))`
  overridden to 5e-4 past count 1500 (run_fit.py:25-32, 217-219);
- an L1 loss with a learned global light scale (run_fit.py:309);
- the pose frozen for its first `pose_freeze_iters` steps and retracted onto
  SO(3) after every update.

Only the codes are differentiated: the model's weights take no gradient, so
autograd computes no weight-gradient products (JAX's `value_and_grad` over
the codes prunes them the same way). The render is `render_rays(autograd=
True)` through `apply_field_folded`, as JAX differentiates its XLA field and
not the Pallas kernel; rays come from `get_rays_at` at the sampled pixels, so
every pyramid level runs the same [n_rand] step. The texture encoder is
bypassed: `tex` is optimised directly. Nothing in a step is read back to the
host: the learning rates come from the groups' counts on the device, and the
pose freeze multiplies the pose's gradient by a device flag.

Full-frame renders with the fitted codes (`render_fit_frame`) go through
`render_frame`, so both fields run the fused field kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from mofanerf_tpu_torch.ops.rays import get_rays_at
from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, prepare_conditioning, render_frame,
                                                render_rays)
from mofanerf_tpu_torch.train.state import Adam, AdamState
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device

Params = Dict[str, Any]

# Newton steps of the polar projection: from a block whose singular values lie
# in [0.1, 10] the iteration reaches f32's last bit in 8 (sigma <- (sigma + 1 /
# sigma) / 2 converges quadratically once within 2x of 1); a fit's pose moves
# by an Adam step (~1e-3) between projections and converges in 2
POLAR_ITERS = 10


class FitCodes(NamedTuple):
    shape: torch.Tensor   # [50]
    tex: torch.Tensor     # [256]
    exp: torch.Tensor     # [30]
    pose: torch.Tensor    # [4, 4] c2w (differentiable)
    light: torch.Tensor   # [2] — only light[0] used (run_fit.py:309)


class FitState(NamedTuple):
    codes: FitCodes
    opt_state: Dict[str, AdamState]   # one a group of FIT_GROUPS
    step: torch.Tensor                # int32 scalar


@dataclasses.dataclass(frozen=True)
class FitConfig:
    n_iters: int = 2000
    n_rand: int = 1024
    lr: float = 2e-3          # light+pose and texture groups
    lr_shape: float = 4e-3    # expression+shape group
    decreased_by: float = 1.1
    H: int = 512
    W: int = 512
    focal: float = 1200.0
    change_epoch: tuple = (0, 600, 1000, 1300, 1500)
    ckpt_every: int = 100
    preview_every: int = 500
    # the pose stays frozen for the first `pose_freeze_iters` steps so that the
    # codes first explain the image at the initial pose; co-optimising from step
    # 0 lets the codes absorb the initial pose error while the rotation drifts
    pose_freeze_iters: int = 0


# the optimiser's groups: name -> the codes it updates (optax.multi_transform's labels)
FIT_GROUPS = {"pose_light": ("light", "pose"), "tex": ("tex",), "shape_exp": ("exp", "shape")}


def fit_lr_schedule(base_lr: float, n_iters: int, decreased_by: float = 1.1):
    """run_fit.py:25-32: the staged decay `base_lr * (1/decreased_by)^floor(
    count / floor(n_iters / 6))`, 5e-4 past count 1500; f32 on the count's
    device."""
    adjust_every = max(1, int(n_iters / 6))

    def sched(count) -> torch.Tensor:
        step = torch.as_tensor(count).to(torch.float32)
        lr = base_lr * (1.0 / decreased_by) ** torch.floor(step / adjust_every)
        return torch.where(step > 1500, torch.full_like(lr, 5e-4), lr)

    return sched


@dataclasses.dataclass(frozen=True)
class StagedAdam(Adam):
    """Adam (optax.adam's arithmetic) on `fit_lr_schedule`, evaluated at the
    group's count before the update."""

    n_iters: int = 2000
    decreased_by: float = 1.1

    def rate(self, count: torch.Tensor):
        return fit_lr_schedule(self.lrate, self.n_iters, self.decreased_by)(count)


@dataclasses.dataclass(frozen=True)
class FitOptimizer:
    """optax.multi_transform over one StagedAdam a group of FIT_GROUPS. Every
    group counts every step: while the pose is frozen its gradient is 0, and
    its group's count and moments still advance."""

    pose_light: StagedAdam
    tex: StagedAdam
    shape_exp: StagedAdam

    def init(self, codes: FitCodes) -> Dict[str, AdamState]:
        return {g: getattr(self, g).init({n: getattr(codes, n) for n in names})
                for g, names in FIT_GROUPS.items()}

    def update(self, grads: FitCodes, opt_state: Dict[str, AdamState], codes: FitCodes):
        """(new codes, new opt_state)."""
        new, opt = {}, {}
        for g, names in FIT_GROUPS.items():   # names sorted: the state's leaf order
            st = opt_state[g]
            params, mu, nu, count = getattr(self, g).update(
                [getattr(grads, n) for n in names], st, [getattr(codes, n) for n in names])
            new.update(zip(names, params))
            opt[g] = AdamState(count, dict(zip(names, mu)), dict(zip(names, nu)))
        return FitCodes(**new), opt


def make_fit_optimizer(cfg: FitConfig) -> FitOptimizer:
    staged = lambda lr: StagedAdam(lrate=lr, lrate_decay=None, n_iters=cfg.n_iters,
                                   decreased_by=cfg.decreased_by)
    return FitOptimizer(pose_light=staged(cfg.lr), tex=staged(cfg.lr),
                        shape_exp=staged(cfg.lr_shape))


def init_fit_codes(
    generator: torch.Generator,
    pose_init,
    shape_stats: Optional[tuple] = None,   # (mu [50], std [50])
    tex_stats: Optional[tuple] = None,     # (mu [256], std [256])
    exp_init: Optional[torch.Tensor] = None,
    device="cuda",
) -> FitCodes:
    """Random codes from the texShpDistribution statistics (the reference's
    randSp / randTex, tools/wild_fit_base.py:21-45), drawn from a CPU
    generator (the same codes on every device) and moved to `device`; the
    expression starts from `exp_init` (the neutral latent, run_fit.py:205),
    else zeros; light 1."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    shape = torch.randn(50, generator=generator, dtype=torch.float32)
    tex = torch.randn(256, generator=generator, dtype=torch.float32)
    shape = f32(shape_stats[0]) + f32(shape_stats[1]) * shape if shape_stats else shape * 0.1
    tex = f32(tex_stats[0]) + f32(tex_stats[1]) * tex if tex_stats else tex * 0.1
    exp = (torch.zeros(30) if exp_init is None
           else torch.as_tensor(exp_init, dtype=torch.float32).cpu())
    return FitCodes(shape=shape.reshape(50).to(dev), tex=tex.reshape(256).to(dev),
                    exp=exp.reshape(30).to(dev), pose=f32(pose_init).reshape(4, 4).to(dev),
                    light=torch.ones(2, device=dev))


def fit_state_from_codes(codes: FitCodes, cfg: FitConfig) -> FitState:
    """A fit's starting state from its initial codes: fresh moments, step 0."""
    step = torch.zeros((), dtype=torch.int32, device=codes.pose.device)
    return FitState(codes, make_fit_optimizer(cfg).init(codes), step)


def init_fit_state(generator: torch.Generator, cfg: FitConfig, pose_init,
                   shape_stats: Optional[tuple] = None, tex_stats: Optional[tuple] = None,
                   exp_init: Optional[torch.Tensor] = None, device="cuda") -> FitState:
    return fit_state_from_codes(
        init_fit_codes(generator, pose_init, shape_stats, tex_stats, exp_init, device), cfg)


def load_code_stats(path: str):
    """texShpDistribution.npy -> ((shape_mu, shape_std), (tex_mu, tex_std))."""
    d = np.load(path, allow_pickle=True).item()
    return (
        (d["shape_mean"].reshape(-1), d["shape_std"].reshape(-1)),
        (d["texture_mean"].reshape(-1), d["texture_std"].reshape(-1)),
    )


def project_pose_so3(pose: torch.Tensor) -> torch.Tensor:
    """Retract a 4x4 c2w onto the rigid motions: the rotation block to its
    orthogonal polar factor, the nearest element of SO(3) for a block of
    positive determinant (every block a fit reaches: it starts on SO(3) and
    moves by Adam steps), the bottom row pinned to [0, 0, 0, 1].

    The polar factor comes from POLAR_ITERS Newton steps R <- (R + R^-T) / 2,
    R^-T = cof(R) / det(R) with the cofactor columns as cross products of R's
    columns: a few small kernels on the device, with none of the host
    synchronisation of `torch.linalg.svd` / `det` on a CUDA tensor. It is not
    differentiated (it runs after the update)."""
    R = pose[:3, :3]
    for _ in range(POLAR_ITERS):
        # columns r1 x r2, r2 x r0, r0 x r1: det(R) R^-T
        cof = torch.linalg.cross(R.roll(-1, dims=1), R.roll(-2, dims=1), dim=0)
        det = (R[:, 0] * cof[:, 0]).sum()
        R = 0.5 * (R + cof / det)
    bottom = torch.zeros((1, 4), dtype=pose.dtype, device=pose.device)
    bottom[:, 3:].fill_(1.0)   # a fill on the device: assigning a Python number copies from the host
    return torch.cat([torch.cat([R, pose[:3, 3:]], dim=1), bottom], dim=0)


def fit_loss(model_params: Params, spec: MoFaNeRF, codes: FitCodes, coords: torch.Tensor,
             target_rgb: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """L1 between the lit render at `coords` and the target colours."""
    rays_o, rays_d = get_rays_at(coords, K, codes.pose)
    cond = prepare_conditioning(model_params, spec, codes.shape, codes.exp, codes.tex)
    out = render_rays(model_params, spec, cond, rays_o, rays_d, train=False, autograd=True)
    return torch.mean(torch.abs(codes.light[0] * out["rgb"] - target_rgb))


def fit_step(
    model_params: Params,
    spec: MoFaNeRF,
    tx: FitOptimizer,
    state: FitState,
    coords: torch.Tensor,       # [N, 2] f32 (row, col) at the current pyramid scale
    target_rgb: torch.Tensor,   # [N, 3]
    K: torch.Tensor,            # [3, 3] intrinsics at the current pyramid scale
    pose_freeze_iters: int = 0,
):
    """One fitting step: (new state, loss), both on the device. The model's
    params are constants; the pose's gradient is multiplied by 0 while
    `step < pose_freeze_iters` (its group's count and moments still
    advance), and every updated pose is retracted onto SO(3)
    (project_pose_so3)."""
    live = FitCodes(*[c.detach().requires_grad_(True) for c in state.codes])
    with f32_products():
        loss = fit_loss(model_params, spec, live, coords, target_rgb, K)
        grads = FitCodes(*torch.autograd.grad(loss, live))
    unfrozen = state.step >= pose_freeze_iters
    if pose_freeze_iters > 0:
        grads = grads._replace(pose=grads.pose * unfrozen.to(grads.pose.dtype))
    with torch.no_grad():
        codes, opt = tx.update(grads, state.opt_state, state.codes)
        pose = project_pose_so3(codes.pose)
        if pose_freeze_iters > 0:
            # a frozen pose's update is exactly 0; it is kept bit for bit, not
            # re-projected (which would move its last bits)
            pose = torch.where(unfrozen, pose, state.codes.pose)
    return FitState(codes._replace(pose=pose), opt, state.step + 1), loss.detach()


def render_fit_frame(
    model_params: Params,
    spec: MoFaNeRF,
    codes: FitCodes,
    H: int,
    W: int,
    K,
    apply_light: bool = True,
) -> Dict[str, torch.Tensor]:
    """A full frame with the fitted codes (preview, novel view, modulation
    frame; run_fit.py:332-431) through `render_frame`: both fields through the
    fused field kernel on the card."""
    with torch.no_grad():
        cond = prepare_conditioning(model_params, spec, codes.shape, codes.exp, codes.tex)
        out = render_frame(model_params, spec, cond, H, W, K, codes.pose[:3])
        if apply_light:
            out = dict(out)
            out["rgb"] = codes.light[0] * out["rgb"]
    return out
