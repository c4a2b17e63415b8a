"""Host-side fitting loop: pyramid schedule, checkpoints, previews
(counterpart of mofanerf_tpu/train/fit_loop.py).

Drives `fit_step` (train/fit.py) as the reference's `run_fit.train` does
(run_fit.py:134-350), and the two render-only modes:
- "rendering": novel views at yaw -60 / 0 / 60 (run_fit.py:352-377);
- "rendering_modulation": the fitted identity re-rigged with the expression
  bank's ids [9, 14, 2, 16, 17], and shape / texture swaps from preset codes
  (run_fit.py:379-431).

The step has one [n_rand] shape at every pyramid level. Per step the host
samples pixel coordinates (`FitRaySampler`, on a numpy generator), gathers
the target's colours at them and copies both to the card without blocking;
it reads the loss back every 10 steps only. Previews and the render modes go
through `render_fit_frame` (the fused field kernel on the card).

Files: `fit_params.npz` (shape, tex, exp, pose, light, step) is the JAX
package's format, read and written by both. The optimiser's state goes to
`fit_params.npz.opt.pt` (the JAX package pickles optax's state to
`fit_params.npz.opt`, which the port does not read): a resume that finds
only the codes restarts the moments and the learning-rate schedule.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from mofanerf_tpu_torch.data.landmarks import FitRaySampler
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.render.renderer import MoFaNeRF
from mofanerf_tpu_torch.train.fit import (FitCodes, FitConfig, FitState, fit_state_from_codes,
                                          fit_step, init_fit_codes, make_fit_optimizer,
                                          render_fit_frame)
from mofanerf_tpu_torch.train.state import AdamState
from mofanerf_tpu_torch.utils.device import resolve_device, to_device
from mofanerf_tpu_torch.utils.image_io import resize_linear, write_png
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr, tree_unflatten

# Expression ids of the reference's modulation demo (run_fit.py:387)
MODULATION_EXPRESSIONS = [9, 14, 2, 16, 17]
OPT_SUFFIX = ".opt.pt"   # the port's optimiser state beside fit_params.npz


def _opt_tree(opt_state: Dict[str, AdamState]) -> dict:
    return {g: {"count": s.count, "mu": s.mu, "nu": s.nu} for g, s in opt_state.items()}


def save_fit_state(path: str, state: FitState) -> None:
    """The codes and step to `path` (an `.npz`, the JAX package's layout), the
    optimiser's counts and moments to `path + OPT_SUFFIX`: without them a
    resume restarts the staged schedule at the base rate and perturbs the
    converged codes (the reference saves its optimisers too,
    run_fit.py:320-331)."""
    host = {k: v.detach().cpu().numpy() for k, v in state.codes._asdict().items()}
    np.savez(path, step=int(state.step), **host)
    flat = {k: v.detach().cpu() for k, v in flatten_with_keystr(_opt_tree(state.opt_state))}
    tmp = f"{path}{OPT_SUFFIX}.{os.getpid()}.tmp"
    torch.save(flat, tmp)
    os.replace(tmp, str(path) + OPT_SUFFIX)


def load_fit_codes(path: str, device="cuda") -> tuple:
    """(FitCodes on `device`, step) from a `fit_params.npz` of either package."""
    dev = resolve_device(device)
    with np.load(path) as d:
        codes = FitCodes(*[torch.from_numpy(np.asarray(d[k], np.float32)).to(dev)
                           for k in FitCodes._fields])
        return codes, int(d["step"])


def load_fit_opt_state(path: str, like: Dict[str, AdamState]):
    """The optimiser state saved beside `path`, in the structure and on the
    device of `like`; None when there is none (a checkpoint of the JAX
    package, or one written before the moments were saved)."""
    opt_path = str(path) + OPT_SUFFIX
    if not os.path.exists(opt_path):
        return None
    flat = torch.load(opt_path, map_location="cpu", weights_only=True)
    want = flatten_with_keystr(_opt_tree(like))
    if set(flat) != {k for k, _ in want}:
        raise ValueError(f"{opt_path} does not hold a fit's optimiser state")
    tree = tree_unflatten(_opt_tree(like), [flat[k].to(v.device) for k, v in want])
    return {g: AdamState(t["count"], t["mu"], t["nu"]) for g, t in tree.items()}


def _preview_K(cfg: FitConfig) -> np.ndarray:
    """Intrinsics of the half-size frames (previews, novel views, modulation)."""
    H, W = cfg.H // 2, cfg.W // 2
    return np.array([[cfg.focal / 2, 0, 0.5 * W], [0, cfg.focal / 2, 0.5 * H], [0, 0, 1]],
                    np.float32)


def _write_frame(path: str, out: Dict[str, torch.Tensor]) -> np.ndarray:
    rgb = out["rgb"].float().cpu().numpy()
    write_png(path, to8b(rgb))
    return rgb


def fit(
    model_params: Dict[str, Any],
    spec: MoFaNeRF,
    target_img: np.ndarray,        # [H, W, 3] float [0, 1] preprocessed photo
    pose_init: np.ndarray,         # [4, 4] c2w from pose estimation
    kp2d: np.ndarray,              # [68, 2] detected landmarks (row, col)
    out_dir: str,
    cfg: FitConfig = FitConfig(),
    seed: int = 0,
    resume: bool = False,
    exp_init: Optional[torch.Tensor] = None,
    shape_stats=None,
    tex_stats=None,
    init_codes: Optional[FitCodes] = None,
) -> FitState:
    """Fit the codes to `target_img` on the params' device. The initial codes
    are drawn from a CPU generator seeded with `seed`, or given as
    `init_codes`; the pixel sampler's numpy generator is seeded with `seed`."""
    dev = model_params["exp_codes"].device
    os.makedirs(out_dir, exist_ok=True)
    write_png(os.path.join(out_dir, "target.png"), to8b(target_img))
    ckpt_path = os.path.join(out_dir, "fit_params.npz")

    if init_codes is None:
        init_codes = init_fit_codes(torch.Generator().manual_seed(seed), pose_init,
                                    shape_stats, tex_stats, exp_init, dev)
    state = fit_state_from_codes(FitCodes(*[c.to(dev) for c in init_codes]), cfg)
    tx = make_fit_optimizer(cfg)
    begin = 0
    if resume and os.path.exists(ckpt_path):
        codes, begin = load_fit_codes(ckpt_path, dev)
        opt_state = load_fit_opt_state(ckpt_path, state.opt_state)
        if opt_state is None:
            print("WARNING: resuming without optimizer state (no "
                  f"{os.path.basename(ckpt_path) + OPT_SUFFIX}); Adam moments and the LR "
                  "schedule restart")
            opt_state = state.opt_state
        state = FitState(codes, opt_state, torch.tensor(begin, dtype=torch.int32, device=dev))

    sampler = FitRaySampler(kp2d, cfg.H)
    K_full = np.array(
        [[cfg.focal, 0, 0.5 * cfg.W], [0, cfg.focal, 0.5 * cfg.H], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(seed)

    # pyramid state (run_fit.py:186-193, 267-280)
    scale_now = 8
    size = cfg.H // scale_now
    target_scaled = resize_linear(target_img, (size, size)).astype(np.float32)
    n_levels = int(np.log2(8))

    for e in range(begin, begin + cfg.n_iters + 1):
        if e in cfg.change_epoch[:n_levels] or (e % 2000 == 0 and e > 0):
            scale_now = max(scale_now // 2, 1)
            size = cfg.H // scale_now
            target_scaled = resize_linear(target_img, (size, size)).astype(np.float32)

        coords = sampler.sample(rng, cfg.n_rand, scale=scale_now, target_img=target_scaled)
        targets = to_device(target_scaled[coords[:, 0], coords[:, 1]], dev)
        K = to_device(K_full / scale_now, dev)
        state, loss = fit_step(model_params, spec, tx, state, to_device(coords, dev), targets,
                               K, pose_freeze_iters=cfg.pose_freeze_iters)

        if e % 10 == 0:
            print(f"[FIT] iter {e} loss {float(loss):.5f} scale 1/{scale_now}", flush=True)
        if e % cfg.ckpt_every == 0:
            save_fit_state(ckpt_path, state)
        if e > 0 and (e % cfg.preview_every == 0 or e in (100, 200, 300)):
            out = render_fit_frame(model_params, spec, state.codes, cfg.H // 2, cfg.W // 2,
                                   _preview_K(cfg))
            _write_frame(os.path.join(out_dir, f"fit_{e:05d}.png"), out)

    save_fit_state(ckpt_path, state)
    # always a final preview (a short run may never reach preview_every;
    # downstream tools read the last render)
    out = render_fit_frame(model_params, spec, state.codes, cfg.H // 2, cfg.W // 2,
                           _preview_K(cfg))
    _write_frame(os.path.join(out_dir, "fit_final.png"), out)
    return state


def render_novel_views(model_params, spec, codes: FitCodes, out_dir: str,
                       cfg: FitConfig = FitConfig(), yaws=(-60.0, 0.0, 60.0)) -> Dict[str, np.ndarray]:
    """'rendering' mode: the fitted face from orbit yaw angles
    (run_fit.py:352-377). Returns {file name: rgb [H, W, 3]}."""
    os.makedirs(out_dir, exist_ok=True)
    K, frames = _preview_K(cfg), {}
    for yaw in yaws:
        c2w = torch.from_numpy(pose_spherical(yaw, 0.0, 16.0)).to(codes.pose.device)
        out = render_fit_frame(model_params, spec, codes._replace(pose=c2w), cfg.H // 2,
                               cfg.W // 2, K)
        name = f"novel_yaw{int(yaw):+04d}.png"
        frames[name] = _write_frame(os.path.join(out_dir, name), out)
    return frames


def render_modulation(
    model_params, spec, codes: FitCodes, out_dir: str,
    exp_bank: torch.Tensor,                    # [>=20, 30] trained expression latents
    presets: Optional[Dict[str, Any]] = None,  # {"shape": [k, 50], "texture": [k, 1, 256]}
    cfg: FitConfig = FitConfig(),
) -> Dict[str, np.ndarray]:
    """'rendering_modulation' mode: the fitted identity re-rigged with trained
    expression latents and preset shape / texture swaps (run_fit.py:379-431).
    Returns {file name: rgb [H, W, 3]}."""
    os.makedirs(out_dir, exist_ok=True)
    K, frames = _preview_K(cfg), {}
    dev = codes.pose.device
    as_code = lambda v: torch.as_tensor(np.asarray(v, np.float32)).reshape(-1).to(dev)
    variants = [(f"exp_{e:02d}.png", codes._replace(exp=exp_bank[e]))
                for e in MODULATION_EXPRESSIONS]
    if presets:
        variants += [(f"shape_preset_{k}.png", codes._replace(shape=as_code(s)))
                     for k, s in enumerate(presets.get("shape", []))]
        variants += [(f"texture_preset_{k}.png", codes._replace(tex=as_code(t)))
                     for k, t in enumerate(presets.get("texture", []))]
    for name, c in variants:
        out = render_fit_frame(model_params, spec, c, cfg.H // 2, cfg.W // 2, K)
        frames[name] = _write_frame(os.path.join(out_dir, name), out)
    return frames
