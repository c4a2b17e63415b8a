"""Train-state checkpoints as torch files (counterpart of
mofanerf_tpu/train/checkpoint.py), and the JAX package's Orbax steps read.

One file a step, `<ckpt_dir>/<step:06d>.pt`: a flat dict of CPU tensors
keyed by JAX key paths (`['params']['coarse']['xyz']['b']`,
`['opt_state']['mu'][...]`, `['opt_state']['count']`, `['step']`; a
RefineNet state's `['g_params']['stem.weight']`, `['d_opt']['nu'][...]`). A save
writes a temporary file and renames it, so a save at an existing step
replaces it whole.

The JAX package saves a step as an Orbax directory, `<ckpt_dir>/<step:06d>/`.
The port restores those too, in every layout Orbax's restore reads (zarr v2
or v3, with OCDBT or without, numbered manifests; `train/orbax.py` reads
them without Orbax; the bridge's functions map the JAX layout onto the
port's), so a run trained with the JAX package renders, fits and resumes
here; the port's own saves are always `.pt`.
"""
from __future__ import annotations

import os
import re
from typing import List

import torch

from mofanerf_tpu_torch.render.renderer import init_model_params
from mofanerf_tpu_torch.train.orbax import is_orbax_step, read_step
from mofanerf_tpu_torch.train.refine import RefineState, refine_from_tree, refine_tree
from mofanerf_tpu_torch.train.state import AdamState, TrainState
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr, tree_unflatten

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _as_tree(state) -> dict:
    if isinstance(state, RefineState):
        return refine_tree(state)
    opt = state.opt_state
    return {"params": state.params,
            "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
            "step": state.step}


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Save `state` as ckpt_dir/<step>.pt, replacing a checkpoint of the same
    step (an interval save and the final save can land on one step)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step:06d}.pt")
    flat = {k: v.detach().cpu() for k, v in flatten_with_keystr(_as_tree(state))}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)
    return path


def orbax_steps(ckpt_dir: str) -> List[int]:
    """Steps of the JAX package's Orbax checkpoints (digit-named directories)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d)))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step in ckpt_dir of either kind, a `<step>.pt` file or a
    finished Orbax step of the JAX package (`<step:06d>/` holding its
    `_METADATA`); None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m]
    steps += [s for s in orbax_steps(ckpt_dir)
              if is_orbax_step(os.path.join(ckpt_dir, f"{s:06d}"))]
    return max(steps) if steps else None


def _orbax_flat(path: str, target, spec) -> dict:
    """The Orbax step `path` as the flat dict that a `.pt` file holds for
    `target`: read without Orbax, mapped onto the port's layout by the bridge
    (which checks it against `spec`), on the CPU."""
    from mofanerf_tpu_torch import bridge

    if spec is None:
        raise ValueError(f"{path} is an Orbax step of the JAX package: restoring it "
                         "needs the model's spec")
    try:
        if isinstance(target, RefineState):
            tree = refine_tree(bridge.refine_state_to_torch(read_step(path), spec, "cpu"))
        elif isinstance(target, TrainState):
            tree = _as_tree(bridge.train_state_to_torch(read_step(path), spec, "cpu"))
        else:
            params = read_step(path, only=("params",))["params"]
            tree = {"params": bridge.model_params_to_torch(params, spec, "cpu")}
    except (AttributeError, KeyError, TypeError, ValueError) as e:
        raise ValueError(f"{path} does not hold this model's state: {e!r}") from e
    return dict(flatten_with_keystr(tree))


def restore_checkpoint(ckpt_dir: str, target, step: int | None = None, spec=None):
    """Restore into the structure of `target`: a TrainState or a RefineState,
    or a model param tree to restore only the params. Tensors land on the
    device of target's leaves. step=None restores the newest step of either
    kind; where one step has both a `.pt` file and an Orbax directory, the
    `.pt` is read. An Orbax step needs `spec`: the model's MoFaNeRF for a
    TrainState or a param tree, the RefineConfig for a RefineState."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"{step:06d}.pt")
    if os.path.isfile(path):
        flat = torch.load(path, map_location="cpu", weights_only=True)
    elif os.path.isdir(path[:-len(".pt")]):
        path = path[:-len(".pt")]
        flat = _orbax_flat(path, target, spec)
    else:
        raise FileNotFoundError(f"no checkpoint of step {step} in {ckpt_dir}")
    whole = isinstance(target, (TrainState, RefineState))
    tree = _as_tree(target) if whole else {"params": target}
    want = flatten_with_keystr(tree)
    missing = [k for k, _ in want if k not in flat]
    extra = sorted(set(flat) - {k for k, _ in want}) if whole else []
    if missing or extra:
        raise ValueError(f"{path} does not hold this model's state: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    leaves = []
    for k, like in want:
        t = flat[k]
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"{path}: {k} is {tuple(t.shape)} {t.dtype}, the model's "
                             f"{tuple(like.shape)} {like.dtype}")
        leaves.append(t.to(like.device))
    out = tree_unflatten(tree, leaves)
    if not whole:
        return out["params"]
    if isinstance(target, RefineState):
        return refine_from_tree(out)
    opt = out["opt_state"]
    return TrainState(out["params"], AdamState(opt["count"], opt["mu"], opt["nu"]), out["step"])


def load_model(ckpt_dir: str, spec, device="cuda"):
    """(model params on `device`, step): the params of the newest step in
    ckpt_dir (a `.pt` file or the JAX package's Orbax directory), or seeded
    weights (a CPU generator seeded 0) and None when there is none."""
    step = latest_step(ckpt_dir)
    params = init_model_params(torch.Generator().manual_seed(0), spec, device=device)
    if step is not None:
        params = restore_checkpoint(ckpt_dir, params, step, spec)
    return params, step
