"""RefineNet training CLI (counterpart of mofanerf_tpu/cli/run_train_refinenet.py):

    python -m mofanerf_tpu_torch.cli.run_train_refinenet --dataroot d \
        [--nerf_folder train] [--gt_folder gt] [--name refine] \
        [--checkpoints_dir ./checkpoints] [--loadSize 512] [--batchSize 1] \
        [--niter 19] [--niter_decay 1] [--lr 1e-4] [--ngf 32] [--no_vgg_loss] \
        [--vgg_weights vgg.pkl] [--continue_train] [--save_epoch_freq 1] \
        [--display_freq 100] [--max_steps N] [--device cuda]

Trains the pix2pixHD refiner on the (render, ground truth) pairs of
`<dataroot>/<nerf_folder>` and `<dataroot>/<gt_folder>`, and saves
`<checkpoints_dir>/<name>/checkpoints/<step:06d>.pt` after each
`save_epoch_freq` epochs, the last one and at `--max_steps`;
`--continue_train` resumes from the newest checkpoint there (a `.pt`, or the
JAX package's Orbax step).

`--vgg_weights` is the pickle the JAX package reads: its
`convert_torchvision_vgg19` layout ({"params": {"conv{b}_{c}": {"kernel",
"bias"}}}) of numpy arrays. A pickle of JAX arrays cannot be read without
JAX and is refused. Without weights the perceptual term is dropped, with a
WARNING. The permutation and flip draws are the JAX CLI's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from mofanerf_tpu_torch.data.refine_dataset import RefinePairDataset
from mofanerf_tpu_torch.models.refine.losses import vgg_from_jax_layout
from mofanerf_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from mofanerf_tpu_torch.train.refine import (RefineConfig, init_refine_state,
                                             make_refine_optimizers, refine_train_step)
from mofanerf_tpu_torch.utils.device import resolve_device, to_device
from mofanerf_tpu_torch.utils.visualizer import Visualizer


class _NumpyOnly(pickle.Unpickler):
    """Unpickles numpy arrays in dicts; refuses JAX's array types by name."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib"):
            raise ValueError(
                f"the VGG weights pickle holds JAX arrays ({module}.{name}), which cannot be "
                "read without JAX: pickle `jax.tree.map(np.asarray, params)` instead")
        return super().find_class(module, name)


def load_vgg_weights(path: str, device) -> dict:
    """The VGG19Features state dict on `device` from a pickle in the JAX
    package's layout."""
    with open(path, "rb") as f:
        variables = _NumpyOnly(f).load()
    return {k: torch.from_numpy(v).to(device)
            for k, v in vgg_from_jax_layout(variables).items()}


def main(argv=None):
    """Run the CLI; returns the final RefineState."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--nerf_folder", default="train")
    p.add_argument("--gt_folder", default="gt")
    p.add_argument("--name", default="refine")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--loadSize", type=int, default=512)
    p.add_argument("--batchSize", type=int, default=1)
    p.add_argument("--niter", type=int, default=19)
    p.add_argument("--niter_decay", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--no_vgg_loss", action="store_true")
    p.add_argument("--vgg_weights", default=None,
                   help="pickled numpy tree of VGG19 params in the JAX package's "
                        "convert_torchvision_vgg19 layout")
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--save_epoch_freq", type=int, default=1)
    p.add_argument("--display_freq", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=None, help="debug cap")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    out_dir = os.path.join(args.checkpoints_dir, args.name)
    os.makedirs(out_dir, exist_ok=True)
    viz = Visualizer(out_dir, args.name)

    ds = RefinePairDataset(os.path.join(args.dataroot, args.nerf_folder),
                           os.path.join(args.dataroot, args.gt_folder), load_size=args.loadSize)
    if len(ds) == 0:
        raise SystemExit("empty dataset")
    print(f"#training pairs = {len(ds)}")

    cfg = RefineConfig(ngf=args.ngf, lr=args.lr, niter=args.niter, niter_decay=args.niter_decay,
                       use_vgg=not args.no_vgg_loss, load_size=args.loadSize)
    steps_per_epoch = max(1, len(ds) // args.batchSize)
    state = init_refine_state(torch.Generator().manual_seed(0), cfg, steps_per_epoch, dev)
    g_tx, d_tx = make_refine_optimizers(cfg, steps_per_epoch)

    vgg_params = None
    if cfg.use_vgg and args.vgg_weights and os.path.exists(args.vgg_weights):
        vgg_params = load_vgg_weights(args.vgg_weights, dev)
    elif cfg.use_vgg:
        print("WARNING: no --vgg_weights given; dropping the VGG perceptual term")
        cfg = dataclasses.replace(cfg, use_vgg=False)

    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if args.continue_train and latest_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state, spec=cfg)
        print(f"resumed at step {int(state.step)}")

    rng = np.random.default_rng(0)
    step = int(state.step)   # the host's copy: the loop reads nothing back
    total_epochs = args.niter + args.niter_decay
    done = False
    for epoch in range(step // steps_per_epoch, total_epochs):
        t0 = time.time()
        order = rng.permutation(len(ds))
        for i in range(0, steps_per_epoch * args.batchSize, args.batchSize):
            idxs = order[i:i + args.batchSize]
            if len(idxs) < args.batchSize:
                break
            flip = bool(rng.integers(2))
            pairs = [ds.get(int(j), flip) for j in idxs]
            a = to_device(np.stack([q[0] for q in pairs]), dev)
            b = to_device(np.stack([q[1] for q in pairs]), dev)
            state, metrics = refine_train_step(state, a, b, cfg, g_tx, d_tx, vgg_params)
            step += 1
            if step % args.display_freq == 0:
                # in key order, as the JAX package's jitted step returns them
                viz.print_errors(epoch, step, {k: float(v) for k, v in sorted(metrics.items())},
                                 time.time() - t0)
            if args.max_steps and step >= args.max_steps:
                done = True
                break
        if epoch % args.save_epoch_freq == 0 or epoch == total_epochs - 1 or done:
            save_checkpoint(ckpt_dir, state, step)
            print(f"saved checkpoint at epoch {epoch} (step {step})")
        if done:
            break
    return state


if __name__ == "__main__":
    main()
