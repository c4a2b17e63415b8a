"""RefineNet inference CLI (counterpart of mofanerf_tpu/cli/run_refine.py):

    python -m mofanerf_tpu_torch.cli.run_refine --nerf_folder frames \
        [--name refine] [--checkpoints_dir ./checkpoints] [--loadSize 512] [--ngf 32] \
        [--device cuda]

Runs the generator of the newest checkpoint (a `.pt`, or the JAX package's
Orbax step) in `<checkpoints_dir>/<name>/checkpoints`
(or a seeded one, with a WARNING) over the flat directory of rendered frames
and writes each result to the sibling directory `refine/` as a PNG.
"""
from __future__ import annotations

import argparse
import os

import torch

from mofanerf_tpu_torch.data.refine_dataset import RefinePairDataset
from mofanerf_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
from mofanerf_tpu_torch.train.refine import RefineConfig, init_refine_state, refine_inference
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.visualizer import Visualizer


def main(argv=None) -> list:
    """Run the CLI; returns the paths written."""
    p = argparse.ArgumentParser()
    p.add_argument("--nerf_folder", required=True, help="flat dir of rendered frames")
    p.add_argument("--name", default="refine")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--loadSize", type=int, default=512)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = RefineConfig(ngf=args.ngf, load_size=args.loadSize)
    state = init_refine_state(torch.Generator().manual_seed(0), cfg, device=dev)
    ckpt_dir = os.path.join(args.checkpoints_dir, args.name, "checkpoints")
    if latest_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state, spec=cfg)
        print(f"loaded refiner checkpoint (step {int(state.step)})")
    else:
        print(f"WARNING: no checkpoint at {ckpt_dir}; using untrained generator")

    ds = RefinePairDataset(args.nerf_folder, load_size=args.loadSize, flat=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(args.nerf_folder)), "refine")
    viz = Visualizer(os.path.join(args.checkpoints_dir, args.name), args.name)
    paths = []
    for i in range(len(ds)):
        a, _ = ds.get(i)
        out = refine_inference(state.g_params, torch.from_numpy(a[None]).to(dev), cfg)
        name = os.path.splitext(os.path.basename(ds.a_paths[i]))[0]
        paths.append(viz.save_result_image(out_dir, name, (out[0].cpu().numpy() + 1.0) / 2.0))
        print(f"[{i + 1}/{len(ds)}] {paths[-1]}")
    return paths


if __name__ == "__main__":
    main()
