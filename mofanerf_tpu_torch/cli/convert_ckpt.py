"""Reference-checkpoint conversion CLI (counterpart of
mofanerf_tpu/cli/convert_ckpt.py).

    python -m mofanerf_tpu_torch.cli.convert_ckpt --tar X.tar --out_dir D \
        [--step N] [--device cuda]

Converts the reference's PyTorch `.tar` training checkpoint
(run_train.py:370-379 layout) at the reference's widths (coarse 8x256, fine
10x1024) into the port's train state, `D/<step:06d>.pt`: the converted
params, a fresh Adam state (count 0, zero moments: the moments do not carry
over), and the step, `--step` or else the `.tar`'s `global_step`. The params
are converted on `--device`; `run_render --ckpt_dir D`, `run_fit`,
`evaluate` and the other CLIs then read the directory.
"""
from __future__ import annotations

import argparse

import torch

from mofanerf_tpu_torch.convert import convert_checkpoint, load_reference
from mofanerf_tpu_torch.models.field import FieldConfig
from mofanerf_tpu_torch.render.renderer import MoFaNeRF
from mofanerf_tpu_torch.train.checkpoint import save_checkpoint
from mofanerf_tpu_torch.train.state import TrainState, make_optimizer
from mofanerf_tpu_torch.utils.device import resolve_device


def main(argv=None) -> str:
    """Run the CLI; returns the path written."""
    p = argparse.ArgumentParser()
    p.add_argument("--tar", required=True, help="reference .tar checkpoint")
    p.add_argument("--out_dir", required=True, help="checkpoint directory to write")
    p.add_argument("--step", type=int, default=None,
                   help="step label (default: global_step from the tar)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    spec = MoFaNeRF(coarse=FieldConfig(depth=8, width=256), fine=FieldConfig(depth=10, width=1024))
    ckpt = load_reference(args.tar)
    params = convert_checkpoint(args.tar, spec, dev, ckpt=ckpt)
    step = args.step if args.step is not None else int(ckpt.get("global_step", 0))
    state = TrainState(params, make_optimizer().init(params),
                       torch.tensor(step, dtype=torch.int32, device=dev))
    path = save_checkpoint(args.out_dir, state, step)
    print(f"converted -> {path} (step {step}; optimizer state reinitialized)")
    return path


if __name__ == "__main__":
    main()
