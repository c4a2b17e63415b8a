"""Training CLI (counterpart of mofanerf_tpu/cli/run_train.py):

    python -m mofanerf_tpu_torch.cli.run_train --config configs/exp_mofanerf.txt \
        [--device cuda] [--n_iters N] [config flags]

Config flags as in mofanerf_tpu_torch/config.py (`--i_grid 0` turns the
occupancy grid's upkeep off). `--device cpu` trains on the CPU (small
configs); the default is the card.
"""
from __future__ import annotations

import argparse
import sys

from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.train.loop import train


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv if argv is not None else sys.argv[1:])
    return train(load_config(rest), device=args.device)


if __name__ == "__main__":
    main()
