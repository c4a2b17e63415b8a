"""Fitting CLI (counterpart of mofanerf_tpu/cli/run_fit.py and the
reference's `python run_fit.py --filePath <img> --renderType fitting|
rendering|rendering_modulation --num_iterations 2000`, run_fit.py:437-448):

    python -m mofanerf_tpu_torch.cli.run_fit --filePath data/segRelRes/face.png \
        [--renderType fitting] [--num_iterations 2000] [--pose_freeze_iters 300] \
        [--ckpt_dir dir] [--code_stats texShpDistribution.npy] [--is_load_par] \
        [--predef_par presets.npy] [--device cuda] [config flags]

Expects the preprocessing pipeline's output beside the photo's folder:
`<parent>/pose_<name>.npy` holding {pose 4x4, kp 68x2}
(tools/wildData_preprocess.py). Writes to `<parent>/fitting/<folder>_<name>`:
`target.png`, `fit_params.npz` (+ `.opt.pt`), previews `fit_*.png`; the
render modes read the fitted codes there and write `novel_yaw*.png` or
`exp_*.png` (+ preset swaps). The model is the newest checkpoint (a `.pt`,
or the JAX package's Orbax step) in `--ckpt_dir` (else
`basedir/expname/checkpoints`); without one it fits against seeded
weights and says so. `--device cpu` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import read_image
from mofanerf_tpu_torch.train.checkpoint import load_model
from mofanerf_tpu_torch.train.fit import FitConfig, load_code_stats
from mofanerf_tpu_torch.train.fit_loop import (fit, load_fit_codes, render_modulation,
                                               render_novel_views)
from mofanerf_tpu_torch.utils.device import resolve_device


def load_pose_file(src_path: str):
    """pose_<name>.npy beside the photo's parent folder (run_fit.py:102-113)."""
    parent = os.path.dirname(os.path.dirname(os.path.abspath(src_path)))
    name = os.path.splitext(os.path.basename(src_path))[0]
    path = os.path.join(parent, f"pose_{name}.npy")
    d = np.load(path, allow_pickle=True).item()
    return np.asarray(d["pose"], np.float32), np.asarray(d["kp"], np.float32)


def main(argv=None):
    """Run the CLI; returns the FitState of a fit, or {file name: rgb} of a
    render mode."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--filePath", required=True, help="preprocessed photo (segRelRes/*.png)")
    parser.add_argument("--renderType", default="fitting",
                        choices=["fitting", "rendering", "rendering_modulation"])
    parser.add_argument("--num_iterations", type=int, default=2000)
    parser.add_argument("--pose_freeze_iters", type=int, default=300,
                        help="codes-only warm-up before the pose unfreezes; co-optimising "
                             "from step 0 lets the codes absorb the initial pose error and "
                             "the rotation drift")
    parser.add_argument("--ckpt_dir", default=None, help="trained model checkpoint dir")
    parser.add_argument("--code_stats", default=None, help="texShpDistribution.npy path")
    parser.add_argument("--predef_par", default=None, help="preset codes .npy for modulation")
    parser.add_argument("--is_load_par", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = parser.parse_known_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(rest)

    spec = cfg.model_spec()
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    params, step = load_model(ckpt_dir, spec, dev)
    if step is not None:
        print(f"loaded model checkpoint from {ckpt_dir} (step {step})")
    else:
        print(f"WARNING: no checkpoint in {ckpt_dir}; fitting against an untrained model")

    target = read_image(args.filePath)
    pose, kp2d = load_pose_file(args.filePath)
    fcfg = FitConfig(n_iters=args.num_iterations, n_rand=cfg.N_rand,
                     pose_freeze_iters=args.pose_freeze_iters)

    name = os.path.splitext(os.path.basename(args.filePath))[0]
    type_name = os.path.basename(os.path.dirname(args.filePath))
    parent = os.path.dirname(os.path.dirname(os.path.abspath(args.filePath)))
    out_dir = os.path.join(parent, "fitting", f"{type_name}_{name}")

    shape_stats = tex_stats = None
    if args.code_stats and os.path.exists(args.code_stats):
        shape_stats, tex_stats = load_code_stats(args.code_stats)

    if args.renderType == "fitting":
        return fit(params, spec, target, pose, kp2d, out_dir, fcfg, resume=args.is_load_par,
                   exp_init=params["exp_codes"][0],   # neutral (run_fit.py:205)
                   shape_stats=shape_stats, tex_stats=tex_stats)
    codes, fit_step_n = load_fit_codes(os.path.join(out_dir, "fit_params.npz"), dev)
    print(f"loaded fitted codes at iter {fit_step_n}")
    if args.renderType == "rendering":
        return render_novel_views(params, spec, codes, out_dir, fcfg)
    presets = None
    if args.predef_par and os.path.exists(args.predef_par):
        presets = np.load(args.predef_par, allow_pickle=True).item()
    return render_modulation(params, spec, codes, out_dir, exp_bank=params["exp_codes"],
                             presets=presets, cfg=fcfg)


if __name__ == "__main__":
    main()
