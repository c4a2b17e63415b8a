"""Quality evaluation CLI (counterpart of mofanerf_tpu/cli/evaluate.py):
render a dataset's test split and report PSNR and SSIM against the ground
truth.

    python -m mofanerf_tpu_torch.cli.evaluate [--ckpt_dir dir] [--out_dir out] \
        [--max_views 25] [--render_factor 1] [--fast] [--device cuda] [config flags]

The model is the newest checkpoint (a `.pt`, or the JAX package's Orbax
step) in `--ckpt_dir` (else `basedir/expname/checkpoints`); there must be
one. Each view renders through
`render_frame` (the fused field kernel on the card), or with `--fast` through
a grid of the coarse field built once per (identity, expression) and
`render_frame_fast` (the fine field through the kernel at 32 samples a
ray). `--render_factor` shrinks the frame and the ground truth (INTER_AREA).
`--out_dir` keeps the renders and `metrics.json` (n_views, psnr_mean,
ssim_mean, psnr_std, the JAX package's keys). LPIPS needs pretrained
perceptual weights and is left out, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import (load_facescape_data, load_shape_codes, read_image,
                                               valid_persons)
from mofanerf_tpu_torch.ops.occupancy import build_proposal_grid, render_frame_fast
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.train.checkpoint import load_model
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.image_io import resize_area, write_png
from mofanerf_tpu_torch.utils.metrics import ssim, to8b


def main(argv=None) -> dict:
    """Run the CLI; returns metrics.json's keys and the per-view "psnr",
    "ssim" and "views" lists."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--out_dir", default=None, help="also save renders here")
    p.add_argument("--max_views", type=int, default=25)
    p.add_argument("--render_factor", type=int, default=1)
    p.add_argument("--fast", action="store_true", help="occupancy-culled rendering")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(rest)

    spec = cfg.model_spec()
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    params, step = load_model(ckpt_dir, spec, dev)
    if step is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    print(f"evaluating checkpoint step {step}")

    persons = valid_persons(cfg.datadir, cfg.person_num)
    shape_codes = load_shape_codes(cfg.shape_codes_path)
    ds = load_facescape_data(cfg.datadir, persons, shape_codes, uvdir=cfg.uvdir,
                             half_res=cfg.half_res, testskip=cfg.testskip)
    H, W, focal = ds.hwf
    rf = max(1, args.render_factor)
    H, W, focal = H // rf, W // rf, focal / rf
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)

    tex_cache, grid_cache = {}, {}
    psnrs, ssims = [], []
    test_ids = [int(ti) for ti in ds.i_split[2][: args.max_views]]
    for n, ti in enumerate(test_ids):
        pid = int(ds.id_codes[ti])
        with torch.no_grad():
            if pid not in tex_cache:
                uv = (read_image(ds.uv_paths[pid], is_uvmap=True, uv_size=spec.uv_size)
                      if ds.uv_paths else np.full((spec.uv_size, spec.uv_size, 3), 0.5,
                                                  np.float32))
                tex_cache[pid] = encode_texture(params, spec, torch.from_numpy(uv).to(dev))
            cond = prepare_conditioning(
                params, spec, torch.from_numpy(ds.shape_codes[ti]).to(dev),
                exp_code_for(params, int(ds.exp_types[ti])), tex_cache[pid])
        c2w = ds.poses[ti][:3]
        if args.fast:
            key = (pid, int(ds.exp_types[ti]))
            if key not in grid_cache:
                grid_cache[key] = build_proposal_grid(params, spec, cond)
            out = render_frame_fast(params, spec, cond.fine, grid_cache[key], H, W, K, c2w)
        else:
            out = render_frame(params, spec, cond, H, W, K, c2w)
        rgb = out["rgb"].float().cpu().numpy()
        gt = read_image(ds.image_paths[ti], half_res=cfg.half_res, white_bkgd=cfg.white_bkgd)
        if rf > 1:
            gt = resize_area(gt, (W, H))
        mse = float(np.mean((rgb - gt) ** 2))
        psnrs.append(-10 * np.log10(max(mse, 1e-10)))
        ssims.append(ssim(rgb, gt))
        print(f"[{n + 1}/{len(test_ids)}] view {ti}: psnr {psnrs[-1]:.2f} ssim {ssims[-1]:.4f}")
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            write_png(os.path.join(args.out_dir, f"{ti:05d}.png"), to8b(rgb))

    result = {
        "n_views": len(psnrs),
        "psnr_mean": round(float(np.mean(psnrs)), 3),
        "ssim_mean": round(float(np.mean(ssims)), 4),
        "psnr_std": round(float(np.std(psnrs)), 3),
    }
    print(json.dumps(result))
    if args.out_dir:
        with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
            json.dump(result, f)
    return dict(result, psnr=psnrs, ssim=ssims, views=test_ids)


if __name__ == "__main__":
    main()
