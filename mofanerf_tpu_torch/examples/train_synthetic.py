"""End-to-end study: dataset production -> training -> rendering (counterpart
of examples/train_synthetic.py of the JAX package).

Renders a multiview dataset of a cube with the software rasterizer, trains a
small MoFaNeRF on it (one identity, one expression), and reports the PSNR
trajectory and a held-out render through `render_frame` (the field kernel).
No external data needed. Writes `<out>/train_synthetic.json`.

Usage: python -m mofanerf_tpu_torch.examples.train_synthetic [--iters 2000] [--out DIR]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_synth"))
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)

    # ---- 1. the dataset (a cube, 120 views)
    data_dir = os.path.join(args.out, "data")
    os.makedirs(data_dir, exist_ok=True)
    render_identity(0, {0: _scenes.cube(1.6)}, data_dir, res=args.res, device=dev)
    ds, H, W, K = _scenes.load_dataset(data_dir, [0])

    # ---- 2. train
    spec = _scenes.teacher_spec((8, args.width), (8, args.width * 2))
    sampler = _scenes.HostSampler(ds, seed=0)
    uv = _scenes.uv_tensor(0.5, dev)
    zeros = np.zeros(50, np.float32)

    def batch_for(i):
        img_i, coords, target = sampler.draw()
        return _scenes.make_batch(ds, K, img_i, coords, target, zeros, 0, uv, dev)

    state, secs, log = _scenes.train_teacher(spec, 1e-3, batch_for, args.iters, dev,
                                             log_every=25)
    psnrs = [m[2] for m in log]

    # ---- 3. held-out render
    test_i = int(ds.i_split[2][0])
    with torch.no_grad():
        tex = encode_texture(state.params, spec, uv)
        cond = prepare_conditioning(state.params, spec, torch.zeros(50, device=dev),
                                    exp_code_for(state.params, 0), tex)
        out = _scenes.np_maps(render_frame(state.params, spec, cond, H, W, K,
                                           ds.poses[test_i][:3]))
    gt, _ = _scenes.load_rgb(ds.image_paths[test_i])
    test_psnr = _scenes.psnr(out["rgb"], gt)
    write_png(os.path.join(args.out, "test_render.png"), to8b(out["rgb"]))
    write_png(os.path.join(args.out, "test_gt.png"), to8b(gt))
    result = {
        "scene": f"synthetic cube {args.res}x{args.res}, teacher 8x{args.width}+"
                 f"8x{args.width * 2}, {args.iters} iters",
        "train_psnr_first_db": round(psnrs[0], 2) if psnrs else None,
        "train_psnr_last_db": round(psnrs[-1], 2) if psnrs else None,
        "heldout_psnr_db": round(test_psnr, 2),
        "device": _scenes.device_name(dev),
    }
    print(f"\ntrain PSNR: {result['train_psnr_first_db']} -> {result['train_psnr_last_db']} dB")
    print(f"held-out view PSNR: {test_psnr:.2f} dB")
    timing = {"teacher_secs": secs, "teacher_steps_per_sec": _scenes.rate(args.iters, secs)}
    _scenes.write_json(os.path.join(args.out, "train_synthetic.json"), result, timing)
    return result, timing


if __name__ == "__main__":
    main()
