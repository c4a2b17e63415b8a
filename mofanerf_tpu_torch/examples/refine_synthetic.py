"""RefineNet quality study: measured restoration on a synthetic corpus
(counterpart of examples/refine_synthetic.py of the JAX package).

GT = rasterized multiview frames of a cube; the "NeRF render" input is a
measured degradation of GT (4x mean-pool down/up + noise, the blur and detail
loss of a radiance field). The refiner (train/refine.py, pix2pixHD's global
generator and multiscale discriminator, f32 convolutions) trains on the
held-in views and is scored on held-out views by PSNR against GT, beside the
un-refined input's PSNR. The gate: the held-out refined PSNR beats the
input's by more than 0.2 dB (restoration, not memorisation).

Writes `--artifacts` (default `<out>/refine_quality.json`).

Usage: python -m mofanerf_tpu_torch.examples.refine_synthetic [--steps 3000] [--quick]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.data.facescape import load_facescape_data
from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.train.refine import (RefineConfig, init_refine_state,
                                             make_refine_optimizers, refine_inference,
                                             refine_train_step)
from mofanerf_tpu_torch.utils.image_io import imread
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def degrade(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A NeRF render's degradation: 4x mean-pool down/up (detail loss) + mild noise
    (sampling variance)."""
    h, w, _ = img.shape
    f = 4
    small = img.reshape(h // f, f, w // f, f, 3).mean((1, 3))
    blur = np.repeat(np.repeat(small, f, 0), f, 1)
    return np.clip(blur + rng.normal(0, 0.02, blur.shape), 0, 1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_refine_study"))
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--artifacts", default=None)
    p.add_argument("--quick", action="store_true", help="CI/CPU smoke")
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.steps, args.res, args.batch = 60, 64, 2

    # ---- corpus: rasterized GT + blur-degraded inputs
    data_dir = os.path.join(args.out, f"data{args.res}")
    os.makedirs(data_dir, exist_ok=True)
    render_identity(0, {0: _scenes.cube(1.6)}, data_dir, res=args.res, device=dev)
    ds = load_facescape_data(data_dir, [0], np.zeros((300, 50), np.float32), testskip=1)
    rng = np.random.default_rng(0)
    frames = {}
    for i in range(len(ds.image_paths)):
        gt = imread(ds.image_paths[i]).astype(np.float32)[..., :3] / 255.0
        frames[i] = (degrade(gt, rng), gt)
    train_ids = [int(i) for i in ds.i_split[0]]
    test_ids = [int(i) for i in ds.i_split[2][:8]]

    # ---- train G + D (the adversarial step, constant-then-decay lr)
    cfg = RefineConfig(use_vgg=False, ngf=16 if args.quick else 32,
                       n_blocks=3 if args.quick else 9, n_downsampling=2 if args.quick else 4)
    steps_per_epoch = max(1, len(train_ids) // args.batch)
    state = init_refine_state(torch.Generator().manual_seed(0), cfg,
                              steps_per_epoch=steps_per_epoch, device=dev)
    g_tx, d_tx = make_refine_optimizers(cfg, steps_per_epoch)

    def batch():
        ids = rng.choice(train_ids, args.batch)
        a = np.stack([frames[i][0] for i in ids]) * 2 - 1
        b = np.stack([frames[i][1] for i in ids]) * 2 - 1
        return (torch.as_tensor(a, dtype=torch.float32).to(dev),
                torch.as_tensor(b, dtype=torch.float32).to(dev))

    _scenes.sync(dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, m = refine_train_step(state, *batch(), cfg, g_tx, d_tx)
        if i % max(1, args.steps // 6) == 0:
            print(f"[REFINE] step {i} loss_G {float(m['loss_G']):.3f} loss_D "
                  f"{float(m['loss_D']):.3f} ({(i + 1) / (time.perf_counter() - t0):.2f} it/s)",
                  flush=True)
    _scenes.sync(dev)
    train_secs = time.perf_counter() - t0

    # ---- score on held-out views
    def infer(x: np.ndarray) -> np.ndarray:
        out = refine_inference(state.g_params,
                               torch.as_tensor(x[None] * 2 - 1, dtype=torch.float32).to(dev),
                               cfg)
        return np.clip((out[0].cpu().numpy() + 1) / 2, 0, 1)

    rows = []
    os.makedirs(args.out, exist_ok=True)
    for i in test_ids:
        inp, gt = frames[i]
        rows.append({"view": i, "input_psnr_db": round(_scenes.psnr(inp, gt), 2),
                     "refined_psnr_db": round(_scenes.psnr(infer(inp), gt), 2)})
    first_in, first_gt = frames[test_ids[0]]
    write_png(os.path.join(args.out, "input.png"), to8b(first_in))
    write_png(os.path.join(args.out, "refined.png"), to8b(infer(first_in)))
    write_png(os.path.join(args.out, "gt.png"), to8b(first_gt))

    mean_in = round(float(np.mean([r["input_psnr_db"] for r in rows])), 2)
    mean_ref = round(float(np.mean([r["refined_psnr_db"] for r in rows])), 2)
    results = {
        "corpus": f"{len(train_ids)} train / {len(test_ids)} heldout views, {args.res}^2, "
                  "degradation = 4x meanpool + noise(0.02)",
        "generator": f"ngf={cfg.ngf} n_blocks={cfg.n_blocks} n_down={cfg.n_downsampling} "
                     "(pix2pixHD global)",
        "steps": args.steps, "train_secs": round(train_secs, 1),
        "heldout_input_psnr_db": mean_in,
        "heldout_refined_psnr_db": mean_ref,
        "psnr_gain_db": round(mean_ref - mean_in, 2),
        "per_view": rows,
        "device": _scenes.device_name(dev),
    }
    timing = {"train_secs": train_secs, "steps_per_sec": _scenes.rate(args.steps, train_secs)}
    _scenes.write_json(args.artifacts or os.path.join(args.out, "refine_quality.json"),
                       results, timing)
    if not args.quick:
        # PSNR is a conservative bar for a GAN (LSGAN + feature matching optimise
        # realism, not MSE); any clearly positive held-out gain is restoration
        _scenes.gate(mean_ref > mean_in + 0.2,
                     f"refinement gains too little: {mean_in} -> {mean_ref}")
    print("REFINE QUALITY OK")
    return results, timing


if __name__ == "__main__":
    main()
