"""Morphable-model study: one network, two identities, then inverse fitting
(counterpart of examples/morphable_synthetic.py of the JAX package).

1. renders two synthetic identities (a cube and an octahedron) with the
   software rasterizer;
2. trains one model on both, conditioned on distinct shape codes;
3. checks identity control: identity A's code renders A's geometry, and
   B's code swaps the output;
4. fits: from random codes, recovers identity A's codes from one held-out
   image by gradient descent through the renderer (train/fit.py::fit_step),
   the first fit of a trained model, then renders the fitted codes.
Writes `<out>/morphable_synthetic.json`.

Usage: python -m mofanerf_tpu_torch.examples.morphable_synthetic [--iters 2500]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.train.fit import FitConfig, fit_step, init_fit_state, make_fit_optimizer
from mofanerf_tpu_torch.utils.device import to_device
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_morph"))
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--fit_iters", type=int, default=300)
    p.add_argument("--res", type=int, default=64)
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)

    # ---- 1. two identities with distinct geometry
    data_dir = os.path.join(args.out, "data")
    os.makedirs(data_dir, exist_ok=True)
    render_identity(0, {0: _scenes.cube(1.6)}, data_dir, res=args.res, device=dev)
    render_identity(1, {0: _scenes.octahedron()}, data_dir, res=args.res, device=dev)
    shape_codes = _scenes.one_hot_shape_codes()
    ds, H, W, K = _scenes.load_dataset(data_dir, [0, 1], shape_codes)

    # ---- 2. train one model on both
    spec = _scenes.teacher_spec()
    sampler = _scenes.HostSampler(ds, seed=0)
    uvs = {0: _scenes.uv_tensor(0.3, dev), 1: _scenes.uv_tensor(0.7, dev)}

    def batch_for(i):
        img_i, coords, target = sampler.draw()
        return _scenes.make_batch(ds, K, img_i, coords, target, ds.shape_codes[img_i], 0,
                                  uvs[int(ds.id_codes[img_i])], dev)

    state, secs, _ = _scenes.train_teacher(spec, 1e-3, batch_for, args.iters, dev,
                                           log_every=250)
    params = state.params

    # ---- 3. identity control on identity 0's held-out view
    test_idx = {int(ds.id_codes[i]): int(i) for i in ds.i_split[2]}
    results = {}
    with torch.no_grad():
        for pid in (0, 1):
            tex = encode_texture(params, spec, uvs[pid])
            cond = prepare_conditioning(params, spec, to_device(shape_codes[pid], dev),
                                        exp_code_for(params, 0), tex)
            results[pid] = _scenes.np_maps(render_frame(
                params, spec, cond, H, W, K, ds.poses[test_idx[0]][:3]))["rgb"]
            write_png(os.path.join(args.out, f"id{pid}_render.png"), to8b(results[pid]))
    gt0, mask0 = _scenes.load_rgb(ds.image_paths[test_idx[0]])
    gt1, _ = _scenes.load_rgb(ds.image_paths[test_idx[1]])
    p00, p01 = _scenes.psnr(results[0], gt0), _scenes.psnr(results[0], gt1)
    p10 = _scenes.psnr(results[1], gt0)
    swap = float(np.abs(results[0] - results[1]).mean())
    print(f"\nidentity 0 render vs own GT: {p00:.2f} dB (vs other identity: {p01:.2f})")
    print(f"identity swap changes the image by mean |d|={swap:.4f}")

    # ---- 4. inverse fitting: recover identity 0's codes from one image
    fcfg = FitConfig(n_iters=args.fit_iters, n_rand=512, H=H, W=W, focal=float(K[0, 0]),
                     change_epoch=(0, 50, 100, 150, 200))
    fstate = init_fit_state(torch.Generator().manual_seed(7), fcfg, ds.poses[test_idx[0]],
                            device=dev)
    ftx = make_fit_optimizer(fcfg)
    Kd = to_device(K, dev)
    losses = []
    obj_r, obj_c = np.nonzero(mask0)
    _scenes.sync(dev)
    t0 = time.perf_counter()
    for e in range(args.fit_iters):
        # the JAX script's draws: 307 object pixels (with replacement) and 205 uniform
        rng = sampler.rng
        pick = rng.integers(0, obj_r.shape[0], 307)
        coords = np.concatenate([
            np.stack([obj_r[pick], obj_c[pick]], -1),
            np.stack([rng.integers(0, H, 205), rng.integers(0, W, 205)], -1)], 0)
        targets = to_device(gt0[coords[:, 0], coords[:, 1]], dev)
        fstate, loss = fit_step(params, spec, ftx, fstate, to_device(coords, dev), targets, Kd)
        losses.append(loss)
        if e % 100 == 0:
            print(f"fit iter {e} loss {float(loss):.4f}", flush=True)
    _scenes.sync(dev)
    fit_secs = time.perf_counter() - t0
    losses = [float(v) for v in losses]

    codes = fstate.codes
    with torch.no_grad():
        cond_fit = prepare_conditioning(params, spec, codes.shape, codes.exp, codes.tex)
        out = _scenes.np_maps(render_frame(params, spec, cond_fit, H, W, K, codes.pose[:3]))
    fit_img = float(codes.light[0]) * out["rgb"]
    write_png(os.path.join(args.out, "fit_render.png"), to8b(fit_img))
    p_fit = _scenes.psnr(np.clip(fit_img, 0, 1), gt0)
    print(f"\nfit: loss {losses[0]:.4f} -> {min(losses):.4f}; render vs target {p_fit:.2f} dB")
    result = {"own_psnr_db": round(p00, 2), "cross_gt_psnr_db": round(p01, 2),
              "swapped_code_psnr_db": round(p10, 2), "swap_mean_abs_diff": round(swap, 4),
              "fit_loss_first": losses[0], "fit_loss_min": min(losses),
              "fit_psnr_db": round(p_fit, 2), "iters": args.iters,
              "fit_iters": args.fit_iters, "device": _scenes.device_name(dev)}
    timing = {"teacher_secs": secs, "teacher_steps_per_sec": _scenes.rate(args.iters, secs),
              "fit_secs": fit_secs, "fit_steps_per_sec": _scenes.rate(args.fit_iters, fit_secs)}
    _scenes.write_json(os.path.join(args.out, "morphable_synthetic.json"), result, timing)
    return result, timing


if __name__ == "__main__":
    main()
