"""Morphable capability at the reference's width: one 8x256 + 10x1024 model over
a family of synthetic identities x expressions, trained and measured
(counterpart of examples/morphable_flagship.py of the JAX package).

The model trains through the training loop (train/loop.py::train) on the
procedural face family (identity parameters are the leading shape-code dims),
then the evaluation reads:

- held-out per-identity PSNR + SSIM (own codes, test views), with each view's
  curtain fraction (opaque rays ending before the head box or at the near
  plane) and mean opaque depth;
- cross-identity leakage (identity A's camera rendered with B's codes);
- identity interpolation against the ground-truth intermediate face (the
  generator is linear in its parameters, so the true face exists and is
  rasterized);
- expression control on held-out views across the trained bank, and with
  --exp_matrix_ids the whole expression-transfer matrix.
The teacher's frames render through the field kernel. Writes
`--out_json` (default examples/artifacts/morphable_flagship.json of this
package) and its gallery and interpolation PNGs beside it.

Usage:
  python -m mofanerf_tpu_torch.examples.morphable_flagship --stage train \
      --device_data --white_bkgd --i_weights 2000 --i_testset 1000000000
  python -m mofanerf_tpu_torch.examples.morphable_flagship --stage eval --white_bkgd
CPU smoke: --small --device cpu runs toy dims end to end.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from mofanerf_tpu_torch.examples import _flagship, _scenes
from mofanerf_tpu_torch.render.renderer import render_frame
from mofanerf_tpu_torch.utils.image_io import resize_area
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def build_config(args):
    cfg = _flagship.data_config(
        args,
        landmarks_path=os.path.join(args.data, "landmarks.npy"),
        n_iters=args.iters, testskip=1, i_print=200, i_weights=args.i_weights,
        i_testset=args.i_testset, i_video=10 ** 9, i_grid=500,
        compute_dtype=args.compute_dtype, white_bkgd=args.white_bkgd,
        device_data=args.device_data, scan_steps=args.scan_steps, ray_bias=args.ray_bias,
        near=args.near, far=args.far)
    if args.small:  # CPU smoke tier
        cfg = dataclasses.replace(
            cfg, **_flagship.SMALL_FLAGSHIP, N_rand=128, precrop_iters=10,
            lm_frac_anneal_iters=20, i_print=10, i_grid=0, lrate=5e-4)
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    _flagship.add_model_flags(p)
    p.add_argument("--iters", type=int, default=40000)
    p.add_argument("--i_weights", type=int, default=5000)
    p.add_argument("--i_testset", type=int, default=5000)
    p.add_argument("--stage", choices=["train", "eval", "all"], default="all")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--white_bkgd", action="store_true",
                   help="composite targets over white; forces the field to learn empty "
                        "space (over black an opaque near-plane curtain of black fog matches "
                        "the data with no 3D structure)")
    p.add_argument("--device_data", action="store_true",
                   help="device-resident split + batches sampled on the card")
    p.add_argument("--scan_steps", type=int, default=0,
                   help="optimizer steps a chunk (device_data path)")
    p.add_argument("--near", type=float, default=8.0)
    p.add_argument("--far", type=float, default=26.0)
    p.add_argument("--ray_bias", default="auto",
                   help="device-sampler bias: auto|landmarks|fg|none|expdelta")
    p.add_argument("--small", action="store_true", help="toy dims (CPU smoke)")
    p.add_argument("--res", type=int, default=0,
                   help="eval GT raster resolution override (0 = dataset res)")
    p.add_argument("--out_json", default=_flagship.artifact("morphable_flagship.json"))
    p.add_argument("--n_test_views", type=int, default=4)
    p.add_argument("--exp_matrix_ids", type=int, default=0,
                   help="if > 0: render the first N identities under every expression of "
                        "the trained bank, each scored against a freshly rasterized GT of "
                        "that (id, exp) face")
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)

    cfg = build_config(args)
    timing, result = {}, None
    if args.stage in ("train", "all"):
        from mofanerf_tpu_torch.train.loop import train

        _scenes.sync(dev)
        t0 = time.perf_counter()
        state = train(cfg, n_iters=args.iters, device=dev)
        _scenes.sync(dev)
        timing["train_secs"] = time.perf_counter() - t0
        timing["train_steps"] = int(state.step)
    if args.stage in ("eval", "all"):
        _scenes.sync(dev)
        t0 = time.perf_counter()
        result = evaluate(args, cfg, dev)
        _scenes.sync(dev)
        timing["eval_secs"] = time.perf_counter() - t0
    return result, timing


def evaluate(args, cfg, dev) -> dict:
    spec = cfg.model_spec()
    params, step = _flagship.restore(cfg, spec, dev, required=True)
    print(f"eval at step {step}")
    persons = list(range(args.n_ids))
    fc = _flagship.Faces(cfg, params, spec, persons, dev)
    H, W, K = fc.H, fc.W, fc.K
    psnr, ssim = _scenes.psnr, _scenes.ssim

    def render_full(c, pose):
        return _scenes.np_maps(render_frame(params, spec, c, H, W, K, pose))

    def render(c, pose):
        return render_full(c, pose)["rgb"]

    rng = np.random.default_rng(0)
    test_idx = fc.test_idx
    out_dir = os.path.dirname(os.path.abspath(args.out_json))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.out_json))[0]

    # ---- 1. held-out per-identity quality (own codes)
    per_identity, gallery = {}, []
    for pid in persons:
        picks = rng.choice(test_idx[pid], size=min(args.n_test_views, len(test_idx[pid])),
                           replace=False)
        ps_, ss_, curt_, dep_ = [], [], [], []
        for i in picks:
            gt = fc.gt(i)
            fr = render_full(fc.cond(pid, int(fc.ds.exp_types[i])), fc.pose(i))
            out = fr["rgb"]
            ps_.append(psnr(out, gt))
            ss_.append(ssim(out, gt))
            # geometry health: a degenerate curtain (a view-dependent light field)
            # ends rays at the near plane, outside the head box the cameras orbit
            # (radius 16, head radius under ~5.5); depth hugging the configured near
            # is flagged too
            depth, acc = fr["depth"], fr["acc"]
            opaque = acc > 0.5
            t_box = max(16.0 - 5.5, cfg.near + 0.3)
            curt_.append(float((opaque & (depth < t_box)).mean()))
            dep_.append(float(depth[opaque].mean()) if opaque.any() else 0.0)
        per_identity[pid] = {
            "psnr": float(np.mean(ps_)), "ssim": float(np.mean(ss_)),
            "n_views": len(picks),
            "curtain_fraction": round(float(np.mean(curt_)), 4),
            "mean_opaque_depth": round(float(np.mean(dep_)), 3),
        }
        print(f"id {pid}: held-out PSNR {per_identity[pid]['psnr']:.2f} dB "
              f"SSIM {per_identity[pid]['ssim']:.3f}", flush=True)
        i0 = picks[0]
        out = render(fc.cond(pid, int(fc.ds.exp_types[i0])), fc.pose(i0))
        gallery.append(np.concatenate([fc.gt(i0), np.clip(out, 0, 1)], axis=0))
    write_png(os.path.join(out_dir, f"{stem}_gallery.png"),
              to8b(np.concatenate(gallery, axis=1)))

    # ---- 2. cross-identity leakage: id A's held-out camera, id B's codes
    cross = []
    for ai in range(min(4, len(persons))):
        a, b = persons[ai], persons[(ai + 1) % len(persons)]
        i = test_idx[a][0]
        out_b = render(fc.cond(b, int(fc.ds.exp_types[i])), fc.pose(i))
        cross.append({"own_id": a, "other_id": b, "own_psnr": per_identity[a]["psnr"],
                      "cross_psnr": psnr(out_b, fc.gt(i))})
        print(f"leakage {a}<-{b}: own {cross[-1]['own_psnr']:.2f} vs "
              f"cross {cross[-1]['cross_psnr']:.2f} dB", flush=True)

    # ---- 3. identity interpolation against the ground-truth intermediate faces
    a_pid, b_pid = persons[0], persons[1]
    frontal_i = test_idx[a_pid][0]
    exp_f = int(fc.ds.exp_types[frontal_i])
    res = args.res or H
    interp, strip = [], []
    for t in (0.0, 0.25, 0.5, 0.75, 1.0):
        p_t = (1 - t) * fc.face_params[a_pid] + t * fc.face_params[b_pid]
        code_t = (1 - t) * fc.codes[a_pid] + t * fc.codes[b_pid]
        tex_t = (1 - t) * fc.tex(a_pid) + t * fc.tex(b_pid)
        gt_t = fc.raster_gt(p_t, exp_f, frontal_i, res, cfg.white_bkgd)
        out_t = render(fc.cond_of(code_t, exp_f, tex_t), fc.pose(frontal_i))
        if res != H:
            out_t = resize_area(out_t, (res, res))
        interp.append({"t": t, "psnr_vs_gt_interp": psnr(out_t, gt_t),
                       "ssim_vs_gt_interp": ssim(out_t, gt_t)})
        strip.append(np.concatenate([gt_t, np.clip(out_t, 0, 1)], axis=0))
        print(f"interp t={t}: {interp[-1]['psnr_vs_gt_interp']:.2f} dB vs true "
              "intermediate face", flush=True)
    write_png(os.path.join(out_dir, f"{stem}_interp.png"), to8b(np.concatenate(strip, axis=1)))

    # ---- 4. expression control on held-out views: up to 3 views of up to 2
    # identities an expression; `wrong` renders the first other expression of the bank
    expr = []
    for exp in fc.exp_bank:
        wrong_exp = [e for e in fc.exp_bank if e != exp][0]
        own_vals, wrong_vals = [], []
        for pid_e in (a_pid, b_pid):
            matches = [i for i in test_idx[pid_e] if int(fc.ds.exp_types[i]) == exp][:3]
            for i in matches:
                gt = fc.gt(i)
                own_vals.append(psnr(render(fc.cond(pid_e, exp), fc.pose(i)), gt))
                wrong_vals.append(psnr(render(fc.cond(pid_e, wrong_exp), fc.pose(i)), gt))
        if not own_vals:
            continue
        expr.append({"exp": exp, "own_exp_psnr": float(np.mean(own_vals)),
                     "wrong_exp_psnr": float(np.mean(wrong_vals)),
                     "n_views": len(own_vals)})
        print(f"expression {exp}: own {expr[-1]['own_exp_psnr']:.2f} vs wrong "
              f"{expr[-1]['wrong_exp_psnr']:.2f} dB ({len(own_vals)} views)", flush=True)

    # ---- 5. expression-transfer matrix: every (identity, expression code) pair,
    # including those absent from the training views, against rasterized GT
    exp_matrix = []
    for pid in persons[: max(0, args.exp_matrix_ids)]:
        i0 = test_idx[pid][0]
        row = {"id": pid, "per_exp": {}}
        for exp in fc.exp_bank:
            gt_m = fc.raster_gt(fc.face_params[pid], exp, i0, res, cfg.white_bkgd)
            out_m = render(fc.cond(pid, exp), fc.pose(i0))
            if res != H:
                out_m = resize_area(out_m, (res, res))
            row["per_exp"][exp] = {"psnr": psnr(out_m, gt_m), "ssim": ssim(out_m, gt_m)}
        vals = [r["psnr"] for r in row["per_exp"].values()]
        row["mean_psnr"] = float(np.mean(vals))
        row["min_psnr"] = float(np.min(vals))
        print(f"exp matrix id {pid}: mean {row['mean_psnr']:.2f} dB min "
              f"{row['min_psnr']:.2f} dB over {len(vals)} exps", flush=True)
        exp_matrix.append(row)

    result = {
        "study": "one flagship-dims model over a synthetic identity family",
        "model": {"coarse": [cfg.netdepth, cfg.netwidth],
                  "fine": [cfg.netdepth_fine, cfg.netwidth_fine],
                  "n_samples": [cfg.N_samples, cfg.N_importance],
                  "step": int(step)},
        "dataset": {"n_ids": args.n_ids, "res": int(H), "expressions": fc.exp_bank,
                    "datadir": cfg.datadir},
        "recipe": {"lrate": cfg.lrate, "precrop_iters": cfg.precrop_iters,
                   "lm_frac": cfg.lm_frac, "lm_frac_anneal_iters": cfg.lm_frac_anneal_iters},
        "per_identity": per_identity,
        "mean_heldout_psnr": float(np.mean([v["psnr"] for v in per_identity.values()])),
        "mean_heldout_ssim": float(np.mean([v["ssim"] for v in per_identity.values()])),
        # 0.0 = healthy 3D geometry; ~1.0 = a degenerate near-plane curtain
        "mean_curtain_fraction": round(float(np.mean(
            [v["curtain_fraction"] for v in per_identity.values()])), 4),
        "cross_identity": cross,
        "identity_interpolation": interp,
        "expression_control": expr,
    }
    if exp_matrix:
        result["expression_transfer_matrix"] = exp_matrix
    result["device"] = _scenes.device_name(dev)
    _scenes.write_json(args.out_json, result)
    return result


if __name__ == "__main__":
    main()
