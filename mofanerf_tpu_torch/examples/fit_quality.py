"""Fitting as a measured capability: recover known codes and pose from one
image (counterpart of examples/fit_quality.py of the JAX package).

The target view is rendered from the trained flagship model itself at known
codes and pose (the field kernel on the card); the fit (train/fit_loop.py,
its previews and views through the field kernel) starts from random codes and
a pose rotated by up to `--pose_jitter_deg` and moved by up to 0.4, and the
script reads

- the fitted render's PSNR/SSIM against the target,
- code recovery (identity dims 0..9, the dims the procedural family spans; the
  other 40 are reported apart),
- pose recovery (geodesic rotation error, camera-centre distance), with the
  gate that the rotation error fell,
- the light scale (true scale 1),
then runs the reference's two render-only modes on the fitted codes
("rendering" novel views, "rendering_modulation" expression rig).

Writes `--out_json` (default examples/artifacts/fit_quality.json of this
package) and the target / fitted / novel-view PNGs under `--out_dir`.

Usage (after morphable_flagship --stage train):
  python -m mofanerf_tpu_torch.examples.fit_quality --white_bkgd
CPU smoke: --quick --small_model --device cpu.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.synthetic_faces import face_landmarks
from mofanerf_tpu_torch.examples import _flagship, _scenes
from mofanerf_tpu_torch.render.renderer import exp_code_for, init_model_params, render_frame
from mofanerf_tpu_torch.train.fit import FitConfig, render_fit_frame
from mofanerf_tpu_torch.train.fit_loop import fit, render_modulation, render_novel_views
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def rot_y(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def rot_x(a):
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])


def perturbed_pose(pose_true: np.ndarray, jitter_deg: float) -> np.ndarray:
    """The fit's initial pose: rotated about x then y by uniform draws within the
    jitter, moved by uniform draws within 0.4 (np.random.default_rng(3), the JAX
    script's draws)."""
    rng = np.random.default_rng(3)
    ang = np.deg2rad(jitter_deg)
    rx, ry = rng.uniform(-ang, ang, 2)
    pose_init = pose_true.copy()
    pose_init[:3, :3] = rot_y(ry) @ rot_x(rx) @ pose_true[:3, :3]
    pose_init[:3, 3] = pose_true[:3, 3] + rng.uniform(-0.4, 0.4, 3)
    return pose_init


def project_kp(lm3: np.ndarray, K: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """[68, 2] (row, col) of 3D landmarks seen through (K, c2w pose)."""
    Rt, t = pose[:3, :3], pose[:3, 3]
    pc = (lm3 - t) @ Rt
    z = -pc[:, 2]
    px = K[0, 2] + K[0, 0] * pc[:, 0] / z
    py = K[1, 2] - K[1, 1] * pc[:, 1] / z
    return np.stack([py, px], -1)


def rot_err_deg(a: np.ndarray, b: np.ndarray) -> float:
    R = a[:3, :3] @ b[:3, :3].T
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def main(argv=None):
    p = argparse.ArgumentParser()
    _flagship.add_model_flags(p)
    p.add_argument("--person", type=int, default=2)
    p.add_argument("--expression", type=int, default=1)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--out_dir", default=_scenes.default_out("mofanerf_fit_study"))
    p.add_argument("--out_json", default=_flagship.artifact("fit_quality.json"))
    p.add_argument("--pose_jitter_deg", type=float, default=6.0)
    p.add_argument("--pose_freeze_iters", type=int, default=300,
                   help="codes-only warm-up before the pose unfreezes (train/fit.py fit_step)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--small_model", action="store_true")
    p.add_argument("--white_bkgd", action="store_true",
                   help="must match the checkpoint's training setting")
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.iters = 60

    cfg = _flagship.data_config(args, white_bkgd=args.white_bkgd,
                                **(_flagship.SMALL_SERVE if args.small_model else {}))
    spec = cfg.model_spec()
    if args.small_model:   # never restores: the small model runs on its seeded weights
        params, step = init_model_params(torch.Generator().manual_seed(0), spec, device=dev), None
    else:
        params, step = _flagship.restore(cfg, spec, dev)
    if step is not None:
        print(f"model checkpoint at step {step}")
    else:
        print("WARNING: fitting against an untrained model (smoke only; --small_model never "
              "restores the flagship checkpoint)")

    fc = _flagship.Faces(cfg, params, spec, range(args.n_ids), dev)
    H, W, K = fc.H, fc.W, fc.K
    focal = float(K[0, 0])

    # ---- ground truth: a held-out pose of the chosen identity and expression
    pid, exp_id = args.person, args.expression
    test_i = [int(i) for i in fc.ds.i_split[2]
              if int(fc.ds.id_codes[i]) == pid and int(fc.ds.exp_types[i]) == exp_id]
    if not test_i:
        raise SystemExit(f"no held-out view of person {pid} at expression {exp_id}")
    pose_true = np.asarray(fc.ds.poses[test_i[0]], np.float32)
    shape_true, exp_true = fc.shape(pid), exp_code_for(params, exp_id)
    target = _scenes.np_maps(render_frame(params, spec, fc.cond(pid, exp_id), H, W, K,
                                          pose_true[:3]))["rgb"]
    target = np.clip(target, 0.0, 1.0)

    # ---- the perturbed initial pose, and the identity's 68 landmarks through (K, pose)
    pose_init = perturbed_pose(pose_true, args.pose_jitter_deg)
    kp2d = project_kp(face_landmarks(fc.face_params[pid], exp_id), K, pose_true)

    fcfg = FitConfig(
        n_iters=args.iters, n_rand=1024 if not args.quick else 256, H=H, W=W, focal=focal,
        change_epoch=(0, 600, 1000, 1300, 1500) if not args.quick else (0, 10, 20, 30, 40),
        preview_every=500 if not args.quick else 50,
        pose_freeze_iters=(args.pose_freeze_iters if not args.quick
                           else min(args.pose_freeze_iters, 10)))
    _scenes.sync(dev)
    t0 = time.perf_counter()
    fstate = fit(params, spec, target, pose_init, kp2d, args.out_dir, cfg=fcfg, seed=1)
    _scenes.sync(dev)
    fit_secs = time.perf_counter() - t0

    # ---- measurements
    codes = fstate.codes
    fitted = _scenes.np_maps(render_fit_frame(params, spec, codes, H, W, K))["rgb"]
    fitted = np.clip(fitted, 0, 1)
    write_png(os.path.join(args.out_dir, "fitted_final.png"), to8b(fitted))
    write_png(os.path.join(args.out_dir, "target_final.png"), to8b(target))

    as_np = lambda t: t.detach().float().cpu().numpy()
    shape_fit, shape_t = as_np(codes.shape), as_np(shape_true)
    id_dims = 10   # the dims the procedural family spans
    err_id = float(np.linalg.norm(shape_fit[:id_dims] - shape_t[:id_dims]))
    norm_id = float(np.linalg.norm(shape_t[:id_dims]))
    exp_t = as_np(exp_true)
    err_exp = float(np.linalg.norm(as_np(codes.exp) - exp_t))
    pose_fit = as_np(codes.pose)
    ang_err, ang0 = rot_err_deg(pose_fit, pose_true), rot_err_deg(pose_init, pose_true)
    t_err = float(np.linalg.norm(pose_fit[:3, 3] - pose_true[:3, 3]))
    t0_err = float(np.linalg.norm(pose_init[:3, 3] - pose_true[:3, 3]))

    # the reference's render-only modes on the fitted codes
    render_novel_views(params, spec, codes, os.path.join(args.out_dir, "rendering"), cfg=fcfg)
    render_modulation(params, spec, codes, os.path.join(args.out_dir, "rendering_modulation"),
                      exp_bank=params["exp_codes"], cfg=fcfg)

    result = {
        "study": "fit known-truth target rendered from the trained flagship morphable model; "
                 "random code init + perturbed pose",
        "model_step": int(step) if step is not None else 0,
        "target": {"person": pid, "expression": exp_id, "res": int(H),
                   "pose_jitter_deg": args.pose_jitter_deg},
        "schedule": {"iters": args.iters, "n_rand": fcfg.n_rand,
                     "pyramid_change_epoch": list(fcfg.change_epoch)},
        "fitted_psnr_db": round(_scenes.psnr(fitted, target), 2),
        "fitted_ssim": round(_scenes.ssim(fitted, target), 4),
        "code_recovery": {
            "shape_err_id_dims": round(err_id, 4),
            "shape_norm_id_dims": round(norm_id, 4),
            "shape_rel_err_id_dims": round(err_id / max(norm_id, 1e-9), 4),
            "shape_err_unused_dims": round(float(np.linalg.norm(
                shape_fit[id_dims:] - shape_t[id_dims:])), 4),
            "exp_err": round(err_exp, 4),
            "exp_norm_true": round(float(np.linalg.norm(exp_t)), 4),
            "note": "dims 10..49 never vary in the training family; the field's response "
                    "there is untrained, so only dims 0..9 are identifiable",
        },
        "pose_recovery": {
            "init_rot_err_deg": round(ang0, 3),
            "fitted_rot_err_deg": round(ang_err, 3),
            "init_trans_err": round(t0_err, 4),
            "fitted_trans_err": round(t_err, 4),
            "pose_freeze_iters": fcfg.pose_freeze_iters,
            "pose_improved": bool(ang_err < ang0),
        },
        "light_scale": {"true": 1.0, "fitted": round(float(codes.light[0]), 4)},
        "outputs": {"dir": args.out_dir, "modes": ["rendering", "rendering_modulation"]},
        "device": _scenes.device_name(dev),
    }
    timing = {"fit_secs": fit_secs, "fit_steps_per_sec": _scenes.rate(args.iters + 1, fit_secs)}
    _scenes.write_json(args.out_json, result, timing)
    # the bar: the fit must recover the pose, not trade it away; the JSON above is
    # written either way
    if not args.quick:
        _scenes.gate(ang_err < ang0, f"pose regression: rot error {ang0:.2f} -> "
                                     f"{ang_err:.2f} deg")
    return result, timing


if __name__ == "__main__":
    main()
