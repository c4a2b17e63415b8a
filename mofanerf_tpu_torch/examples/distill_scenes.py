"""Serving quality across structurally distinct scenes (counterpart of
examples/distill_scenes.py of the JAX package).

Repeats the teacher -> student -> serving pipeline on three scenes:
  shell    a thin anisotropic ellipsoid shell (density on a curved surface),
  concave  a torus and two offset spheres (rays that enter and leave density
           several times),
  face     a procedural head from datagen/synthetic_faces (nose and brow
           relief, eye and mouth indentations).
Per scene: train a two-pass teacher on a white background with softplus
density, gate it at 20 dB against the ground truth (retrying at a gentler
learning rate for longer), distil one per-avatar student, serve the held-out
views through the bounded serving path (the serving kernel), and measure
PSNR and SSIM against the teacher and the ground truth.

Writes `<out>/distill_scenes.json` (or `--artifacts`).

Usage: python -m mofanerf_tpu_torch.examples.distill_scenes [--iters 2000] [--quick]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.datagen.synthetic_faces import _sphere_topology, face_mesh
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.distill import DistillConfig, distill
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png

AABB_MIN, AABB_MAX = (-3.0,) * 3, (3.0,) * 3
GATE_DB, QUICK_GATE_DB = 20.0, 8.0   # a teacher's least PSNR against the ground truth


def _sphere(n_lat=28, n_lon=40):
    """The unit sphere (dirs, faces) of the lat-long topology."""
    dirs, faces, _ = _sphere_topology(n_lat, n_lon)
    return dirs, faces


def _torus(R=1.6, r=0.55, n_u=40, n_v=20):
    u = np.linspace(-np.pi, np.pi, n_u, endpoint=False)
    v = np.linspace(-np.pi, np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = r * np.sin(vv)
    z = (R + r * np.cos(vv)) * np.sin(uu)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)

    def vid(i, j):
        return (i % n_u) * n_v + (j % n_v)

    faces = []
    for i in range(n_u):
        for j in range(n_v):
            faces.append((vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)))
            faces.append((vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)))
    return verts, np.asarray(faces, dtype="int32")


def build_scenes():
    """name -> (verts, faces, face albedo or None)."""
    scenes = {}
    sv, sf = _sphere()
    scenes["shell"] = (sv * np.array([2.6, 1.6, 1.0]), sf, None)

    tv, tf = _torus()
    rot = np.array([[1, 0, 0], [0, 0.5, -np.sqrt(3) / 2], [0, np.sqrt(3) / 2, 0.5]])
    tv = tv @ rot.T
    s1v, s1f = _sphere(14, 20)
    s2v, s2f = _sphere(14, 20)
    verts = np.concatenate([tv, s1v * 0.6 + [1.4, 1.1, 0.6], s2v * 0.45 + [-1.3, -0.9, 0.9]])
    faces = np.concatenate([tf, s1f + len(tv), s2f + len(tv) + len(s1v)])
    scenes["concave"] = (verts, faces, None)

    p = np.array([0.4, -0.3, 0.2, 0.8, -0.5, 0.6, 0.1, -0.2, 0.7, 0.3])
    fv, ff, falb = face_mesh(p, expression=1)
    scenes["face"] = (fv, ff, falb)
    return scenes


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_distill_scenes"))
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--teacher_lr", type=float, default=5e-4,
                   help="teacher lr; 1e-3 collapses 2 of 3 scenes, 5e-4 with softplus "
                        "density holds all three")
    p.add_argument("--distill_steps", type=int, default=3000)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--n_samples", type=int, default=32)
    p.add_argument("--artifacts", default=None,
                   help="where to write the JSON (default <out>/distill_scenes.json)")
    p.add_argument("--quick", action="store_true")
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.iters, args.distill_steps, args.width = 150, 150, 24

    scene_rows, timing = [], {"scenes": []}
    gate_db = QUICK_GATE_DB if args.quick else GATE_DB
    os.makedirs(args.out, exist_ok=True)
    for sid, (name, (verts, faces, albedo)) in enumerate(build_scenes().items()):
        print(f"\n=== scene {name}: {len(verts)} verts {len(faces)} faces ===")
        data_dir = os.path.join(args.out, f"data_{name}{args.res}")
        os.makedirs(data_dir, exist_ok=True)
        render_identity(0, {0: (verts, faces, albedo)}, data_dir, res=args.res,
                        view_stride=4 if args.quick else 1, device=dev)
        ds, H, W, K = _scenes.load_dataset(data_dir, [0])

        # Two defences against collapse: a white background (on black, an
        # empty field matches most pixels for free and thin or concave scenes
        # collapse into it) and softplus density (ReLU's dead zone is an
        # absorbing state: once the raw density is negative everywhere its
        # gradient is exactly zero)
        spec = _scenes.teacher_spec((8, args.width), (8, args.width * 2), white_bkgd=True,
                                    sigma_activation="softplus")
        sampler = _scenes.HostSampler(ds, seed=sid, load=_scenes.load_white)
        uv = _scenes.uv_tensor(0.5, dev)
        zeros = np.zeros(50, np.float32)

        def batch_for(i):
            img_i, coords, target = sampler.draw(n_obj=int(_scenes.N_OBJ * min(1.0, i / 1000)))
            return _scenes.make_batch(ds, K, img_i, coords, target, zeros, 0, uv, dev)

        test_ids = [int(i) for i in ds.i_split[2][:4]]
        gts = {ti: _scenes.load_white(ds.image_paths[ti])[0] for ti in test_ids}

        def train_teacher(lr: float, seed: int, iters: int):
            state, secs, _ = _scenes.train_teacher(spec, lr, batch_for, iters, dev, seed=seed,
                                                   log_every=max(1, iters // 5), tag=name)
            with torch.no_grad():
                tex = encode_texture(state.params, spec, uv)
                cond = prepare_conditioning(state.params, spec, torch.zeros(50, device=dev),
                                            exp_code_for(state.params, 0), tex)
                t_renders = {ti: _scenes.np_maps(render_frame(
                    state.params, spec, cond, H, W, K, ds.poses[ti][:3]))["rgb"]
                    for ti in test_ids}
            gt_psnr = float(np.mean([_scenes.psnr(t_renders[t], gts[t]) for t in test_ids]))
            return state, cond, t_renders, gt_psnr, secs

        # The convergence gate: a teacher below the bar is a failed teacher,
        # and distilling it gives a vacuous "student matches an empty field"
        # row. Retry with a gentler lr for more steps; fail if every attempt
        # stays under the gate.
        schedule = [(args.teacher_lr, sid, args.iters),
                    (args.teacher_lr / 4, sid + 100, 2 * args.iters),
                    (args.teacher_lr / 8, sid + 200, 3 * args.iters)]
        attempts, teacher_secs, teacher_steps = [], 0.0, 0
        for lr_a, seed_a, iters_a in schedule:
            state, cond, t_renders, teacher_gt_psnr, secs = train_teacher(lr_a, seed_a, iters_a)
            teacher_secs, teacher_steps = teacher_secs + secs, teacher_steps + iters_a
            attempts.append({"lr": lr_a, "seed": seed_a, "iters": iters_a,
                             "teacher_psnr_vs_gt_db": round(teacher_gt_psnr, 2)})
            if teacher_gt_psnr >= gate_db:
                break
            print(f"[{name}] teacher FAILED gate ({teacher_gt_psnr:.1f} < {gate_db} dB): "
                  f"retrying")
        if teacher_gt_psnr < gate_db:
            raise RuntimeError(f"scene {name!r}: teacher failed to converge in "
                               f"{len(attempts)} attempts ({attempts}); refusing to distill "
                               f"a collapsed field")
        teacher_gt_ssim = float(np.mean([_scenes.ssim(t_renders[t], gts[t]) for t in test_ids]))

        box = dict(n_steps=args.distill_steps, aabb_min=AABB_MIN, aabb_max=AABB_MAX,
                   teacher_sigma_activation="softplus")
        dcfg = (DistillConfig(arch="mlp", depth=4, width=128, multires=8, **box)
                if not args.quick else
                DistillConfig(arch="mlp", depth=3, width=32, multires=6, batch=1024, **box))
        _scenes.sync(dev)
        t0 = time.perf_counter()
        st, scfg = distill(state.params["fine"], spec.fine, cond.fine, dcfg, seed=0,
                           log_every=max(1, args.distill_steps // 3))
        _scenes.sync(dev)
        distill_sec = time.perf_counter() - t0
        with torch.no_grad():
            s_renders = {ti: _scenes.np_maps(render_frame_serve(
                st.params, scfg, st.cond, H, W, K, ds.poses[ti][:3], n_samples=args.n_samples,
                aabb_min=AABB_MIN, aabb_max=AABB_MAX, white_bkgd=True, packet_size=4096,
                hit_fraction=1.0))["rgb"] for ti in test_ids}

        def mean(fn, a, b):
            return float(np.mean([fn(a[t], b[t]) for t in test_ids]))

        row = {
            "scene": name,
            "teacher_psnr_vs_gt_db": round(teacher_gt_psnr, 2),
            "teacher_ssim_vs_gt": round(teacher_gt_ssim, 4),
            "student_psnr_vs_teacher_db": round(mean(_scenes.psnr, s_renders, t_renders), 2),
            "student_ssim_vs_teacher": round(mean(_scenes.ssim, s_renders, t_renders), 4),
            "student_psnr_vs_gt_db": round(mean(_scenes.psnr, s_renders, gts), 2),
            "student_ssim_vs_gt": round(mean(_scenes.ssim, s_renders, gts), 4),
            "distill_sec": round(distill_sec, 1),
            "n_verts": int(len(verts)), "n_faces": int(len(faces)),
            "teacher_attempts": attempts,
        }
        scene_rows.append(row)
        timing["scenes"].append({
            "scene": name, "teacher_secs": teacher_secs,
            "teacher_steps_per_sec": _scenes.rate(teacher_steps, teacher_secs),
            "distill_secs": distill_sec,
            "distill_steps_per_sec": _scenes.rate(args.distill_steps, distill_sec)})
        print(f"[{name}] student vs teacher {row['student_psnr_vs_teacher_db']} dB / "
              f"SSIM {row['student_ssim_vs_teacher']}")
        write_png(os.path.join(args.out, f"{name}_teacher.png"), to8b(t_renders[test_ids[0]]))
        write_png(os.path.join(args.out, f"{name}_student.png"), to8b(s_renders[test_ids[0]]))

    vs_t = [r["student_psnr_vs_teacher_db"] for r in scene_rows]
    result = {
        "study": "per-avatar distillation quality across structurally distinct scenes "
                 "(thin shell / concave multi-object / procedural face)",
        "teacher": f"8x{args.width}+8x{args.width * 2}, {args.iters} iters, {args.res}^2",
        "student": ("mlp 4x128 mr8" if not args.quick else "mlp 3x32 mr6")
                   + f", {args.distill_steps} steps, {args.n_samples} bounded samples",
        "device": _scenes.device_name(dev),
        "white_bkgd": True,
        "sigma_activation": "softplus",
        "teacher_lr": args.teacher_lr,
        "teacher_gate_db": gate_db,
        "scenes": scene_rows,
        "psnr_vs_teacher_spread_db": [round(min(vs_t), 2), round(max(vs_t), 2)],
    }
    _scenes.write_json(args.artifacts or os.path.join(args.out, "distill_scenes.json"), result,
                       timing)
    return result, timing


if __name__ == "__main__":
    main()
