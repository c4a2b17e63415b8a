"""Expression-conditioned distillation study: one student, the whole bank
(counterpart of examples/distill_expression.py of the JAX package).

A code-conditioned student (models/student.py, cond_dim = exp_dim) is
distilled once over the expression simplex (`distill_expressions`); its code
folds to biases, so it serves through the same kernel as an unconditioned
student. On the two-expression scene (a small and a large cube):
1. train a two-expression teacher;
2. distil one conditioned student across both expressions;
3. per expression: PSNR of the served render against the teacher's
   two-pass render, beside an unconditioned per-expression student
   distilled with the same per-expression step budget;
4. the midpoint code must render geometry between the two expressions
   (coverage strictly between), which per-expression students cannot do;
5. write the JSON.
`--flagship` trains the teacher at reference dims (8x256 + 10x1024, bf16)
with the reference learning rate.

Usage: python -m mofanerf_tpu_torch.examples.distill_expression [--iters 2500] [--flagship]
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
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.distill import (DistillConfig, distill, distill_expressions,
                                              student_code)
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png

AABB_MIN, AABB_MAX = (-3.0,) * 3, (3.0,) * 3  # the large cube's verts at +-2.2


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_distill_exp"))
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--distill_steps", type=int, default=3000)
    p.add_argument("--student_width", type=int, default=128)
    p.add_argument("--student_depth", type=int, default=4)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--artifacts", default=None)
    p.add_argument("--quick", action="store_true", help="tiny budgets: no gates")
    p.add_argument("--flagship", action="store_true",
                   help="teacher at reference dims (8x256 + 10x1024 bf16, reference lr)")
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.iters, args.distill_steps, args.res = 800, 500, 48

    # ---- 1. the two-expression teacher (small cube: expression 0, large: 1)
    data_dir = os.path.join(args.out, "data")
    os.makedirs(data_dir, exist_ok=True)
    render_identity(0, _scenes.two_cubes(), data_dir, res=args.res, device=dev)
    ds, H, W, K = _scenes.load_dataset(data_dir, [0])

    if args.quick:
        spec = _scenes.teacher_spec((4, 32), (4, 64), n_samples=16)
        n_rand, dbatch, lrate = 512, 2048, 1e-3
    elif args.flagship:
        # reference dims need the reference lr (at 5e-4 the field is bistable)
        spec = _scenes.teacher_spec((8, 256), (10, 1024), compute_dtype=torch.bfloat16)
        n_rand, dbatch, lrate = _scenes.N_RAND, 8192, 5e-5
    else:
        spec = _scenes.teacher_spec()
        n_rand, dbatch, lrate = _scenes.N_RAND, 8192, 1e-3
    sampler = _scenes.HostSampler(ds, seed=0)
    uv = _scenes.uv_tensor(0.5, dev)
    zeros = np.zeros(50, np.float32)

    def batch(i):
        ii, coords, target = sampler.draw(n_rand, int(n_rand * 0.6))
        return _scenes.make_batch(ds, K, ii, coords, target, zeros, ds.exp_types[ii], uv, dev)

    state, teacher_secs, _ = _scenes.train_teacher(spec, lrate, batch, args.iters, dev)
    params = state.params
    shape = torch.zeros(50, device=dev)

    # ---- the teacher's renders on held-out poses, one an expression
    test_ids = [int(i) for i in ds.i_split[2][:2]]
    poses = {e: ds.poses[test_ids[e]][:3] for e in (0, 1)}
    teacher = {}
    with torch.no_grad():
        tex = encode_texture(params, spec, uv)
        conds = {e: prepare_conditioning(params, spec, shape, exp_code_for(params, e), tex)
                 for e in (0, 1)}
        for e in (0, 1):
            teacher[e] = _scenes.np_maps(render_frame(params, spec, conds[e], H, W, K,
                                                      poses[e]))

    serve_kw = dict(near=spec.render.near, far=spec.render.far, n_samples=32,
                    aabb_min=AABB_MIN, aabb_max=AABB_MAX, packet_size=1024, hit_fraction=1.0)

    def serve(st_params, cfg, code, pose):
        with torch.no_grad():
            return _scenes.np_maps(render_frame_serve(st_params, cfg, code, H, W, K, pose,
                                                      **serve_kw))

    # ---- 2. one conditioned student across the bank
    dcfg = DistillConfig(cond_dim=spec.exp_dim, n_steps=args.distill_steps,
                         depth=args.student_depth, width=args.student_width, batch=dbatch,
                         aabb_min=AABB_MIN, aabb_max=AABB_MAX)
    _scenes.sync(dev)
    t0 = time.perf_counter()
    st_c, cfg_c = distill_expressions(params, spec, shape, tex, dcfg, exp_ids=[0, 1], seed=0,
                                      log_every=max(1, args.distill_steps // 3))
    _scenes.sync(dev)
    cond_secs = time.perf_counter() - t0

    c, f = spec.coarse, spec.fine
    results = {"teacher": f"{c.depth}x{c.width}+{f.depth}x{f.width} two-expression cube scene",
               "conditioned_student": f"{cfg_c.depth}x{cfg_c.width} cond_dim={cfg_c.cond_dim}",
               "distill_steps": args.distill_steps, "cond_distill_secs": round(cond_secs, 1),
               "per_expression": {}, "interpolation": {}, "device": _scenes.device_name(dev)}

    codes = {e: student_code(params, shape, exp_code_for(params, e)) for e in (0, 1)}
    serve_frames = {}
    for e in (0, 1):
        out = serve(st_c.params, cfg_c, codes[e], poses[e])
        serve_frames[e] = out
        results["per_expression"][str(e)] = {
            "cond_psnr_vs_teacher_db": round(_scenes.psnr(out["rgb"], teacher[e]["rgb"]), 2),
            "cond_ssim_vs_teacher": round(_scenes.ssim(out["rgb"], teacher[e]["rgb"]), 4),
            "teacher_area": _scenes.area(teacher[e]["acc"]),
            "cond_area": _scenes.area(out["acc"]),
        }

    # ---- 3. the unconditioned per-expression baseline (the same per-expression budget)
    t0 = time.perf_counter()
    for e in (0, 1):
        ducfg = DistillConfig(n_steps=args.distill_steps // 2, batch=dbatch,
                              aabb_min=AABB_MIN, aabb_max=AABB_MAX)
        st_u, cfg_u = distill(params["fine"], spec.fine, conds[e].fine, ducfg, seed=e)
        out = serve(st_u.params, cfg_u, st_u.cond, poses[e])
        results["per_expression"][str(e)]["uncond_psnr_vs_teacher_db"] = round(
            _scenes.psnr(out["rgb"], teacher[e]["rgb"]), 2)
    _scenes.sync(dev)
    uncond_secs = time.perf_counter() - t0

    # ---- 4. interpolation: the midpoint code renders in-between geometry
    code_mid = student_code(params, shape,
                            0.5 * (exp_code_for(params, 0) + exp_code_for(params, 1)))
    out_mid = serve(st_c.params, cfg_c, code_mid, poses[0])
    a0 = _scenes.area(serve(st_c.params, cfg_c, codes[0], poses[0])["acc"])
    a1 = _scenes.area(serve(st_c.params, cfg_c, codes[1], poses[0])["acc"])
    am = _scenes.area(out_mid["acc"])
    results["interpolation"] = {"area_exp0": a0, "area_mid": am, "area_exp1": a1,
                                "monotone": bool(min(a0, a1) < am < max(a0, a1))}

    os.makedirs(args.out, exist_ok=True)
    for e, fr in serve_frames.items():
        write_png(os.path.join(args.out, f"cond_exp{e}.png"), to8b(fr["rgb"]))
    write_png(os.path.join(args.out, "cond_mid.png"), to8b(out_mid["rgb"]))
    timing = {"teacher_secs": teacher_secs,
              "teacher_steps_per_sec": _scenes.rate(args.iters, teacher_secs),
              "cond_distill_secs": cond_secs,
              "cond_distill_steps_per_sec": _scenes.rate(args.distill_steps, cond_secs),
              "uncond_secs": uncond_secs}
    _scenes.write_json(args.artifacts or os.path.join(args.out, "cond_student_quality.json"),
                       results, timing)

    pe = results["per_expression"]
    if not args.quick:  # the quick size is a smoke run: undertrained fields render mush
        _scenes.gate(results["interpolation"]["monotone"], "midpoint not in-between")
        for e in ("0", "1"):
            _scenes.gate(pe[e]["cond_psnr_vs_teacher_db"] > 18, pe)
    print("CONDITIONED STUDENT OK")
    return results, timing


if __name__ == "__main__":
    main()
