"""Multi-avatar student study: one distilled student, several identities
(counterpart of examples/distill_morphable.py of the JAX package).

`distill_avatars` distils one student conditioned on [shape ; modulated
expression] that serves every (identity, expression) pair; its code folds
to biases, so it serves through the same kernel as an unconditioned student.
On the two-identity scene (a cube and an octahedron):
1. train one teacher on both identities with distinct shape codes;
2. distil one avatar-conditioned student across both (the teacher's queries
   through the field kernel, one launch a step);
3. per identity: PSNR of the served render (`render_frame_serve`, the
   serving kernel) against the teacher's two-pass render of the same
   identity (own) and of the other (cross); own must beat cross by 3 dB and
   exceed 18 dB, or the code is ignored;
4. write the JSON.

Usage: python -m mofanerf_tpu_torch.examples.distill_morphable [--iters 3000] [--quick]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.distill import DistillConfig, avatar_code, distill_avatars
from mofanerf_tpu_torch.utils.device import to_device
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png

AABB_MIN, AABB_MAX = (-3.0,) * 3, (3.0,) * 3


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_distill_morph"))
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--distill_steps", type=int, default=9000)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--artifacts", default=None)
    p.add_argument("--quick", action="store_true", help="smoke size: no gates")
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.iters, args.distill_steps, args.res = 800, 500, 48

    # ---- two identities: a cube and an octahedron, distinct shape codes and UVs
    data_dir = os.path.join(args.out, "data")
    os.makedirs(data_dir, exist_ok=True)
    render_identity(0, {0: _scenes.cube(1.8)}, data_dir, res=args.res, device=dev)
    render_identity(1, {0: _scenes.octahedron()}, data_dir, res=args.res, device=dev)
    shape_codes = _scenes.one_hot_shape_codes()
    ds, H, W, K = _scenes.load_dataset(data_dir, [0, 1], shape_codes)

    if args.quick:
        spec = _scenes.teacher_spec((4, 32), (4, 64), n_samples=16)
        n_rand, dbatch = 512, 2048
    else:
        spec = _scenes.teacher_spec()
        n_rand, dbatch = _scenes.N_RAND, 8192
    sampler = _scenes.HostSampler(ds, seed=0)
    # distinct flat textures an identity, so that appearance follows the code too
    uvs = {0: _scenes.uv_tensor(0.7, dev), 1: _scenes.uv_tensor((0.2, 0.5, 0.8), dev)}

    def batch(i):
        ii, coords, target = sampler.draw(n_rand, int(n_rand * 0.6))
        return _scenes.make_batch(ds, K, ii, coords, target, ds.shape_codes[ii],
                                  ds.exp_types[ii], uvs[int(ds.id_codes[ii])], dev)

    state, teacher_secs, _ = _scenes.train_teacher(spec, 1e-3, batch, args.iters, dev)
    params = state.params

    # ---- the teacher's renders of each identity, from one test pose
    test_idx = {int(ds.id_codes[i]): int(i) for i in ds.i_split[2]}
    pose = ds.poses[test_idx[0]][:3]
    teachers, avatars = {}, []
    with torch.no_grad():
        for pid in (0, 1):
            shape = to_device(shape_codes[pid], dev)
            tex = encode_texture(params, spec, uvs[pid])
            avatars.append((shape, tex))
            cond = prepare_conditioning(params, spec, shape, exp_code_for(params, 0), tex)
            teachers[pid] = _scenes.np_maps(render_frame(params, spec, cond, H, W, K,
                                                         pose))["rgb"]

    # ---- one student across both avatars
    dcfg = DistillConfig(cond_dim=spec.shape_dim + spec.exp_dim, n_steps=args.distill_steps,
                         batch=dbatch, aabb_min=AABB_MIN, aabb_max=AABB_MAX)
    _scenes.sync(dev)
    t0 = time.perf_counter()
    st, scfg = distill_avatars(params, spec, avatars, dcfg, exp_ids=[0], seed=0,
                               log_every=max(1, args.distill_steps // 3))
    _scenes.sync(dev)
    secs = time.perf_counter() - t0

    serve_kw = dict(near=spec.render.near, far=spec.render.far, n_samples=32,
                    aabb_min=AABB_MIN, aabb_max=AABB_MAX, packet_size=1024, hit_fraction=1.0)
    c, f = spec.coarse, spec.fine
    results = {"teacher": f"{c.depth}x{c.width}+{f.depth}x{f.width} two-identity scene "
                          f"(cube/octa)",
               "student": f"{scfg.depth}x{scfg.width} cond_dim={scfg.cond_dim}",
               "distill_steps": args.distill_steps, "distill_secs": round(secs, 1),
               "per_identity": {}, "device": _scenes.device_name(dev)}
    os.makedirs(args.out, exist_ok=True)
    with torch.no_grad():
        for pid in (0, 1):
            code = avatar_code(params, avatars[pid][0], exp_code_for(params, 0))
            rgb = _scenes.np_maps(render_frame_serve(st.params, scfg, code, H, W, K, pose,
                                                     **serve_kw))["rgb"]
            write_png(os.path.join(args.out, f"avatar{pid}.png"), to8b(rgb))
            results["per_identity"][str(pid)] = {
                "own_psnr_db": round(_scenes.psnr(rgb, teachers[pid]), 2),
                "own_ssim": round(_scenes.ssim(rgb, teachers[pid]), 4),
                "cross_psnr_db": round(_scenes.psnr(rgb, teachers[1 - pid]), 2),
                "cross_ssim": round(_scenes.ssim(rgb, teachers[1 - pid]), 4),
            }
    timing = {"teacher_secs": teacher_secs,
              "teacher_steps_per_sec": _scenes.rate(args.iters, teacher_secs),
              "distill_secs": secs, "distill_steps_per_sec": _scenes.rate(args.distill_steps, secs)}
    _scenes.write_json(args.artifacts or os.path.join(args.out, "avatar_student_quality.json"),
                       results, timing)

    if not args.quick:
        for pid in ("0", "1"):
            r = results["per_identity"][pid]
            _scenes.gate(r["own_psnr_db"] > r["cross_psnr_db"] + 3, r)
            _scenes.gate(r["own_psnr_db"] > 18, r)
    print("MULTI-AVATAR STUDENT OK")
    return results, timing


if __name__ == "__main__":
    main()
