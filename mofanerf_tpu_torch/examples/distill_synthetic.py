"""Distillation quality and throughput study: teacher -> student -> numbers
(counterpart of examples/distill_synthetic.py of the JAX package).

On synthetic data, no downloads:
1. renders a multiview cube dataset, trains a two-pass MoFaNeRF on it;
2. renders held-out views with the trained teacher (`render_frame`, the
   field kernel): the serving path's quality target;
3. builds the occupancy grid of the trained coarse field and renders the
   same views through the culled `render_frame_fast`; times a packet of
   8192 rays through `render_rays_occupancy`;
4. distils the conditioned fine field into per-avatar students at several
   capacities (train/distill.py; the teacher's queries through the field
   kernel);
5. renders the views through `render_frame_serve` at 16 and 32 samples,
   measures PSNR and SSIM against the teacher and the ground truth, and
   times a packet of 8192 rays. The students the serving kernel takes
   (skipless, width <= 128) run it; the two with skip layers and widths
   192 and 256 run the plain bounded render, as the JAX script serves every
   student through XLA. Times are CUDA events around 16 calls on the card.
Writes `<out>/distill_quality.json` (or `--artifacts`).

Usage: python -m mofanerf_tpu_torch.examples.distill_synthetic [--iters 2000] [--quick]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.ops.field_kernel import pack_fused_params
from mofanerf_tpu_torch.ops.occupancy import (build_proposal_grid, render_frame_fast,
                                              render_rays_occupancy)
from mofanerf_tpu_torch.ops.rays import get_rays
from mofanerf_tpu_torch.ops.serve_kernel import pack_student, render_rays_bounded_fused, takes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.render.serve import render_frame_serve, render_rays_bounded
from mofanerf_tpu_torch.train.distill import DistillConfig, distill
from mofanerf_tpu_torch.utils.device import to_device
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png

AABB_MIN, AABB_MAX = (-2.2,) * 3, (2.2,) * 3  # cube verts at +-1.6


def students(args) -> dict:
    """The distilled students: three capacities, or one tiny one with --quick."""
    box = dict(n_steps=args.distill_steps, aabb_min=AABB_MIN, aabb_max=AABB_MAX)
    if args.quick:
        return {"mlp_32x3_mr6": DistillConfig(arch="mlp", depth=3, width=32, multires=6,
                                              batch=1024, **box)}
    return {
        "mlp_128x4_mr8": DistillConfig(arch="mlp", depth=4, width=128, multires=8, **box),
        "mlp_192x6_mr8": DistillConfig(arch="mlp", depth=6, width=192, skip=3, multires=8,
                                       **box),
        "mlp_256x8_mr10": DistillConfig(arch="mlp", depth=8, width=256, skip=4, multires=10,
                                        **box),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=_scenes.default_out("mofanerf_distill"))
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--distill_steps", type=int, default=3000)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--artifacts", default=None,
                   help="where to write the quality JSON (default <out>/distill_quality.json)")
    p.add_argument("--quick", action="store_true", help="one tiny student, S=16 only")
    p.add_argument("--flagship", action="store_true",
                   help="teacher at reference dims (8x256 coarse + 10x1024 fine, bf16)")
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)

    # ---- 1. dataset + teacher training (the scene of train_synthetic)
    data_dir = os.path.join(args.out, "data")
    os.makedirs(data_dir, exist_ok=True)
    render_identity(0, {0: _scenes.cube(1.6)}, data_dir, res=args.res, device=dev)
    ds, H, W, K = _scenes.load_dataset(data_dir, [0])
    if args.flagship:
        spec = _scenes.teacher_spec((8, 256), (10, 1024), compute_dtype=torch.bfloat16)
        teacher_desc = "8x256+10x1024 bf16 (reference dims)"
        # flagship width needs the reference lr: at 5e-4 the field is bistable
        lrate = 5e-5
    else:
        spec = _scenes.teacher_spec((8, args.width), (8, args.width * 2))
        teacher_desc = f"8x{args.width}+8x{args.width * 2}"
        lrate = 1e-3
    sampler = _scenes.HostSampler(ds, seed=0)
    uv = _scenes.uv_tensor(0.5, dev)
    zeros = np.zeros(50, np.float32)

    def batch_for(i=0):
        # the object bias annealed in over 1000 steps: full bias from step 0
        # risks the fog basin at large widths
        img_i, coords, target = sampler.draw(n_obj=int(_scenes.N_OBJ * min(1.0, i / 1000)))
        return _scenes.make_batch(ds, K, img_i, coords, target, zeros, 0, uv, dev)

    state, teacher_secs, _ = _scenes.train_teacher(spec, lrate, batch_for, args.iters, dev,
                                                   log_every=200)
    params = state.params
    timing = {"students": [], "occupancy_packet_ms": {}}
    with torch.no_grad():
        tex = encode_texture(params, spec, uv)
        cond = prepare_conditioning(params, spec, torch.zeros(50, device=dev),
                                    exp_code_for(params, 0), tex)

    # ---- 2. teacher renders on held-out views
    test_ids = [int(i) for i in ds.i_split[2][:4]]
    teacher_renders, gts = {}, {}
    for ti in test_ids:
        teacher_renders[ti] = _scenes.np_maps(render_frame(params, spec, cond, H, W, K,
                                                           ds.poses[ti][:3]))["rgb"]
        gts[ti] = _scenes.load_rgb(ds.image_paths[ti])[0]
    teacher_vs_gt = float(np.mean([_scenes.psnr(teacher_renders[t], gts[t]) for t in test_ids]))
    teacher_ssim_gt = float(np.mean([_scenes.ssim(teacher_renders[t], gts[t])
                                     for t in test_ids]))
    print(f"[TEACHER] held-out PSNR vs GT: {teacher_vs_gt:.2f} dB over {len(test_ids)} views")

    # ---- 2b. the occupancy-culled path on the trained coarse field's grid
    with torch.no_grad():
        grid = build_proposal_grid(params, spec, cond, resolution=64, aabb_min=AABB_MIN,
                                   aabb_max=AABB_MAX, density_threshold=1.0)
        occ_frac = float(grid.occ.float().mean())
        fused_fine = pack_fused_params(params["fine"], cond.fine, spec.fine)
        ro_f, rd_f = get_rays(H, W, to_device(K, dev), to_device(ds.poses[test_ids[0]][:3], dev))
        reps = max(1, 8192 // (H * W) + 1)
        ro8 = ro_f.reshape(-1, 3).repeat(reps, 1)[:8192]
        rd8 = rd_f.reshape(-1, 3).repeat(reps, 1)[:8192]
    occ_quality = {}
    for keep in (16, 32):
        with torch.no_grad():
            pv = float(np.mean([
                _scenes.psnr(_scenes.np_maps(render_frame_fast(
                    params, spec, cond.fine, grid, H, W, K, ds.poses[t][:3], s_probe=64,
                    k_keep=keep, hit_fraction=1.0))["rgb"], teacher_renders[t])
                for t in test_ids]))
            ms = _scenes.timed_ms(lambda: render_rays_occupancy(
                params["fine"], spec.fine, cond.fine, grid, ro8, rd8, 8.0, 26.0, 64, keep,
                fused=fused_fine), dev)
        timing["occupancy_packet_ms"][f"keep{keep}"] = ms
        occ_quality[f"keep{keep}"] = {"psnr_vs_teacher_db": round(pv, 2),
                                      "rays_per_sec": round(8192 / (ms / 1e3), 1)}
        print(f"[OCC keep={keep}] PSNR vs two-pass {pv:.2f} dB, {8192 / ms:.1f}k rays/s "
              f"(real grid, occ {occ_frac:.3f})")

    # ---- 3/4. distil the students, render and measure
    sample_counts = (16,) if args.quick else (16, 32)
    rows = []
    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    rd = torch.randn((8192, 3), generator=gen, device=dev)
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    ro = torch.zeros((8192, 3), device=dev)
    for name, dcfg in students(args).items():
        _scenes.sync(dev)
        t0 = time.perf_counter()
        st, scfg = distill(params["fine"], spec.fine, cond.fine, dcfg, seed=0, log_every=1000)
        _scenes.sync(dev)
        distill_sec = time.perf_counter() - t0
        fused = takes(scfg)
        with torch.no_grad():
            pack = pack_student(st.params, scfg) if fused else None
            for S in sample_counts:
                renders = {ti: _scenes.np_maps(render_frame_serve(
                    st.params, scfg, st.cond, H, W, K, ds.poses[ti][:3], n_samples=S,
                    aabb_min=AABB_MIN, aabb_max=AABB_MAX, packet_size=4096, hit_fraction=1.0,
                    fused=fused))["rgb"] for ti in test_ids}
                p_teacher = float(np.mean([_scenes.psnr(renders[t], teacher_renders[t])
                                           for t in test_ids]))
                p_gt = float(np.mean([_scenes.psnr(renders[t], gts[t]) for t in test_ids]))
                s_teacher = float(np.mean([_scenes.ssim(renders[t], teacher_renders[t])
                                           for t in test_ids]))
                s_gt = float(np.mean([_scenes.ssim(renders[t], gts[t]) for t in test_ids]))

                # a packet of 8192 rays from the origin, random directions (the
                # JAX script's packet)
                if fused:
                    packet = lambda _s=S: render_rays_bounded_fused(   # noqa: E731
                        pack, scfg, ro, rd, 8.0, 26.0, _s, AABB_MIN, AABB_MAX)
                else:
                    packet = lambda _s=S: render_rays_bounded(          # noqa: E731
                        st.params, scfg, st.cond, ro, rd, 8.0, 26.0, _s, AABB_MIN, AABB_MAX)
                ms = _scenes.timed_ms(packet, dev)
                rows.append({
                    "student": name, "samples": S,
                    "psnr_vs_teacher_db": round(p_teacher, 2),
                    "psnr_vs_gt_db": round(p_gt, 2),
                    "ssim_vs_teacher": round(s_teacher, 4),
                    "ssim_vs_gt": round(s_gt, 4),
                    "rays_per_sec": round(8192 / (ms / 1e3), 1),
                    "distill_sec": round(distill_sec, 1),
                })
                timing["students"].append({"student": name, "samples": S,
                                           "serving_kernel": fused, "packet_ms": ms,
                                           "distill_steps_per_sec":
                                               _scenes.rate(dcfg.n_steps, distill_sec)})
                print(f"[STUDENT {name} S={S}] PSNR vs teacher {p_teacher:.2f} dB, "
                      f"vs GT {p_gt:.2f} dB, {8192 / ms / 1e3:.2f}M rays/s "
                      f"({'serving kernel' if fused else 'plain'})")
                if S == sample_counts[-1]:
                    write_png(os.path.join(args.out, f"{name}.png"),
                              to8b(renders[test_ids[0]]))
    write_png(os.path.join(args.out, "teacher.png"), to8b(teacher_renders[test_ids[0]]))
    write_png(os.path.join(args.out, "gt.png"), to8b(gts[test_ids[0]]))

    result = {
        "scene": f"synthetic cube {args.res}x{args.res}, teacher "
                 f"{teacher_desc}, {args.iters} iters",
        "teacher_psnr_vs_gt_db": round(teacher_vs_gt, 2),
        "teacher_ssim_vs_gt": round(teacher_ssim_gt, 4),
        "device": _scenes.device_name(dev),
        "occupancy_real_grid": {"occ_fraction": round(occ_frac, 4), **occ_quality},
        "students": rows,
    }
    timing.update(teacher_secs=teacher_secs,
                  teacher_steps_per_sec=_scenes.rate(args.iters, teacher_secs))
    _scenes.write_json(args.artifacts or os.path.join(args.out, "distill_quality.json"), result,
                       timing)
    return result, timing


if __name__ == "__main__":
    main()
