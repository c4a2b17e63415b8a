"""Serve the trained flagship morphable model end to end: checkpoint ->
per-identity expression-conditioned student -> bounded serving through the
serving kernel, with quality and throughput measured on the same artifact
(counterpart of examples/serve_flagship.py of the JAX package).

Per identity:
1. distil one expression-conditioned student (train/distill.py::
   distill_expressions over the trained bank; the teacher's queries through
   the field kernel), inside the serving box (probed from the current field
   per identity and united, or the checkpoint's kept grid, or the default);
2. render held-out views through the serving path (render/serve.py, the
   serving kernel on the card) with the rig code folded to biases;
3. score PSNR + SSIM against the teacher's two-pass frames (field kernel)
   and against GT;
then time 32 back-to-back serving-kernel launches of 65536 rays of a real
camera (CUDA events, one synchronisation at the end). The JAX script serves
through its kernel only on a TPU; here the kernel is the path whenever the
tensors are on the card.

Writes `--out_json` (default examples/artifacts/serve_flagship.json of this
package) and a GT | teacher | student PNG an identity beside it.

Usage (after morphable_flagship --stage train):
  python -m mofanerf_tpu_torch.examples.serve_flagship --white_bkgd
CPU smoke: --quick --small_model --device cpu (untrained tiny model).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.examples import _flagship, _scenes
from mofanerf_tpu_torch.ops.bounds import DEFAULT_AABB_MAX, DEFAULT_AABB_MIN
from mofanerf_tpu_torch.ops.rays import get_rays
from mofanerf_tpu_torch.render.renderer import exp_code_for, render_frame
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.distill import DistillConfig, distill_expressions, student_code
from mofanerf_tpu_torch.utils.device import to_device
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png

LOOP_RAYS, LOOP_SIDE, LOOP_LAUNCHES = 65536, 256, 32


def serving_box(args, cfg, spec, params, fc, persons, step):
    """(aabb_min, aabb_max) of --aabb_source: the union of boxes probed from the
    current field per identity (the kept grid's EMA can carry early fog), the
    checkpoint's kept grid, or the default box."""
    from mofanerf_tpu_torch.ops.occupancy import build_proposal_grid, grid_aabb, load_grid

    aabb_min, aabb_max = DEFAULT_AABB_MIN, DEFAULT_AABB_MAX
    grid_path = os.path.join(_flagship.ckpt_dir(cfg), "occupancy_grid.npz")
    if args.aabb_source == "grid" and os.path.exists(grid_path):
        g, _ = load_grid(grid_path, device=fc.dev)
        aabb_min, aabb_max = grid_aabb(g)
        print(f"serving AABB from maintained grid: {aabb_min} .. {aabb_max}")
    if args.aabb_source == "probe" and step is not None:
        lo_u = hi_u = None
        for pid in persons:
            with torch.no_grad():
                g = build_proposal_grid(params, spec, fc.cond(pid, fc.exp_bank[0]))
            lo_p, hi_p = (np.asarray(v, np.float64) for v in grid_aabb(g))
            lo_u = lo_p if lo_u is None else np.minimum(lo_u, lo_p)
            hi_u = hi_p if hi_u is None else np.maximum(hi_u, hi_p)
        aabb_min = tuple(float(v) for v in lo_u)
        aabb_max = tuple(float(v) for v in hi_u)
        print(f"serving AABB probed from current field (union over {len(persons)} ids): "
              f"{aabb_min} .. {aabb_max}")
    return tuple(float(v) for v in aabb_min), tuple(float(v) for v in aabb_max)


def main(argv=None):
    p = argparse.ArgumentParser()
    _flagship.add_model_flags(p)
    p.add_argument("--ids", default="0,1,2,3", help="identities to distill + measure")
    p.add_argument("--distill_steps", type=int, default=4000)
    p.add_argument("--n_samples", type=int, default=32)
    p.add_argument("--n_test_views", type=int, default=3)
    p.add_argument("--out_json", default=_flagship.artifact("serve_flagship.json"))
    p.add_argument("--quick", action="store_true")
    p.add_argument("--small_model", action="store_true")
    p.add_argument("--white_bkgd", action="store_true",
                   help="must match the checkpoint's training setting")
    p.add_argument("--aabb_source", choices=["probe", "grid", "default"], default="probe",
                   help="probe = a grid rebuilt from the current field per identity, the "
                        "union box; grid = the checkpoint's kept grid")
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.distill_steps = 120
        args.n_test_views = 1

    cfg = _flagship.data_config(args, white_bkgd=args.white_bkgd,
                                **(_flagship.SMALL_SERVE if args.small_model else {}))
    spec = cfg.model_spec()
    params, step = _flagship.restore(cfg, spec, dev)
    if step is not None:
        print(f"model checkpoint at step {step}")
    else:
        print("WARNING: serving an untrained model (smoke only)")

    persons = [int(s) for s in args.ids.split(",") if s.strip()]
    if not persons:
        raise SystemExit(f"--ids={args.ids!r} parses to an empty list: pass comma-separated "
                         "person ids")
    fc = _flagship.Faces(cfg, params, spec, range(args.n_ids), dev)
    H, W, K = fc.H, fc.W, fc.K
    near, far = spec.render.near, spec.render.far
    aabb_min, aabb_max = serving_box(args, cfg, spec, params, fc, persons, step)

    fused = dev.type == "cuda"
    dcfg = DistillConfig(cond_dim=spec.exp_dim, n_steps=args.distill_steps, near=near,
                         far=far, aabb_min=aabb_min, aabb_max=aabb_max,
                         teacher_sigma_activation=spec.render.sigma_activation)
    if args.quick:
        dcfg = dataclasses.replace(dcfg, width=32, depth=3, multires=6, batch=1024)

    def teacher_frame(c, pose):
        return _scenes.np_maps(render_frame(params, spec, c, H, W, K, pose))["rgb"]

    psnr, ssim = _scenes.psnr, _scenes.ssim
    rng = np.random.default_rng(1)
    out_dir = os.path.dirname(os.path.abspath(args.out_json))
    os.makedirs(out_dir, exist_ok=True)
    rows, distill_secs = [], []
    st = scfg = None
    pkt = min(16384, max(256, (H * W) // 4 // 256 * 256))
    for pid in persons:
        shape, tex = fc.shape(pid), fc.tex(pid)
        _scenes.sync(dev)
        t0 = time.perf_counter()
        st, scfg = distill_expressions(params, spec, shape, tex, dcfg, exp_ids=fc.exp_bank,
                                       log_every=max(1, args.distill_steps // 3))
        _scenes.sync(dev)
        distill_secs.append(time.perf_counter() - t0)

        picks = rng.choice(fc.test_idx[pid], size=min(args.n_test_views * len(fc.exp_bank),
                                                      len(fc.test_idx[pid])), replace=False)
        pt, pg, sst, ssg = [], [], [], []
        strip = teacher_gt = None
        for i in picks:
            gt = fc.gt(i)
            exp_i = int(fc.ds.exp_types[i])
            t_img = teacher_frame(fc.cond(pid, exp_i), fc.pose(i))
            with torch.no_grad():
                code = student_code(params, shape, exp_code_for(params, exp_i))
                s_img = render_frame_serve(
                    st.params, scfg, code, H, W, K, fc.pose(i), near=near, far=far,
                    n_samples=args.n_samples, aabb_min=aabb_min, aabb_max=aabb_max,
                    white_bkgd=spec.render.white_bkgd, packet_size=pkt, hit_fraction=1.0,
                    fused=fused)["rgb"].float().cpu().numpy()
            pt.append(psnr(s_img, t_img))
            pg.append(psnr(s_img, gt))
            sst.append(ssim(s_img, t_img))
            ssg.append(ssim(s_img, gt))
            if strip is None:
                strip = np.concatenate([gt, np.clip(t_img, 0, 1), np.clip(s_img, 0, 1)], axis=1)
                teacher_gt = psnr(t_img, gt)
        write_png(os.path.join(out_dir, f"serve_flagship_id{pid}.png"), to8b(strip))
        rows.append({
            "person": pid,
            "student_psnr_vs_teacher_db": round(float(np.mean(pt)), 2),
            "student_ssim_vs_teacher": round(float(np.mean(sst)), 4),
            "student_psnr_vs_gt_db": round(float(np.mean(pg)), 2),
            "student_ssim_vs_gt": round(float(np.mean(ssg)), 4),
            "teacher_psnr_vs_gt_db_first_view": round(teacher_gt, 2),
            "n_views": int(len(picks)),
            "distill_sec": round(distill_secs[-1], 1),
        })
        print(f"id {pid}: student vs teacher {rows[-1]['student_psnr_vs_teacher_db']} dB "
              f"(vs GT {rows[-1]['student_psnr_vs_gt_db']} dB), distilled in "
              f"{rows[-1]['distill_sec']}s", flush=True)

    # ---- the serving kernel's throughput on a real camera's rays (the last student)
    throughput, loop = None, None
    if fused:
        loop = throughput_loop(params, spec, fc, persons[-1], st, scfg, args.n_samples,
                               aabb_min, aabb_max, dev)
        throughput = round(loop["rays_per_sec"], 1)
        print(f"fused serving throughput (trained artifact): {throughput / 1e6:.2f}M rays/s",
              flush=True)

    result = {
        "study": "distill + fused-serve the TRAINED flagship morphable checkpoint per "
                 "identity (production configuration)",
        "model_step": int(step) if step is not None else 0,
        "student": f"mlp {dcfg.depth}x{dcfg.width} cond_dim={spec.exp_dim}, "
                   f"{args.distill_steps} steps, {args.n_samples} bounded samples, fused"
                   if not args.quick else "quick smoke",
        "aabb": {"min": list(aabb_min), "max": list(aabb_max), "source": args.aabb_source},
        "white_bkgd": bool(cfg.white_bkgd),
        "per_identity": rows,
        "mean_psnr_vs_teacher_db": round(float(np.mean(
            [r["student_psnr_vs_teacher_db"] for r in rows])), 2),
        "mean_ssim_vs_teacher": round(float(np.mean(
            [r["student_ssim_vs_teacher"] for r in rows])), 4),
        "fused_rays_per_sec": throughput,
        "device": _scenes.device_name(dev),
    }
    timing = {"distill_secs": distill_secs, "distill_steps": args.distill_steps,
              "throughput_loop": loop}
    _scenes.write_json(args.out_json, result, timing)
    return result, timing


def throughput_loop(params, spec, fc, pid, st, scfg, n_samples, aabb_min, aabb_max, dev):
    """LOOP_LAUNCHES back-to-back serving-kernel launches on the first LOOP_RAYS rays of
    a LOOP_SIDE^2 frame at identity `pid`'s first held-out camera (the student's code
    at the bank's first expression folded in), after one warm-up launch: CUDA events
    around the loop, one synchronisation at its end."""
    from mofanerf_tpu_torch.models.student import fold_student_code
    from mofanerf_tpu_torch.ops import serve_kernel as sk

    near, far = spec.render.near, spec.render.far
    focal = float(fc.K[0, 0])
    Ks = np.array([[focal * LOOP_SIDE / fc.H, 0, LOOP_SIDE / 2],
                   [0, focal * LOOP_SIDE / fc.H, LOOP_SIDE / 2], [0, 0, 1]], np.float32)
    ro, rd = get_rays(LOOP_SIDE, LOOP_SIDE, to_device(Ks, dev),
                      to_device(fc.pose(fc.test_idx[pid][0]), dev))
    ro = ro.reshape(-1, 3)[:LOOP_RAYS].contiguous()
    rd = rd.reshape(-1, 3)[:LOOP_RAYS].contiguous()
    with torch.no_grad():
        code = student_code(params, fc.shape(pid), exp_code_for(params, fc.exp_bank[0]))
        pack = sk.pack_student(fold_student_code(st.params, code), scfg)
    lo, hi = to_device(aabb_min, dev), to_device(aabb_max, dev)
    white = spec.render.white_bkgd

    def launch():
        return sk.render_rays_bounded_fused(pack, scfg, ro, rd, near, far, n_samples, lo, hi,
                                            white)

    with torch.no_grad():
        before = sk.launch_count
        launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        acc = torch.zeros((), device=dev)
        for _ in range(LOOP_LAUNCHES):
            acc = acc + launch()["rgb"][0].sum()
        end.record()
        float(acc)
    secs = start.elapsed_time(end) / 1e3
    return {"rays": LOOP_RAYS, "samples": n_samples, "launches": LOOP_LAUNCHES,
            "launches_counted": sk.launch_count - before, "secs": secs,
            "rays_per_sec": LOOP_LAUNCHES * LOOP_RAYS / secs,
            "student": [scfg.depth, scfg.width, scfg.multires]}


if __name__ == "__main__":
    main()
