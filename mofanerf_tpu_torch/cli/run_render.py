"""Orbit rendering CLI (counterpart of mofanerf_tpu/cli/run_render.py): the
teacher two-pass render, or serving from a student artifact.

    # the teacher model (config flags as in mofanerf_tpu_torch/config.py)
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out \
        [--config configs/exp_mofanerf.txt] [--person 0] [--expression 0] \
        [--n_views 40] [--render_factor 2] [--device cuda]
    # a distilled student artifact
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out \
        --student_path student.npz [--n_samples 32] ...

Renders `--n_views` poses on the spherical orbit and writes one PNG a frame.
Without `--student_path` the teacher renders: both conditioned fields
through the fused field kernel, 64 + 64 samples a ray. With it, the fused
serving renderer does. On the card every packet runs the CUDA kernels; with
`--device cpu` their plain PyTorch versions run instead.

The teacher's weights come from the newest `.pt` checkpoint of the port's
training (`--ckpt_dir`, else `basedir/expname/checkpoints`); without one it
renders seeded, untrained weights and says so. The person's UV map
(`uvdir/<person>/1_neutral.jpg`) is encoded when it exists.

Not ported yet, and refused with a message naming the ROADMAP item: the
JAX package's Orbax checkpoints (A3), `--fast` (occupancy grids, A6),
distilling a student (A4), and serving a conditioned artifact (cond_dim >
0: its code comes from the teacher checkpoint, A3).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import read_image
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.ops.serve_kernel import pack_student
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for, init_model_params,
                                                prepare_conditioning, render_path)
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.checkpoint import latest_step, orbax_steps, restore_checkpoint
from mofanerf_tpu_torch.train.distill import load_student
from mofanerf_tpu_torch.utils.image_io import write_png
from mofanerf_tpu_torch.utils.metrics import to8b


def _orbit(n_views: int) -> np.ndarray:
    return np.stack(
        [pose_spherical(a, 0.0, 16.0) for a in np.linspace(-180, 180, n_views + 1)[:-1]])


def _write_frames(out_dir: str, rgbs: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i, rgb in enumerate(rgbs):
        write_png(os.path.join(out_dir, f"{i:03d}.png"), to8b(rgb))
    print(f"wrote {len(rgbs)} frames (no video: the port writes PNG frames only)")


def _render_teacher(args, rest) -> np.ndarray:
    """The default route: the teacher's two-pass render of the orbit."""
    cfg = load_config(rest)
    spec = cfg.model_spec()
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    step = latest_step(ckpt_dir)
    if step is None and orbax_steps(ckpt_dir):
        raise SystemExit(
            f"{ckpt_dir} holds only Orbax checkpoints of the JAX package; the port reads "
            "its own .pt checkpoints, and an Orbax reader is ROADMAP A3 (queued under A11)")
    params = init_model_params(torch.Generator().manual_seed(0), spec, device=args.device)
    if step is not None:
        params = restore_checkpoint(ckpt_dir, params, step)
        print(f"loaded checkpoint (step {step})")
    else:
        print("WARNING: rendering an untrained model")
    dev = params["exp_codes"].device

    shape = torch.zeros(spec.shape_dim, device=dev)
    if os.path.exists(cfg.shape_codes_path):
        # factors_id.npy: [persons, shape_dim] identity factors
        shape = torch.from_numpy(
            np.load(cfg.shape_codes_path)[args.person].astype(np.float32)).to(dev)
    tex = torch.zeros(spec.tex_dim, device=dev)
    uv_path = os.path.join(cfg.uvdir, str(args.person), "1_neutral.jpg")
    if os.path.exists(uv_path):
        uv = read_image(uv_path, is_uvmap=True, uv_size=spec.uv_size)
        with torch.no_grad():
            tex = encode_texture(params, spec, torch.from_numpy(uv).to(dev))
    cond = prepare_conditioning(params, spec, shape, exp_code_for(params, args.expression), tex)

    poses = _orbit(args.n_views)
    t_start = time.perf_counter()
    rgbs, _ = render_path(params, spec, cond, poses, (512, 512, 1200.0),
                          render_factor=args.render_factor)
    seconds = time.perf_counter() - t_start
    print(f"rendered {len(rgbs)} teacher frames of {rgbs.shape[1]}x{rgbs.shape[2]} in "
          f"{seconds:.3f} s on {dev}, packets of {spec.render.packet_size} rays")
    _write_frames(args.out_dir, rgbs)
    return rgbs


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the rendered frames [F, H, W, 3] (f32 in [0, 1]
    before quantisation) so callers can check them."""
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--fast", action="store_true",
                   help="occupancy-culled rendering (not ported yet)")
    p.add_argument("--student_path", default=None,
                   help="deployable student artifact (.npz) to serve")
    p.add_argument("--person", type=int, default=0)
    p.add_argument("--expression", type=int, default=0)
    p.add_argument("--n_views", type=int, default=40)
    p.add_argument("--render_factor", type=int, default=2)
    p.add_argument("--n_samples", type=int, default=32)
    p.add_argument("--white_bkgd", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the CUDA kernel serves) or cpu")
    p.add_argument("--distill", action="store_true",
                   help="serve a student; with an existing --student_path this "
                        "serves the artifact")
    p.add_argument("--distill_cond", action="store_true")
    p.add_argument("--distill_avatars", default=None)
    args, rest = p.parse_known_args(argv)

    if args.distill_cond or args.distill_avatars:
        raise SystemExit(
            "--distill_cond/--distill_avatars distill and serve conditioned "
            "students from the teacher checkpoint; the port serves "
            "unconditioned artifacts only until the torch-free teacher "
            "checkpoint reader (ROADMAP A3) and distillation (ROADMAP A4) land"
        )
    if args.fast:
        raise SystemExit(
            "--fast renders through an occupancy grid, which is ported with the "
            "occupancy slice (ROADMAP A6)")
    if not args.student_path and not args.distill:
        return _render_teacher(args, rest)
    if not args.student_path or not os.path.exists(args.student_path):
        raise SystemExit(
            f"no student artifact at {args.student_path!r}: the port serves "
            "from an existing --student_path; distilling one needs the "
            "teacher and is ported with training (ROADMAP A4)"
        )

    params, scfg, prov = load_student(args.student_path, with_provenance=True,
                                      device=args.device)
    print(f"loaded student artifact: {args.student_path}")
    if scfg.cond_dim > 0:
        raise SystemExit(
            f"artifact {args.student_path} is conditioned (cond_dim="
            f"{scfg.cond_dim}): its code comes from the teacher checkpoint's "
            "ISM and expression bank, which the port reads once the "
            "torch-free teacher checkpoint reader lands (ROADMAP A3)"
        )
    from mofanerf_tpu_torch.ops.bounds import DEFAULT_AABB_MAX, DEFAULT_AABB_MIN

    aabb_min, aabb_max = DEFAULT_AABB_MIN, DEFAULT_AABB_MAX
    near, far = 8.0, 26.0
    if prov:
        # a student is untrained outside its distillation box: the
        # artifact's recorded bounds win
        aabb_min = tuple(prov.get("aabb_min", aabb_min))
        aabb_max = tuple(prov.get("aabb_max", aabb_max))
        near = float(prov.get("near", near))
        far = float(prov.get("far", far))
        print(f"serving AABB from artifact: {aabb_min} .. {aabb_max}")
        prov_person = prov.get("person")
        if prov_person is not None and int(prov_person) != args.person:
            raise SystemExit(
                f"artifact {args.student_path} was distilled for person "
                f"{prov_person}, but --person={args.person} was requested"
            )
        prov_exp = prov.get("expression")
        if prov_exp is not None and int(prov_exp) != args.expression:
            raise SystemExit(
                f"artifact {args.student_path} was distilled at expression "
                f"{prov_exp}, but --expression={args.expression} was requested"
            )

    poses = _orbit(args.n_views)
    rf = max(1, args.render_factor)
    H = W = 512 // rf
    K = np.array([[1200.0 / rf, 0, W / 2], [0, 1200.0 / rf, H / 2], [0, 0, 1]],
                 dtype=np.float32)
    pkt = min(16384, max(256, (H * W) // 4 // 256 * 256))
    frames = []
    t_start = time.perf_counter()
    pack = pack_student(params, scfg)   # the kernel's weights, cast and tiled once for every view
    for pose in poses:
        rgb = render_frame_serve(
            pack, scfg, None, H, W, K, pose[:3],
            near=near, far=far, n_samples=args.n_samples, packet_size=pkt,
            aabb_min=aabb_min, aabb_max=aabb_max, white_bkgd=args.white_bkgd,
            hit_fraction=1.0,
        )["rgb"]
        frames.append(rgb.float().cpu().numpy())
    seconds = time.perf_counter() - t_start
    rgbs = np.stack(frames)

    print(f"rendered {len(rgbs)} frames of {H}x{W} in {seconds:.3f} s on "
          f"{params['input']['w'].device}, packets of {pkt} rays")
    _write_frames(args.out_dir, rgbs)
    return rgbs


if __name__ == "__main__":
    main()
