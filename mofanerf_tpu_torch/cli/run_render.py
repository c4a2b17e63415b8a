"""Orbit rendering CLI (counterpart of mofanerf_tpu/cli/run_render.py): the
teacher two-pass render, the occupancy-culled render, or a distilled student.

    # the teacher model (config flags as in mofanerf_tpu_torch/config.py)
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out \
        [--config configs/exp_mofanerf.txt] [--person 0] [--expression 0] \
        [--n_views 40] [--render_factor 2] [--device cuda]
    # through the training-maintained occupancy grid
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out --fast ...
    # distil a student once (saved to --student_path), then serve it
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out --distill \
        --student_path student.npz [--distill_steps 2000] [--n_samples 32] ...
    # an expression rig, or a morph across identities, of one student
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out --distill_cond \
        [--rig_expressions 9,14,2,16,17] --student_path rig.npz ...
    python -m mofanerf_tpu_torch.cli.run_render --out_dir out \
        --distill_avatars 0,1 --student_path avatars.npz ...

Renders `--n_views` poses on the spherical orbit and writes one PNG a frame.
The teacher's weights come from the newest checkpoint in `--ckpt_dir` (else
`basedir/expname/checkpoints`): a `.pt` of the port's training or of
`cli/convert_ckpt.py`, or a step the JAX package saved with Orbax; without
one it renders seeded, untrained weights and says so. The person's UV map
(`uvdir/<person>/1_neutral.jpg`) is encoded when it exists. The render
settings (near, far, background, density activation) are the config's on
every route; a student artifact's provenance overrides its box and near/far.

- Teacher (the default): both conditioned fields through the fused field
  kernel, 64 + 64 samples a ray.
- `--fast`: the fine field only, through the grid the training loop keeps in
  the checkpoint directory (`occupancy_grid.npz`; the coarse field is probed
  when there is none or it is more than half occupied), 32 samples a ray.
- `--distill` / `--distill_cond` / `--distill_avatars`: distil a student
  from the teacher (its queries through the fused field kernel), or load it
  from an existing `--student_path`, and serve it through the fused serving
  kernel. The sampling box comes from the maintained grid when there is one.
  `--student_path` alone serves an existing artifact; an unconditioned one
  needs no teacher.
On the card every packet runs the CUDA kernels; with `--device cpu` their
plain PyTorch versions run instead.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.config import Config, load_config
from mofanerf_tpu_torch.data.facescape import read_image
from mofanerf_tpu_torch.ops.bounds import DEFAULT_AABB_MAX, DEFAULT_AABB_MIN
from mofanerf_tpu_torch.ops.occupancy import (build_proposal_grid, grid_aabb, load_grid,
                                              render_frame_fast)
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.ops.serve_kernel import pack_student
from mofanerf_tpu_torch.render.renderer import (MoFaNeRF, encode_texture, exp_code_for,
                                                prepare_conditioning, render_path)
from mofanerf_tpu_torch.render.serve import render_frame_serve
from mofanerf_tpu_torch.train.checkpoint import load_model
from mofanerf_tpu_torch.train.distill import (DistillConfig, avatar_code, distill,
                                              distill_avatars, distill_expressions,
                                              distill_provenance, load_student, save_student,
                                              student_code)
from mofanerf_tpu_torch.utils.device import resolve_device
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


def _serving_camera(render_factor: int):
    rf = max(1, render_factor)
    side = 512 // rf
    K = np.array([[1200.0 / rf, 0, side / 2], [0, 1200.0 / rf, side / 2], [0, 0, 1]],
                 dtype=np.float32)
    return side, K


class _Teacher:
    """The teacher model of a run, loaded at first use: its params, and each
    person's (shape code, texture code)."""

    def __init__(self, args, cfg: Config, spec: MoFaNeRF, ckpt_dir: str):
        self.args, self.cfg, self.spec, self.ckpt_dir = args, cfg, spec, ckpt_dir
        self._params = None
        self._codes = {}

    @property
    def params(self):
        if self._params is None:
            params, step = load_model(self.ckpt_dir, self.spec, self.args.device)
            if step is not None:
                print(f"loaded checkpoint (step {step})")
            else:
                print("WARNING: rendering an untrained model")
            self._params = params
        return self._params

    @property
    def device(self) -> torch.device:
        return self.params["exp_codes"].device

    def person_codes(self, pid: int):
        """(shape code, texture code) of person `pid`: zeros where the
        identity factors or the UV map are missing."""
        if pid not in self._codes:
            cfg, spec, dev = self.cfg, self.spec, self.device
            shape = torch.zeros(spec.shape_dim, device=dev)
            if os.path.exists(cfg.shape_codes_path):
                # factors_id.npy: [persons, shape_dim] identity factors
                shape = torch.from_numpy(
                    np.load(cfg.shape_codes_path)[pid].astype(np.float32)).to(dev)
            tex = torch.zeros(spec.tex_dim, device=dev)
            uv_path = os.path.join(cfg.uvdir, str(pid), "1_neutral.jpg")
            if os.path.exists(uv_path):
                uv = read_image(uv_path, is_uvmap=True, uv_size=spec.uv_size)
                with torch.no_grad():
                    tex = encode_texture(self.params, spec, torch.from_numpy(uv).to(dev))
            self._codes[pid] = (shape, tex)
        return self._codes[pid]

    def cond(self):
        """The folded conditioning of --person at --expression."""
        shape, tex = self.person_codes(self.args.person)
        with torch.no_grad():
            return prepare_conditioning(self.params, self.spec, shape,
                                        exp_code_for(self.params, self.args.expression), tex)


def _render_teacher(args, teacher: _Teacher) -> np.ndarray:
    """The default route: the teacher's two-pass render of the orbit."""
    spec = teacher.spec
    cond = teacher.cond()
    t_start = time.perf_counter()
    rgbs, _ = render_path(teacher.params, spec, cond, _orbit(args.n_views), (512, 512, 1200.0),
                          render_factor=args.render_factor)
    seconds = time.perf_counter() - t_start
    print(f"rendered {len(rgbs)} teacher frames of {rgbs.shape[1]}x{rgbs.shape[2]} in "
          f"{seconds:.3f} s on {teacher.device}, packets of {spec.render.packet_size} rays")
    return rgbs


def _render_fast(args, teacher: _Teacher) -> np.ndarray:
    """--fast: the fine field through the training-maintained occupancy grid."""
    spec = teacher.spec
    cond = teacher.cond()
    grid_path = os.path.join(teacher.ckpt_dir, "occupancy_grid.npz")
    grid = None
    if os.path.exists(grid_path):
        grid, _ = load_grid(grid_path, device=teacher.device)
        occ_frac = float(grid.occ.float().mean())
        if occ_frac > 0.5:
            # a saturated grid culls nothing and respaces samples over the
            # whole [near, far]; grids of fine-field probes read as fog
            print(f"maintained grid {grid_path} is {occ_frac:.0%} occupied (stale "
                  "fine-probed?) — re-probing the coarse field")
            grid = None
        else:
            print(f"using training-maintained occupancy grid: {grid_path} "
                  f"({occ_frac:.1%} occupied)")
    if grid is None:
        grid = build_proposal_grid(teacher.params, spec, cond)
    side, K = _serving_camera(args.render_factor)
    t_start = time.perf_counter()
    rgbs = np.stack([
        render_frame_fast(teacher.params, spec, cond.fine, grid, side, side, K,
                          pose[:3])["rgb"].float().cpu().numpy()
        for pose in _orbit(args.n_views)])
    seconds = time.perf_counter() - t_start
    print(f"rendered {len(rgbs)} fast frames of {side}x{side} in {seconds:.3f} s on "
          f"{teacher.device}, packets of {spec.render.packet_size} rays")
    return rgbs


def _parse_ids(text: str, flag: str, what: str):
    ids = [int(s) for s in text.split(",") if s.strip()]
    if not ids:
        raise SystemExit(f"{flag}={text!r} parses to an empty list — pass comma-separated {what}")
    return ids


def _load_artifact(args, spec: MoFaNeRF, avatar_ids, box):
    """Load --student_path and hold it to the request: (params, cfg, box,
    avatar ids). An avatar artifact's ids are adopted when none were asked
    for; its provenance overrides the box and near/far."""
    path = args.student_path
    params, scfg, prov = load_student(path, with_provenance=True, device=args.device)
    print(f"loaded student artifact: {path}")
    if prov.get("avatar_ids") is not None and avatar_ids is None:
        avatar_ids = [int(v) for v in prov["avatar_ids"]]
        print(f"avatar ids from artifact: {avatar_ids}")
    if args.distill_cond and scfg.cond_dim != spec.exp_dim:
        raise SystemExit(
            f"--distill_cond rig needs an expression-conditioned student "
            f"(cond_dim={spec.exp_dim}) but {path} has cond_dim={scfg.cond_dim}")
    if avatar_ids and scfg.cond_dim != spec.shape_dim + spec.exp_dim:
        raise SystemExit(
            f"--distill_avatars needs a [shape ; exp]-conditioned student "
            f"(cond_dim={spec.shape_dim + spec.exp_dim}) but {path} has "
            f"cond_dim={scfg.cond_dim}")
    if not args.distill_cond and not avatar_ids and scfg.cond_dim not in (0, spec.exp_dim):
        raise SystemExit(
            f"artifact {path} has cond_dim={scfg.cond_dim}, which matches neither an "
            f"unconditioned (0) nor an expression-conditioned ({spec.exp_dim}) student — use "
            "--distill_avatars for [shape ; exp]-conditioned artifacts")
    if prov:
        # a student is untrained outside its distillation box: the
        # artifact's recorded bounds win
        aabb_min, aabb_max, near, far = box
        box = (tuple(prov.get("aabb_min", aabb_min)), tuple(prov.get("aabb_max", aabb_max)),
               float(prov.get("near", near)), float(prov.get("far", far)))
        print(f"serving AABB from artifact: {box[0]} .. {box[1]}")
        prov_person = prov.get("person")
        if prov_person is not None and int(prov_person) != args.person:
            raise SystemExit(
                f"artifact {path} was distilled for person {prov_person}, but "
                f"--person={args.person} was requested — the student's weights encode that "
                f"identity; re-distill (different --student_path) or pass --person {prov_person}")
        prov_avatars = prov.get("avatar_ids")
        if (prov_avatars is not None and avatar_ids is not None
                and [int(v) for v in prov_avatars] != avatar_ids):
            raise SystemExit(
                f"artifact {path} covers avatars {prov_avatars}, but "
                f"--distill_avatars={avatar_ids} was requested")
        # an expression-conditioned student takes the expression as a code;
        # any other was distilled at prov['expression'] and is untrained elsewhere
        prov_exp = prov.get("expression")
        if (prov_exp is not None and scfg.cond_dim != spec.exp_dim
                and int(prov_exp) != args.expression):
            raise SystemExit(
                f"artifact {path} was distilled at expression {prov_exp}, but "
                f"--expression={args.expression} was requested — the student is untrained "
                f"there; re-distill, or pass --expression {prov_exp}")
    return params, scfg, box, avatar_ids


def _distill_student(args, teacher: _Teacher, avatar_ids, box):
    """Distil the student the flags ask for from the teacher: (params, cfg),
    saved with its provenance to --student_path when that is given."""
    spec = teacher.spec
    aabb_min, aabb_max, near, far = box
    dcfg_kw = dict(n_steps=args.distill_steps, near=near, far=far, aabb_min=aabb_min,
                   aabb_max=aabb_max, teacher_sigma_activation=spec.render.sigma_activation)
    log_every = max(1, args.distill_steps // 4)
    params = teacher.params
    t_start = time.perf_counter()
    if avatar_ids:
        st, scfg = distill_avatars(
            params, spec, [teacher.person_codes(pid) for pid in avatar_ids],
            DistillConfig(cond_dim=spec.shape_dim + spec.exp_dim, **dcfg_kw),
            exp_ids=[args.expression], log_every=log_every)
    elif args.distill_cond:
        shape, tex = teacher.person_codes(args.person)
        st, scfg = distill_expressions(params, spec, shape, tex,
                                       DistillConfig(cond_dim=spec.exp_dim, **dcfg_kw),
                                       log_every=log_every)
    else:
        st, scfg = distill(params["fine"], spec.fine, teacher.cond().fine,
                           DistillConfig(**dcfg_kw), log_every=log_every)
    if teacher.device.type == "cuda":
        torch.cuda.synchronize(teacher.device)
    seconds = time.perf_counter() - t_start
    print(f"distilled {args.distill_steps} steps in {seconds:.3f} s "
          f"({args.distill_steps / seconds:.2f} steps/s, {seconds / args.distill_steps * 1e3:.3f} "
          f"ms a step) on {teacher.device}")
    if args.student_path:
        prov = distill_provenance(DistillConfig(cond_dim=scfg.cond_dim, **dcfg_kw),
                                  person=None if avatar_ids else args.person,
                                  expression=args.expression, avatar_ids=avatar_ids)
        save_student(args.student_path, st.params, scfg, provenance=prov)
        print(f"saved student artifact: {args.student_path}")
    return st.params, scfg


def _morph(n_frames: int, keys: list):
    """For each frame of an orbit, (i0, i1, a): the pair of keys it sits
    between and the weight of the second, sweeping the list once."""
    out = []
    for f in range(n_frames):
        t = f / max(1, n_frames - 1) * (len(keys) - 1)
        i0 = min(int(t), max(0, len(keys) - 2))
        out.append((keys[i0], keys[min(i0 + 1, len(keys) - 1)], t - i0))
    return out


def _render_student(args, teacher: _Teacher) -> np.ndarray:
    """The student routes: load --student_path or distil, then serve the orbit
    through the fused serving kernel, one code a frame for a rig or morph."""
    spec = teacher.spec
    avatar_ids = (_parse_ids(args.distill_avatars, "--distill_avatars", "person ids")
                  if args.distill_avatars else None)
    # the sampling box: tightened by the training-maintained grid when there is one
    aabb_min, aabb_max = DEFAULT_AABB_MIN, DEFAULT_AABB_MAX
    grid_path = os.path.join(teacher.ckpt_dir, "occupancy_grid.npz")
    if os.path.exists(grid_path):
        aabb_min, aabb_max = grid_aabb(load_grid(grid_path, device="cpu")[0])
        print(f"serving AABB from maintained grid: {aabb_min} .. {aabb_max}")
    box = (aabb_min, aabb_max, spec.render.near, spec.render.far)
    if args.student_path and os.path.exists(args.student_path):
        params, scfg, box, avatar_ids = _load_artifact(args, spec, avatar_ids, box)
    elif args.distill or args.distill_cond or avatar_ids:
        params, scfg = _distill_student(args, teacher, avatar_ids, box)
    else:
        raise SystemExit(f"no student artifact at {args.student_path!r}: pass --distill, "
                         "--distill_cond or --distill_avatars to distil one there")
    aabb_min, aabb_max, near, far = box

    poses = _orbit(args.n_views)
    if avatar_ids:
        # morph the shape code between the avatars across the orbit, the
        # expression fixed
        raw = exp_code_for(teacher.params, args.expression)
        codes = [avatar_code(teacher.params,
                             (1.0 - a) * teacher.person_codes(p0)[0]
                             + a * teacher.person_codes(p1)[0], raw)
                 for p0, p1, a in _morph(len(poses), avatar_ids)]
    elif args.distill_cond:
        # morph the raw expression latent through the rig list across the
        # orbit, ISM-modulated a frame
        rig = _parse_ids(args.rig_expressions, "--rig_expressions", "bank slot indices")
        shape = teacher.person_codes(args.person)[0]
        codes = [student_code(teacher.params, shape,
                              (1.0 - a) * exp_code_for(teacher.params, e0)
                              + a * exp_code_for(teacher.params, e1))
                 for e0, e1, a in _morph(len(poses), rig)]
    elif scfg.cond_dim > 0:
        # a conditioned artifact renders the requested --expression
        code = student_code(teacher.params, teacher.person_codes(args.person)[0],
                            exp_code_for(teacher.params, args.expression))
        codes = [code] * len(poses)
    else:
        codes = None

    side, K = _serving_camera(args.render_factor)
    pkt = min(16384, max(256, (side * side) // 4 // 256 * 256))
    kw = dict(near=near, far=far, n_samples=args.n_samples, packet_size=pkt,
              aabb_min=aabb_min, aabb_max=aabb_max, white_bkgd=spec.render.white_bkgd,
              hit_fraction=1.0)
    t_start = time.perf_counter()
    with torch.no_grad():
        # an unconditioned student's kernel weights are cast and tiled once for every view
        pack = pack_student(params, scfg) if codes is None else None
        rgbs = np.stack([
            render_frame_serve(params if pack is None else pack, scfg,
                               None if codes is None else codes[i], side, side, K, pose[:3],
                               **kw)["rgb"].float().cpu().numpy()
            for i, pose in enumerate(poses)])
    seconds = time.perf_counter() - t_start
    print(f"rendered {len(rgbs)} frames of {side}x{side} in {seconds:.3f} s on "
          f"{params['input']['w'].device}, packets of {pkt} rays")
    return rgbs


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the rendered frames [F, H, W, 3] (f32 in [0, 1]
    before quantisation) so callers can check them."""
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--person", type=int, default=0)
    p.add_argument("--expression", type=int, default=0)
    p.add_argument("--n_views", type=int, default=40)
    p.add_argument("--render_factor", type=int, default=2)
    p.add_argument("--fast", action="store_true",
                   help="occupancy-culled rendering through the training-maintained grid")
    p.add_argument("--distill", action="store_true",
                   help="distil a per-avatar student once, then serve the orbit from it")
    p.add_argument("--distill_cond", action="store_true",
                   help="distil one expression-conditioned student over the expression bank, "
                        "then render the orbit morphing through --rig_expressions")
    p.add_argument("--rig_expressions", default="9,14,2,16,17",
                   help="comma-separated bank slots the rig sweeps through")
    p.add_argument("--distill_avatars", default=None,
                   help="comma-separated person ids: distil one student across those "
                        "identities and render an orbit that morphs between them")
    p.add_argument("--distill_steps", type=int, default=2000)
    p.add_argument("--student_path", default=None,
                   help="student artifact (.npz): served when it exists, else distilled "
                        "once and saved there")
    p.add_argument("--n_samples", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the CUDA kernels run) or cpu")
    args, rest = p.parse_known_args(argv)
    resolve_device(args.device)
    cfg = load_config(rest)
    spec = cfg.model_spec()
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    teacher = _Teacher(args, cfg, spec, ckpt_dir)

    if args.student_path or args.distill or args.distill_cond or args.distill_avatars:
        rgbs = _render_student(args, teacher)
    elif args.fast:
        rgbs = _render_fast(args, teacher)
    else:
        rgbs = _render_teacher(args, teacher)
    _write_frames(args.out_dir, rgbs)
    return rgbs


if __name__ == "__main__":
    main()
