"""RefineNet training-corpus renderer (counterpart of
mofanerf_tpu/cli/render_refine_trainset.py):

    python -m mofanerf_tpu_torch.cli.render_refine_trainset --out_dir corpus \
        [--ckpt_dir dir] [--begin_person 0] [--end_person N] [--exp_num 10] \
        [--view_num 8] [--res 256] [--seed 0] [--fast] [--device cuda] [config flags]

For each identity x `exp_num` random expressions x `view_num` random views
of the dataset's train split, renders the teacher at that frame's pose into
`<out>/<id>/<exp>/<view>.png` and records the frame it stands for in
`<out>/gt_manifest.json` (for `prepare_refine_trainset`). The draws are the
JAX package's, from `np.random.default_rng(seed)` in the same order.
Identities whose directory exists are skipped (resume); `--begin_person` /
`--end_person` shard the identity range.

Each frame renders through `render_frame` (the fused field kernel on the
card, at the teacher's packet shapes); `--fast` builds a grid of the coarse
field once per (identity, expression) and renders through
`render_frame_fast` (the fine field through the kernel at 32 samples a ray).
The teacher is the newest checkpoint (a `.pt`, or the JAX package's Orbax
step) in `--ckpt_dir` (else `basedir/expname/checkpoints`), or seeded
weights with a WARNING.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import (load_facescape_data, load_shape_codes, read_image,
                                               valid_persons)
from mofanerf_tpu_torch.ops.occupancy import build_proposal_grid, render_frame_fast
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.train.checkpoint import load_model
from mofanerf_tpu_torch.utils.device import resolve_device
from mofanerf_tpu_torch.utils.image_io import write_png
from mofanerf_tpu_torch.utils.metrics import to8b


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--begin_person", type=int, default=0)
    p.add_argument("--end_person", type=int, default=None)
    p.add_argument("--exp_num", type=int, default=10)
    p.add_argument("--view_num", type=int, default=8)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="occupancy-culled rendering: a density grid per (identity, "
                        "expression), the fine field on the top 32 occupied samples only")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(rest)

    spec = cfg.model_spec()
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    params, step = load_model(ckpt_dir, spec, dev)
    if step is not None:
        print(f"loaded model checkpoint (step {step})")
    else:
        print(f"WARNING: no checkpoint in {ckpt_dir}; rendering untrained model")

    persons = valid_persons(cfg.datadir, cfg.person_num)
    persons = persons[args.begin_person: args.end_person]
    shape_codes = load_shape_codes(cfg.shape_codes_path)
    ds = load_facescape_data(cfg.datadir, persons, shape_codes, uvdir=cfg.uvdir, testskip=0)
    H0, _, focal0 = ds.hwf
    scale = args.res / H0
    H = W = args.res
    K = np.array([[focal0 * scale, 0, 0.5 * W], [0, focal0 * scale, 0.5 * H], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(args.seed)

    def make_render(cond):
        if args.fast:
            # probe the COARSE field: the fine field is unconstrained off its
            # importance samples (ops/occupancy.py::build_proposal_grid)
            grid = build_proposal_grid(params, spec, cond)
            return lambda c2w: render_frame_fast(params, spec, cond.fine, grid, H, W, K,
                                                 c2w)["rgb"]
        return lambda c2w: render_frame(params, spec, cond, H, W, K, c2w)["rgb"]

    manifest_path = os.path.join(args.out_dir, "gt_manifest.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)

    def write_manifest():
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)

    # frame indices of the train split grouped by (pid, exp)
    by_id_exp = {}
    for i in set(int(i) for i in ds.i_split[0]):
        by_id_exp.setdefault((int(ds.id_codes[i]), int(ds.exp_types[i])), []).append(i)

    for pid in persons:
        pid_dir = os.path.join(args.out_dir, str(pid))
        if os.path.exists(pid_dir):
            print(f"skip existing {pid_dir}")
            continue
        uv_path = ds.uv_paths.get(int(pid), "")
        if not os.path.exists(uv_path):
            print(f"skip {pid}: no UV map at {uv_path}")
            continue
        uv = read_image(uv_path, is_uvmap=True, uv_size=spec.uv_size)
        with torch.no_grad():
            tex = encode_texture(params, spec, torch.from_numpy(uv).to(dev))
        exps = sorted({e for (p_, e) in by_id_exp if p_ == int(pid)})
        exps = list(rng.choice(exps, size=min(args.exp_num, len(exps)), replace=False))
        for exp in exps:
            frames = by_id_exp[(int(pid), int(exp))]
            picks = rng.choice(frames, size=min(args.view_num, len(frames)), replace=False)
            exp_dir = os.path.join(pid_dir, str(int(exp)))
            os.makedirs(exp_dir, exist_ok=True)
            with torch.no_grad():
                cond = prepare_conditioning(
                    params, spec, torch.from_numpy(shape_codes[int(pid)]).to(dev),
                    exp_code_for(params, int(exp)), tex)
            render = make_render(cond)
            for v, fi in enumerate(picks):
                fi = int(fi)
                rgb = render(ds.poses[fi][:3])
                rel = os.path.join(str(pid), str(int(exp)), f"{v:02d}.png")
                write_png(os.path.join(args.out_dir, rel), to8b(rgb))
                manifest[rel] = ds.image_paths[fi]
        write_manifest()
        print(f"rendered id {pid}")
    write_manifest()


if __name__ == "__main__":
    main()
