"""Export per-identity occupancy grids for serving (counterpart of
mofanerf_tpu/cli/export_grids.py).

    python -m mofanerf_tpu_torch.cli.export_grids --out grids.npz [--ckpt_dir dir] \
        [--resolution 64] [--threshold 1.0] [--expressions 0,9] [--max_persons N] \
        [--device cuda] [config flags]

Builds one density grid of the coarse field per (identity, expression) from
the newest checkpoint, a `.pt` or the JAX package's Orbax step
(`build_proposal_grid`: sigma-only probes at the cell centres, threshold,
dilation) and saves them to one compressed `.npz`:
`resolution`, `aabb_min`, `aabb_max` and `occ_<pid>_<exp>` (the occupancy
bits, `np.packbits`), the JAX package's format, so either package reads the
other's file. `load_exported_grid` gives one back for `render_frame_fast`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofanerf_tpu_torch.config import load_config
from mofanerf_tpu_torch.data.facescape import load_shape_codes, read_image, valid_persons
from mofanerf_tpu_torch.ops.occupancy import OccupancyGrid, build_proposal_grid
from mofanerf_tpu_torch.render.renderer import encode_texture, exp_code_for, prepare_conditioning
from mofanerf_tpu_torch.train.checkpoint import load_model
from mofanerf_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    """Run the CLI; returns {"occ_<pid>_<exp>": occupied share}."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--threshold", type=float, default=1.0)
    p.add_argument("--expressions", default="0", help="comma-separated exp ids")
    p.add_argument("--max_persons", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(rest)

    spec = cfg.model_spec()
    ckpt_dir = args.ckpt_dir or os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    params, step = load_model(ckpt_dir, spec, dev)
    if step is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")

    persons = (valid_persons(cfg.datadir, cfg.person_num) if os.path.isdir(cfg.datadir)
               else list(range(cfg.person_num)))
    if args.max_persons:
        persons = persons[: args.max_persons]
    shape_codes = load_shape_codes(cfg.shape_codes_path)
    exps = [int(e) for e in args.expressions.split(",")]

    grids, shares = {}, {}
    aabb = None
    for pid in persons:
        uv_path = os.path.join(cfg.uvdir, str(pid), "1_neutral.jpg")
        with torch.no_grad():
            if os.path.exists(uv_path):
                uv = read_image(uv_path, is_uvmap=True, uv_size=spec.uv_size)
                tex = encode_texture(params, spec, torch.from_numpy(uv).to(dev))
            else:
                tex = torch.zeros(spec.tex_dim, device=dev)
        shape = torch.from_numpy(np.asarray(shape_codes[int(pid)], np.float32)).to(dev)
        for exp in exps:
            with torch.no_grad():
                cond = prepare_conditioning(params, spec, shape, exp_code_for(params, exp), tex)
            grid = build_proposal_grid(params, spec, cond, resolution=args.resolution,
                                       density_threshold=args.threshold)
            key = f"occ_{pid}_{exp}"
            grids[key] = np.packbits(grid.occ.cpu().numpy())
            aabb = (grid.aabb_min.cpu().numpy(), grid.aabb_max.cpu().numpy())
            shares[key] = float(grid.occ.float().mean())
            print(f"id {pid} exp {exp}: occupancy {shares[key]:.3f}")

    if not grids:
        raise SystemExit(
            "nothing to export: no (identity, expression) pairs produced a grid "
            "(check --max_persons / --expressions / datadir)")
    np.savez_compressed(args.out, resolution=args.resolution, aabb_min=aabb[0],
                        aabb_max=aabb[1], **grids)
    print(f"exported {len(grids)} grids -> {args.out}")
    return shares


def load_exported_grid(path: str, pid: int, exp: int, device="cuda") -> OccupancyGrid:
    """One grid of an exported file as an OccupancyGrid on `device`."""
    dev = resolve_device(device)
    with np.load(path) as d:
        G = int(d["resolution"])
        bits = np.unpackbits(d[f"occ_{pid}_{exp}"])[: G ** 3]
        return OccupancyGrid(
            torch.from_numpy(bits.reshape(G, G, G).astype(bool)).to(dev),
            torch.from_numpy(np.asarray(d["aabb_min"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(d["aabb_max"], np.float32)).to(dev))


if __name__ == "__main__":
    main()
