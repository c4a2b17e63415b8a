"""Texture-conditioning study: the UV map alone controls appearance
(counterpart of examples/texture_synthetic.py of the JAX package).

Two identities share identical geometry and identical (zero) shape codes;
their ground truths differ only in colour (a red and a blue cube). Only the
UV map -> texture encoder -> texture code -> rgb trunk path can explain the
difference, so after training the render with identity 0's UV map must be
red-dominant and identity 1's blue-dominant. Writes
`<out>/texture_synthetic.json`.

Usage: python -m mofanerf_tpu_torch.examples.texture_synthetic [out_dir] [--iters 2500]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.multiview import (FOCAL, RES, camera_grid,
                                                  write_transforms_json)
from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def render_colored_cubes(data: str, res: int, dev) -> None:
    """A red cube (identity 0) and a blue one (identity 1), 120 views each,
    20 random views of each held out as test."""
    v, f = _scenes.cube(1.6)
    K_np = np.array([[FOCAL * res / RES, 0, res / 2], [0, FOCAL * res / RES, res / 2], [0, 0, 1]])
    poses = camera_grid()
    rng0 = np.random.default_rng(0)
    for pid, col in enumerate((_scenes.RED, _scenes.BLUE)):
        os.makedirs(f"{data}/{pid}", exist_ok=True)
        frames = {"train": [], "val": [], "test": []}
        hold = set(rng0.choice(len(poses), 20, replace=False).tolist())
        for vi, c2w in enumerate(poses):
            rgb, _, mask = rasterize_mesh(v, f, K_np, c2w, res, res, base_color=col, device=dev)
            rel = f"{pid}/0_{vi:03d}"
            rgba = np.concatenate([rgb, mask[..., None].astype(np.float32)], -1)
            write_png(f"{data}/{rel}.png", (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            split = "test" if vi in hold else "train"
            frames[split].append({"file_path": rel, "transform_matrix": np.asarray(c2w).tolist(),
                                  "expression": 0})
        write_transforms_json(data, pid, frames)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out", nargs="?", default=_scenes.default_out("mofanerf_texdemo"))
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--res", type=int, default=64)
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    out = args.out
    data = f"{out}/data"
    os.makedirs(data, exist_ok=True)
    render_colored_cubes(data, args.res, dev)
    ds, H, W, K = _scenes.load_dataset(data, [0, 1])

    spec = _scenes.teacher_spec()
    sampler = _scenes.HostSampler(ds, seed=1)
    # the UV maps: one solid colour an identity, the only identity signal
    # (the shape codes are the same zeros)
    uvs = {0: _scenes.uv_tensor(_scenes.RED, dev), 1: _scenes.uv_tensor(_scenes.BLUE, dev)}
    zeros = np.zeros(50, np.float32)

    def batch(i):
        ii, coords, target = sampler.draw()
        return _scenes.make_batch(ds, K, ii, coords, target, zeros, 0,
                                  uvs[int(ds.id_codes[ii])], dev)

    state, secs, _ = _scenes.train_teacher(spec, 1e-3, batch, args.iters, dev)

    pose = ds.poses[int(ds.i_split[2][0])][:3]
    mean_rgb = {}
    with torch.no_grad():
        for pid in (0, 1):
            tex = encode_texture(state.params, spec, uvs[pid])
            cond = prepare_conditioning(state.params, spec, torch.zeros(50, device=dev),
                                        exp_code_for(state.params, 0), tex)
            o = _scenes.np_maps(render_frame(state.params, spec, cond, H, W, K, pose))
            mean_rgb[pid] = _scenes.mean_rgb(o["rgb"], o["acc"])
            write_png(f"{out}/tex{pid}.png", to8b(o["rgb"]))
    print("render with uv0 (red): mean object RGB", mean_rgb[0].round(3))
    print("render with uv1 (blue): mean object RGB", mean_rgb[1].round(3))
    result = {"mean_rgb_uv0": [float(c) for c in mean_rgb[0]],
              "mean_rgb_uv1": [float(c) for c in mean_rgb[1]],
              "red_dominant_uv0": bool(mean_rgb[0][0] > mean_rgb[0][2]),
              "blue_dominant_uv1": bool(mean_rgb[1][2] > mean_rgb[1][0]),
              "iters": args.iters, "device": _scenes.device_name(dev)}
    timing = {"teacher_secs": secs, "teacher_steps_per_sec": _scenes.rate(args.iters, secs)}
    _scenes.write_json(os.path.join(out, "texture_synthetic.json"), result, timing)
    _scenes.gate(mean_rgb[0][0] > mean_rgb[0][2], "uv0 render not red-dominant")
    _scenes.gate(mean_rgb[1][2] > mean_rgb[1][0], "uv1 render not blue-dominant")
    print("TEXTURE CONTROL OK")
    return result, timing


if __name__ == "__main__":
    main()
