"""Expression-conditioning study: one identity, two expressions (counterpart
of examples/expression_synthetic.py of the JAX package).

Trains one model on two "expressions" of the same identity (a small and a
large cube) and checks that the learned expression latents control the
rendered geometry: rendering with expression 1 must cover more than 1.5x the
area that expression 0 covers. Writes `<out>/expression_synthetic.json`.

Usage: python -m mofanerf_tpu_torch.examples.expression_synthetic [out_dir] [--iters 2500]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofanerf_tpu_torch.datagen.multiview import render_identity
from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.render.renderer import (encode_texture, exp_code_for,
                                                prepare_conditioning, render_frame)
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out", nargs="?", default=_scenes.default_out("mofanerf_expdemo"))
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--res", type=int, default=64)
    _scenes.add_device_flags(p)
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    out = args.out
    os.makedirs(out, exist_ok=True)
    render_identity(0, _scenes.two_cubes(), f"{out}/data", res=args.res, device=dev)
    ds, H, W, K = _scenes.load_dataset(f"{out}/data", [0])

    spec = _scenes.teacher_spec()
    sampler = _scenes.HostSampler(ds, seed=0)
    uv = _scenes.uv_tensor(0.5, dev)
    zeros = np.zeros(50, np.float32)

    def batch(i):
        ii, coords, target = sampler.draw()
        return _scenes.make_batch(ds, K, ii, coords, target, zeros, ds.exp_types[ii], uv, dev)

    state, secs, _ = _scenes.train_teacher(spec, 1e-3, batch, args.iters, dev)

    pose = ds.poses[int(ds.i_split[2][0])][:3]
    area = {}
    with torch.no_grad():
        tex = encode_texture(state.params, spec, uv)
        for e in (0, 1):
            cond = prepare_conditioning(state.params, spec, torch.zeros(50, device=dev),
                                        exp_code_for(state.params, e), tex)
            o = _scenes.np_maps(render_frame(state.params, spec, cond, H, W, K, pose))
            area[e] = _scenes.area(o["acc"])
            write_png(f"{out}/exp{e}.png", to8b(o["rgb"]))
    print(f"coverage exp0 (small cube): {area[0]:.3f}  exp1 (large cube): {area[1]:.3f}")
    result = {"area_exp0": area[0], "area_exp1": area[1],
              "area_ratio": area[1] / area[0] if area[0] else None,
              "iters": args.iters, "device": _scenes.device_name(dev)}
    timing = {"teacher_secs": secs, "teacher_steps_per_sec": _scenes.rate(args.iters, secs)}
    _scenes.write_json(os.path.join(out, "expression_synthetic.json"), result, timing)
    _scenes.gate(area[1] > area[0] * 1.5, "expression latents do not control geometry")
    print("EXPRESSION CONTROL OK")
    return result, timing


if __name__ == "__main__":
    main()
