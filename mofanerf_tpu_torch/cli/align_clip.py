"""Mesh align+clip CLI — counterpart of tools/train_data_pre/align_clip.py
(the port of mofanerf_tpu/cli/align_clip.py; host work, no device).

Loads raw FaceScape scan OBJs, applies the per-(id, exp) scale+Rt from
Rt_scale_dict.json to align to the TU bilinear-model frame, drops faces
beyond the per-identity radius (maxDistance.npy), remaps ids via
order_new_old.txt, and exports aligned OBJs.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scans_dir", required=True, help="raw scan OBJs: <id>/<exp>.obj")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--rt_scale_json", required=True, help="Rt_scale_dict.json")
    p.add_argument("--max_distance_npy", default=None, help="maxDistance.npy (847,)")
    p.add_argument("--order_map", default=None, help="order_new_old.txt (new old per line)")
    args = p.parse_args(argv)

    from mofanerf_tpu_torch.datagen.mesh import (
        load_obj, save_obj, apply_rt_scale, clip_faces_by_distance,
    )

    with open(args.rt_scale_json) as f:
        rt_dict = json.load(f)
    max_dist = np.load(args.max_distance_npy) if args.max_distance_npy else None
    order = {}
    if args.order_map and os.path.exists(args.order_map):
        for line in open(args.order_map):
            parts = line.split()
            if len(parts) >= 2:
                order[int(parts[1])] = int(parts[0])  # old -> new

    os.makedirs(args.out_dir, exist_ok=True)
    for old_id in sorted(os.listdir(args.scans_dir)):
        src = os.path.join(args.scans_dir, old_id)
        if not os.path.isdir(src):
            continue
        new_id = order.get(int(old_id), int(old_id)) if old_id.isdigit() else old_id
        dst = os.path.join(args.out_dir, str(new_id))
        os.makedirs(dst, exist_ok=True)
        for fname in sorted(os.listdir(src)):
            if not fname.endswith(".obj"):
                continue
            exp = os.path.splitext(fname)[0]
            key = f"{old_id}_{exp}"
            if key not in rt_dict:
                print(f"skip {key}: no Rt/scale entry")
                continue
            scale, Rt = rt_dict[key][0], np.asarray(rt_dict[key][1])
            verts, faces = load_obj(os.path.join(src, fname))
            verts = apply_rt_scale(verts, scale, Rt)
            if max_dist is not None and str(new_id).isdigit():
                faces = clip_faces_by_distance(verts, faces, float(max_dist[int(new_id)]))
            save_obj(os.path.join(dst, fname), verts, faces)
            print(f"aligned {key} -> {dst}/{fname}")


if __name__ == "__main__":
    main()
