"""Ground-truth pairing for the RefineNet corpus (counterpart of
mofanerf_tpu/cli/prepare_refine_trainset.py): mirrors the rendered tree
into `--out_dir` with each render's ground-truth frame, from the
`gt_manifest.json` that `render_refine_trainset` writes.

    python -m mofanerf_tpu_torch.cli.prepare_refine_trainset --renders_dir corpus \
        --out_dir gt [--white_bkgd]

A ground truth of another size than its render is resized as cv2's
INTER_AREA resizes uint8 (`utils/image_io.py::resize_area_u8`), so the
files hold the JAX package's bytes. Host-side only.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from mofanerf_tpu_torch.utils.image_io import image_size, imread, resize_area_u8, write_png


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--renders_dir", required=True,
                   help="trainset renders with gt_manifest.json")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--white_bkgd", action="store_true",
                   help="composite RGBA ground truth over white (must match the white_bkgd "
                        "setting the coarse model was trained and rendered with)")
    args = p.parse_args(argv)

    manifest_path = os.path.join(args.renders_dir, "gt_manifest.json")
    if not os.path.exists(manifest_path):
        raise SystemExit(f"no gt_manifest.json in {args.renders_dir}: run "
                         "render_refine_trainset first (it records which dataset frame each "
                         "render corresponds to)")
    with open(manifest_path) as f:
        manifest = json.load(f)

    n = 0
    for rel, gt_src in sorted(manifest.items()):
        render_path = os.path.join(args.renders_dir, rel)
        if not os.path.exists(render_path):
            continue
        if not os.path.exists(gt_src):
            print(f"missing GT source {gt_src}")
            continue
        gt = imread(gt_src)
        if gt.ndim == 2:
            gt = np.stack([gt] * 3, -1)
        if gt.shape[-1] == 4 and args.white_bkgd:
            a = gt[..., 3:].astype(np.float32) / 255.0
            gt = np.clip(gt[..., :3] * a + 255.0 * (1.0 - a), 0, 255).astype(gt.dtype)
        gt = gt[..., :3]
        h, w = image_size(render_path)
        if gt.shape[:2] != (h, w):
            gt = resize_area_u8(gt, (w, h))
        out_path = os.path.join(args.out_dir, rel)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        write_png(out_path, np.ascontiguousarray(gt))
        n += 1
    print(f"paired {n} ground-truth images into {args.out_dir}")


if __name__ == "__main__":
    main()
