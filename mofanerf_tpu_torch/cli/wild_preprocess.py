"""Wild-photo preprocessing CLI — counterpart of
`python tools/wildData_preprocess.py --filePath <dir>` (the port of
mofanerf_tpu/cli/wild_preprocess.py, with `--device`)."""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--filePath", required=True, help="directory of wild photos")
    p.add_argument("--landmarks3d", default=None,
                   help="1_975_landmarks.npy (template 3D landmarks)")
    p.add_argument("--kp_dir", default=None, help="dir of precomputed kp_<name>.npy")
    p.add_argument("--dlib_predictor", default=None,
                   help="shape_predictor_68_face_landmarks.dat")
    p.add_argument("--bisenet_weights", default=None, help="Seg_79999_iter.pth")
    p.add_argument("--relight_weights", default=None, help="trained_model_03.t7")
    p.add_argument("--canonical_sh", default=None, help="fcspLight.npy")
    p.add_argument("--stages", default="align,mask,segment,relight")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import torch

    from mofanerf_tpu_torch.preprocess.pipeline import preprocess_dir
    from mofanerf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    lm3d = None
    if args.landmarks3d and os.path.exists(args.landmarks3d):
        # template = identity 1, neutral expression, /50 to model units
        # (tools/wild_fit_base.py:171-172)
        lm = np.load(args.landmarks3d)
        lm3d = lm[1, 0] / 50.0

    bisenet_vars = None
    if args.bisenet_weights and os.path.exists(args.bisenet_weights):
        from mofanerf_tpu_torch.preprocess.segment import convert_bisenet_weights

        sd = torch.load(args.bisenet_weights, map_location="cpu", weights_only=False)
        bisenet_vars = convert_bisenet_weights(sd, dev)

    relight_vars = None
    sh = None
    if args.relight_weights and os.path.exists(args.relight_weights):
        from mofanerf_tpu_torch.preprocess.relight import convert_hourglass_weights

        sd = torch.load(args.relight_weights, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        relight_vars = convert_hourglass_weights(sd, dev)
    if args.canonical_sh and os.path.exists(args.canonical_sh):
        sh = np.load(args.canonical_sh).reshape(9)

    preprocess_dir(
        args.filePath,
        landmarks_3d=lm3d,
        kp_dir=args.kp_dir,
        dlib_predictor=args.dlib_predictor,
        bisenet_variables=bisenet_vars,
        relight_variables=relight_vars,
        canonical_sh=sh,
        stages=tuple(args.stages.split(",")),
        device=dev,
    )


if __name__ == "__main__":
    main()
