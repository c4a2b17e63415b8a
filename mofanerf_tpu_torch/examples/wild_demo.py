"""Wild-photo end-to-end demo: preprocess -> fit -> render / modulate
(counterpart of examples/wild_demo.py of the JAX package).

The reference's headline workflow (tools/wildData_preprocess.py, then
run_fit.py fitting, rendering and rendering_modulation) on a directory of
photos, through this package's CLIs:

1. copy the photos (PNG / JPEG) into a working directory;
2. `cli.wild_preprocess` with its documented fallbacks (no landmark detector,
   segmentation or relighting weights: centre-crop alignment on canonical
   landmarks, the landmark-hull mask, relighting passed through; each logged);
3. composite the segmented photo over white (the checkpoint is trained over
   white), the rows from 450 down cut as the pipeline cuts them;
4. `cli.run_fit --renderType fitting` against the trained flagship model
   (its previews through the field kernel on the card), then `rendering` and
   `rendering_modulation` on the fitted codes of `--modulate_photo`;
5. a collage and the JSON with each photo's fit PSNR.

The reference's demo photos are its data/fit/1..4.png (`--photos`).
`--synthetic_photos N` writes N photos of the face family of `--data`
(512^2 frontal renders of its first N identities, named 1..N) and runs on
those. The model is trained on the synthetic face family, so the fit PSNR
measures the nearest synthetic face; the chain is what is under test.

Writes `--out_json` and `--out_png` (defaults in examples/artifacts/ of this
package).

Usage (after the flagship checkpoint exists):
  python -m mofanerf_tpu_torch.examples.wild_demo --photos data/fit
CPU smoke: --quick --small_model --synthetic_photos 1 --device cpu.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

from mofanerf_tpu_torch.cli.run_fit import main as run_fit_main
from mofanerf_tpu_torch.cli.wild_preprocess import main as preprocess_main
from mofanerf_tpu_torch.examples import _flagship, _scenes
from mofanerf_tpu_torch.utils.image_io import imread, resize_linear
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png

ROW_CUT = 450   # the preprocessing pipeline zeroes these rows (preprocess/pipeline.py)
PHOTO_SIDE, PHOTO_FOCAL = 512, 1200.0


def write_synthetic_photos(data: str, out_dir: str, n: int, dev) -> None:
    """`n` photos of the face family of `data`: identity i - 1's neutral face,
    rasterized frontally at 512^2 (focal 1200, radius 16) over black, as i.png."""
    from mofanerf_tpu_torch.datagen.rasterize import rasterize_mesh
    from mofanerf_tpu_torch.datagen.synthetic_faces import face_mesh
    from mofanerf_tpu_torch.ops.rays import pose_spherical

    params = np.load(os.path.join(data, "face_params.npy"))
    K = np.array([[PHOTO_FOCAL, 0, PHOTO_SIDE / 2], [0, PHOTO_FOCAL, PHOTO_SIDE / 2],
                  [0, 0, 1]])
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        v, f, alb = face_mesh(params[i], 0)
        rgb, _, _ = rasterize_mesh(v, f, K, pose_spherical(0.0, 0.0, 16.0), PHOTO_SIDE,
                                   PHOTO_SIDE, face_albedo=alb, device=dev)
        write_png(os.path.join(out_dir, f"{i + 1}.png"), to8b(rgb))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--photos", default="data/fit",
                   help="directory of the photos (read-only is fine)")
    p.add_argument("--synthetic_photos", type=int, default=0,
                   help="if > 0: write this many photos of the --data face family and run "
                        "on them in place of --photos")
    p.add_argument("--work_dir", default=_scenes.default_out("mofanerf_wild"))
    _flagship.add_model_flags(p)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--out_json", default=_flagship.artifact("wild_demo.json"))
    p.add_argument("--out_png", default=_flagship.artifact("wild_demo.png"))
    p.add_argument("--modulate_photo", default="1",
                   help="photo name to run rendering + modulation on")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--small_model", action="store_true")
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.iters = 60

    # ---- 1 + 2: photos -> the preprocessing CLI
    if args.synthetic_photos > 0:
        args.photos = args.work_dir.rstrip(os.sep) + "_photos"
        write_synthetic_photos(args.data, args.photos, args.synthetic_photos, dev)
    os.makedirs(args.work_dir, exist_ok=True)
    names = []
    for f in sorted(os.listdir(args.photos)):
        if f.lower().endswith((".png", ".jpg", ".jpeg")):
            shutil.copy(os.path.join(args.photos, f), os.path.join(args.work_dir, f))
            names.append(os.path.splitext(f)[0])
    if not names:
        raise SystemExit(f"no photos in {args.photos}")
    if args.quick:
        names = names[:1]
    t0 = time.perf_counter()
    preprocess_main(["--filePath", args.work_dir, "--device", str(dev)])
    preprocess_secs = time.perf_counter() - t0

    # ---- 3: white background composite (the segmented photo zeroes the background)
    for name in names:
        seg = np.asarray(imread(os.path.join(args.work_dir, "segRelRes", f"{name}.png")),
                         np.float32) / 255.0
        mask = np.asarray(imread(os.path.join(args.work_dir, "mask", f"{name}.png")),
                          np.float32) / 255.0
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = mask[..., None].copy()
        mask[ROW_CUT:] = 0.0
        comp = seg[..., :3] * mask + (1.0 - mask)
        write_png(os.path.join(args.work_dir, "segRelRes", f"{name}_white.png"), to8b(comp))
        # run_fit looks up pose_<name>.npy by the photo's basename
        shutil.copy(os.path.join(args.work_dir, f"pose_{name}.npy"),
                    os.path.join(args.work_dir, f"pose_{name}_white.npy"))

    # ---- 4: fit each photo through the CLI, then the render modes
    cfg_flags = ["--expname", args.expname, "--basedir", args.basedir, "--datadir", args.data,
                 "--uvdir", os.path.join(args.data, "uv"),
                 "--shape_codes_path", os.path.join(args.data, "factors_id.npy"),
                 "--white_bkgd", "True", "--device", str(dev)]
    if args.small_model:
        # morphable_flagship --small's dims, so that its checkpoint restores
        for k, v in _flagship.SMALL_FLAGSHIP.items():
            cfg_flags += [f"--{k}", str(v)]
        cfg_flags += ["--N_rand", "128"]

    rows, panels, fit_secs = [], [], []
    side = 256
    for name in names:
        photo = os.path.join(args.work_dir, "segRelRes", f"{name}_white.png")
        _scenes.sync(dev)
        t0 = time.perf_counter()
        run_fit_main(["--filePath", photo, "--renderType", "fitting",
                      "--num_iterations", str(args.iters)] + cfg_flags)
        _scenes.sync(dev)
        fit_secs.append(time.perf_counter() - t0)
        fit_dir = os.path.join(args.work_dir, "fitting", f"segRelRes_{name}_white")
        # the fit loop always writes a final render (train/fit_loop.py)
        target = np.asarray(imread(photo), np.float32)[..., :3] / 255
        fitted = np.asarray(imread(os.path.join(fit_dir, "fit_final.png")),
                            np.float32)[..., :3] / 255
        if fitted.shape != target.shape:
            fitted = resize_linear(fitted, target.shape[1::-1])
        mse = float(np.mean((fitted - target) ** 2))
        rows.append({"photo": name, "fit_psnr_db": round(-10 * np.log10(max(mse, 1e-12)), 2),
                     "fit_dir": fit_dir, "iters": args.iters})
        print(f"[WILD] {name}: fit {rows[-1]['fit_psnr_db']} dB", flush=True)
        panels.append(np.concatenate([resize_linear(target, (side, side)),
                                      resize_linear(fitted, (side, side))], axis=0))
        if name == args.modulate_photo and not args.quick:
            run_fit_main(["--filePath", photo, "--renderType", "rendering",
                          "--is_load_par"] + cfg_flags)
            run_fit_main(["--filePath", photo, "--renderType", "rendering_modulation",
                          "--is_load_par"] + cfg_flags)
            rows[-1]["render_modes"] = ["rendering", "rendering_modulation"]

    os.makedirs(os.path.dirname(os.path.abspath(args.out_png)), exist_ok=True)
    write_png(args.out_png, to8b(np.concatenate(panels, axis=1)))
    result = {
        "study": "wild-photo end-to-end chain: preprocess (fallback landmarks/mask/relight) "
                 "-> fit -> rendering + rendering_modulation",
        "model": args.expname,
        "fallbacks": ["center-crop alignment (no landmark detector weights)",
                      "convex-hull mask (no BiSeNet weights)",
                      "relight pass-through (no hourglass weights)"],
        "note": "model trained on the synthetic face family; fit PSNR measures the "
                "nearest-synthetic-face reconstruction, the chain itself is the capability "
                "under test",
        "photos": rows,
        "collage": args.out_png,
        "device": _scenes.device_name(dev),
    }
    timing = {"preprocess_secs": preprocess_secs, "fit_secs": fit_secs}
    _scenes.write_json(args.out_json, result, timing)
    return result, timing


if __name__ == "__main__":
    main()
