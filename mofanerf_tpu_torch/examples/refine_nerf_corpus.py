"""Close the RefineNet loop on real NeRF renders (counterpart of
examples/refine_nerf_corpus.py of the JAX package).

The reference's workflow, end to end on the trained flagship model:
1. `cli.render_refine_trainset` renders a corpus with the trained model at
   dataset poses (the field kernel on the card);
2. `cli.prepare_refine_trainset` mirrors the pixel-aligned GT tree;
3. the GAN (train/refine.py) trains on (NeRF render, GT) pairs with a
   held-out view split;
4. the held-out gain is read on the NeRF's own artifacts: PSNR, SSIM and a
   VGG-feature distance. No pretrained VGG19 weights ship, so the training
   perceptual net and the evaluation proxy are two fixed random-init VGG19s,
   seeded with torch generators 7 and 42 (the JAX script seeds its pair with
   JAX keys 7 and 42, which torch cannot reproduce: the distance here is a
   proxy of its own, not the JAX artifact's).
A pair below `--min_input_psnr_db` is a corpus defect (stale data, a
background mismatch, a broken pose), not NeRF blur: the study stops.

Writes `--out_json` (default examples/artifacts/refine_nerf_quality.json of
this package) and a before / after / GT triptych beside it.

Usage (after morphable_flagship --stage train):
  python -m mofanerf_tpu_torch.examples.refine_nerf_corpus --white_bkgd --steps 3000
CPU smoke: --quick --small_model --device cpu (tiny dims, untrained model).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mofanerf_tpu_torch.cli.prepare_refine_trainset import main as prepare_main
from mofanerf_tpu_torch.cli.render_refine_trainset import main as render_main
from mofanerf_tpu_torch.examples import _flagship, _scenes
from mofanerf_tpu_torch.train.refine import (RefineConfig, init_refine_state, init_vgg_params,
                                             make_refine_optimizers, refine_inference,
                                             refine_train_step, vgg_model)
from mofanerf_tpu_torch.utils.device import f32_products
from mofanerf_tpu_torch.utils.image_io import imread
from mofanerf_tpu_torch.utils.metrics import to8b
from mofanerf_tpu_torch.utils.png import write_png


def config_flags(args) -> list:
    """The model and dataset flags the corpus CLI takes (config flags)."""
    flags = ["--expname", args.expname, "--basedir", args.basedir, "--datadir", args.data,
             "--uvdir", os.path.join(args.data, "uv"),
             "--shape_codes_path", os.path.join(args.data, "factors_id.npy"),
             "--person_num", str(args.n_ids)]
    if args.white_bkgd:
        flags += ["--white_bkgd", "True"]
    flags += ["--near", str(args.near), "--far", str(args.far)]
    if args.small_model:
        for k, v in _flagship.SMALL_SERVE.items():
            flags += [f"--{k}", str(v)]
    return flags


def read_pairs(renders_dir: str, gt_dir: str) -> list:
    """(relative path, render, GT) of every manifest entry with both files, f32 [0, 1]."""
    with open(os.path.join(renders_dir, "gt_manifest.json")) as f:
        manifest = json.load(f)
    pairs = []
    for rel in sorted(manifest):
        rp, gp = os.path.join(renders_dir, rel), os.path.join(gt_dir, rel)
        if os.path.exists(rp) and os.path.exists(gp):
            pairs.append((rel, np.asarray(imread(rp), np.float32)[..., :3] / 255.0,
                          np.asarray(imread(gp), np.float32)[..., :3] / 255.0))
    return pairs


def split_pairs(pairs: list, heldout_views: int):
    """(train, held out): the last `heldout_views` views of each (id, exp) group,
    keeping a training view a group; every 4th pair when every group is one view."""
    groups = {}
    for p_ in pairs:
        groups.setdefault(os.path.dirname(p_[0]), []).append(p_)
    train_pairs, test_pairs = [], []
    for g_ in groups.values():
        g_.sort(key=lambda p_: p_[0])
        n_hold = min(heldout_views, len(g_) - 1)
        train_pairs += g_[: len(g_) - n_hold]
        test_pairs += g_[len(g_) - n_hold:]
    if not test_pairs:
        test_pairs = train_pairs[::4]
        train_pairs = [p_ for p_ in train_pairs if not any(p_ is q for q in test_pairs)]
    return train_pairs, test_pairs


def main(argv=None):
    p = argparse.ArgumentParser()
    _flagship.add_model_flags(p)
    p.add_argument("--corpus_dir", default=_scenes.default_out("mofanerf_refine_corpus"))
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--exp_num", type=int, default=3)
    p.add_argument("--view_num", type=int, default=8)
    p.add_argument("--heldout_views", type=int, default=2,
                   help="per-(id,exp) views held out of GAN training")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--use_vgg", type=int, default=1,
                   help="train with the perceptual term (a fixed random-init VGG19)")
    p.add_argument("--lambda_l1", type=float, default=10.0,
                   help="L1 reconstruction anchor weight (0 = reference parity)")
    p.add_argument("--near", type=float, default=8.0)
    p.add_argument("--far", type=float, default=26.0)
    p.add_argument("--fast", action="store_true", help="occupancy-culled corpus rendering")
    p.add_argument("--min_input_psnr_db", type=float, default=16.0,
                   help="corpus sanity floor: a (render, GT) pair below it is a corpus "
                        "defect, not NeRF blur")
    p.add_argument("--out_json", default=_flagship.artifact("refine_nerf_quality.json"))
    p.add_argument("--quick", action="store_true")
    p.add_argument("--small_model", action="store_true",
                   help="tiny field dims (CPU smoke against an untrained model)")
    p.add_argument("--white_bkgd", action="store_true",
                   help="must match the checkpoint's training setting; also composites GT "
                        "over white in the pairing step")
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)
    if args.quick:
        args.steps, args.exp_num, args.view_num = 80, 1, 3
        args.heldout_views = 1

    # ---- 1 + 2: corpus render + GT pairing through the CLIs (resumable)
    renders_dir = os.path.join(args.corpus_dir, "train")
    gt_dir = os.path.join(args.corpus_dir, "gt")
    _scenes.sync(dev)
    t0 = time.perf_counter()
    render_main(["--out_dir", renders_dir, "--exp_num", str(args.exp_num),
                 "--view_num", str(args.view_num), "--res", str(args.res),
                 "--device", str(dev)] + (["--fast"] if args.fast else []) + config_flags(args))
    _scenes.sync(dev)
    corpus_secs = time.perf_counter() - t0
    prepare_main(["--renders_dir", renders_dir, "--out_dir", gt_dir]
                 + (["--white_bkgd"] if args.white_bkgd else []))
    pairs = read_pairs(renders_dir, gt_dir)
    if not pairs:
        raise SystemExit(f"empty corpus: no (render, GT) pair under {renders_dir}")
    print(f"corpus: {len(pairs)} (render, GT) pairs at {args.res}^2")

    # corpus sanity: per-identity input PSNR + a hard floor on every pair
    in_psnr = {rel: _scenes.psnr(a, b) for rel, a, b in pairs}
    by_ident = {}
    for rel, v in in_psnr.items():
        by_ident.setdefault(rel.split(os.sep)[0], []).append(v)
    for ident in sorted(by_ident, key=int):
        vs = by_ident[ident]
        print(f"  id {ident}: input psnr mean {np.mean(vs):.2f} min {min(vs):.2f} dB over "
              f"{len(vs)} views")
    defects = sorted((v, rel) for rel, v in in_psnr.items() if v < args.min_input_psnr_db)
    if defects and not args.small_model:
        raise SystemExit(
            f"CORPUS DEFECT: {len(defects)} pairs below {args.min_input_psnr_db} dB input "
            f"PSNR (worst: {defects[:8]}): fix the corpus before training; a GAN gains 10+ dB "
            "repairing broken data")

    train_pairs, test_pairs = split_pairs(pairs, args.heldout_views)
    print(f"GAN split: {len(train_pairs)} train / {len(test_pairs)} held-out")

    # ---- 3: GAN training on the NeRF's own artifacts
    rcfg = RefineConfig(use_vgg=bool(args.use_vgg), lambda_l1=args.lambda_l1,
                        ngf=16 if args.quick else 32, n_blocks=3 if args.quick else 9,
                        n_downsampling=2 if args.quick else 4)
    steps_per_epoch = max(1, len(train_pairs) // args.batch)
    state = init_refine_state(torch.Generator().manual_seed(0), rcfg,
                              steps_per_epoch=steps_per_epoch, device=dev)
    g_tx, d_tx = make_refine_optimizers(rcfg, steps_per_epoch)
    # the training perceptual net (seed 7), apart from the evaluation proxy (seed 42)
    train_vgg = (init_vgg_params(torch.Generator().manual_seed(7), dev) if rcfg.use_vgg
                 else None)
    rng = np.random.default_rng(0)

    def batch():
        ids = rng.choice(len(train_pairs), args.batch)
        a = np.stack([train_pairs[i][1] for i in ids]) * 2 - 1
        b = np.stack([train_pairs[i][2] for i in ids]) * 2 - 1
        return (torch.as_tensor(a, dtype=torch.float32).to(dev),
                torch.as_tensor(b, dtype=torch.float32).to(dev))

    _scenes.sync(dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, m = refine_train_step(state, *batch(), rcfg, g_tx, d_tx, vgg_params=train_vgg)
        if i % max(1, args.steps // 6) == 0:
            print(f"[REFINE-NERF] step {i} loss_G {float(m['loss_G']):.3f} loss_D "
                  f"{float(m['loss_D']):.3f} ({(i + 1) / (time.perf_counter() - t0):.2f} it/s)",
                  flush=True)
    _scenes.sync(dev)
    train_secs = time.perf_counter() - t0

    # ---- 4: held-out measurement on the NeRF's artifacts
    def infer(a: np.ndarray) -> np.ndarray:
        out = refine_inference(state.g_params,
                               torch.as_tensor(a[None] * 2 - 1, dtype=torch.float32).to(dev),
                               rcfg)
        return np.clip((out[0].cpu().numpy() + 1) / 2, 0, 1)

    eval_vgg = init_vgg_params(torch.Generator().manual_seed(42), dev)

    def feats(x: np.ndarray):
        t = torch.as_tensor(x[None] * 2 - 1, dtype=torch.float32).to(dev).permute(0, 3, 1, 2)
        with torch.no_grad(), f32_products():
            return torch.func.functional_call(vgg_model(), eval_vgg, (t.contiguous(),))

    def vgg_dist(a, b) -> float:
        return float(sum(torch.mean(torch.abs(x - y)) for x, y in zip(feats(a), feats(b))))

    rows = []
    for rel, a, b in test_pairs:
        ref = infer(a)
        rows.append({
            "view": rel,
            "input_psnr_db": round(_scenes.psnr(a, b), 2),
            "refined_psnr_db": round(_scenes.psnr(ref, b), 2),
            "input_ssim": round(_scenes.ssim(a, b), 4),
            "refined_ssim": round(_scenes.ssim(ref, b), 4),
            "input_vgg_dist": round(vgg_dist(a, b), 4),
            "refined_vgg_dist": round(vgg_dist(ref, b), 4),
        })

    out_dir = os.path.dirname(os.path.abspath(args.out_json))
    os.makedirs(out_dir, exist_ok=True)
    _, a0, b0 = test_pairs[0]
    stem = os.path.splitext(os.path.basename(args.out_json))[0]
    write_png(os.path.join(out_dir, f"{stem}_triptych.png"),
              to8b(np.concatenate([a0, infer(a0), b0], axis=1)))

    def mean(k):
        return round(float(np.mean([r[k] for r in rows])), 4)

    gains = [r["refined_psnr_db"] - r["input_psnr_db"] for r in rows]
    results = {
        "study": "RefineNet trained on REAL NeRF renders of the flagship morphable model "
                 "(full corpus workflow: render_refine_trainset -> prepare_refine_trainset "
                 "-> GAN)",
        "corpus": {"pairs": len(pairs), "gan_train": len(train_pairs),
                   "heldout": len(test_pairs), "res": args.res, "renders_dir": renders_dir},
        "generator": f"ngf={rcfg.ngf} n_blocks={rcfg.n_blocks} n_down={rcfg.n_downsampling} "
                     "(pix2pixHD global)",
        "loss": {"use_vgg": rcfg.use_vgg,
                 "vgg_note": "fixed random-init VGG19, torch generator seed 7 (train) vs "
                             "seed 42 (eval proxy): independent nets",
                 "lambda_l1": rcfg.lambda_l1, "lambda_feat": rcfg.lambda_feat},
        "steps": args.steps, "train_secs": round(train_secs, 1),
        "heldout_input_psnr_db": mean("input_psnr_db"),
        "heldout_refined_psnr_db": mean("refined_psnr_db"),
        "psnr_gain_db": round(mean("refined_psnr_db") - mean("input_psnr_db"), 2),
        "psnr_gain_median_db": round(float(np.median(gains)), 2),
        "views_improved": int(sum(g > 0 for g in gains)),
        "views_total": len(gains),
        "min_input_psnr_db": round(min(r["input_psnr_db"] for r in rows), 2),
        "heldout_input_ssim": mean("input_ssim"),
        "heldout_refined_ssim": mean("refined_ssim"),
        "heldout_input_vgg_dist": mean("input_vgg_dist"),
        "heldout_refined_vgg_dist": mean("refined_vgg_dist"),
        "vgg_note": "FIXED random-init VGG19 feature distance (no pretrained weights ship), "
                    "seeded by a torch generator (42): a random-projection perceptual proxy "
                    "of this package, not comparable with the JAX artifact's; lower is better",
        "per_view": rows,
        "device": _scenes.device_name(dev),
    }
    timing = {"corpus_secs": corpus_secs, "train_secs": train_secs,
              "steps_per_sec": _scenes.rate(args.steps, train_secs)}
    _scenes.write_json(args.out_json, results, timing)
    return results, timing


if __name__ == "__main__":
    main()
