"""Aggregate the identity-count scaling table of the morphable studies
(counterpart of examples/morphable_scaling.py of the JAX package; host only).

Collects the morphable studies' JSONs of `--artifacts_dir` (8 / 16 / 32 / 64
identities, one recipe: flagship dims, white_bkgd, 128^2, device-resident
data) into one scaling curve (held-out PSNR/SSIM, identity separation, the
training budget an identity) and a resolution axis (128^2 against a 256^2
fine-tune), skipping the studies it does not find.

Usage: python -m mofanerf_tpu_torch.examples.morphable_scaling \
    [--artifacts_dir DIR (default: examples/artifacts of this package)]
"""
from __future__ import annotations

import argparse
import json
import os

from mofanerf_tpu_torch.examples import _flagship


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifacts_dir", default=_flagship.ARTIFACTS,
                   help="where the morphable studies' JSONs are")
    p.add_argument("--out_json", default=_flagship.artifact("morphable_scaling.json"))
    args = p.parse_args(argv)
    root = args.artifacts_dir

    points = []
    # the curtain-free (near 11/21) studies first where both exist: the near=8
    # checkpoints at 32 ids converged to a view-dependent light field
    for n_ids, fnames in ((8, ["morphable_flagship.json"]), (16, ["morphable16.json"]),
                          (32, ["morphable32nc.json", "morphable32.json"]),
                          (64, ["morphable64.json"])):
        path = next((q for f in fnames if os.path.exists(q := os.path.join(root, f))), None)
        if path is None:
            print(f"skip {fnames[0]} (missing)")
            continue
        j = _load(path)
        per = j["per_identity"]
        vals = list(per.values() if isinstance(per, dict) else per)
        psnrs = [v["psnr"] for v in vals]
        cross = j.get("cross_identity", [])
        own = [c["own_psnr"] for c in cross]
        oth = [c["cross_psnr"] for c in cross]
        step = int(j.get("model", {}).get("step", 0))
        points.append({
            "n_ids": n_ids,
            "source": os.path.basename(path),
            "train_step": step,
            "iters_per_identity": round(step / n_ids) if step else None,
            "heldout_psnr_db": round(float(j["mean_heldout_psnr"]), 2),
            "heldout_ssim": round(float(j["mean_heldout_ssim"]), 4),
            "worst_identity_psnr_db": round(min(psnrs), 2),
            "separation_own_psnr_db": round(sum(own) / len(own), 2) if own else None,
            "separation_cross_psnr_db": round(sum(oth) / len(oth), 2) if oth else None,
            # 0.0 = real 3D structure; ~1.0 = a degenerate near-plane curtain
            "curtain_fraction": j.get("mean_curtain_fraction"),
            "geometry_caveat": bool(j.get("geometry_note")),
        })
    # the resolution axis: the 32-identity family at 128^2 against a 256^2 fine-tune
    res_points = []
    for res, fname in ((128, "morphable32.json"), (256, "morphable32hi.json")):
        path = os.path.join(root, fname)
        if not os.path.exists(path):
            print(f"skip {fname} (missing)")
            continue
        j = _load(path)
        res_points.append({
            "train_res": res,
            "source": fname,
            "train_step": int(j.get("model", {}).get("step", 0)),
            "heldout_psnr_db": round(float(j["mean_heldout_psnr"]), 2),
            "heldout_ssim": round(float(j["mean_heldout_ssim"]), 4),
        })

    out = {
        "study": "identity-count scaling of the flagship morphable model "
                 "(reference target: 300 ids, configs/exp_mofanerf.txt:6)",
        "recipe": "8x256+10x1024 bf16, white_bkgd, 128^2 multiview, device-resident data, "
                  "lr 5e-5 + precrop + annealed landmark bias",
        "points": points,
        "resolution_points": res_points,
        "note": "per-identity quality declines slowly with identity count at a fixed "
                "iteration budget; iters_per_identity is the honest cost axis (the "
                "reference trains 600k iters for 300 ids = 2k/id at 512^2).",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
    with open(args.out_json, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=2))
    return out, {}


if __name__ == "__main__":
    main()
