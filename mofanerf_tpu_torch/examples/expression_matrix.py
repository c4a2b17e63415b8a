"""Expression-transfer matrix: render every expression code and score it
against every expression's rasterized ground truth at shared held-out poses
(counterpart of examples/expression_matrix.py of the JAX package).

For each identity and pose, M[c, g] = PSNR(render with code c, GT of
expression g) over the whole bank (the renders through the field kernel on
the card, the GT rasterized on demand), and per expression:

- row margin (code c): M[c, c] - max_{g != c} M[c, g]: does code c look more
  like expression c's face than any other's?
- col margin (gt g): M[g, g] - max_{c != g} M[c, g]: is code g the best code
  for expression g's face?

A code-blind model scores ~0 on both. Writes `--out_json` (default
examples/artifacts/expression_matrix.json of this package).

The defaults name the JAX package's 16-identity x 20-expression run; on the
flagship run: --data studydata/faces8 --expname morphable_flagship --n_ids 8.
CPU smoke: --small --device cpu on morphable_flagship --small's run.
"""
from __future__ import annotations

import argparse

import numpy as np

from mofanerf_tpu_torch.examples import _flagship, _scenes
from mofanerf_tpu_torch.render.renderer import render_frame


def main(argv=None):
    p = argparse.ArgumentParser()
    _flagship.add_model_flags(p, data="studydata/faces16x20", expname="morphable16x20r5",
                              n_ids=16)
    p.add_argument("--ids", type=int, default=2, help="identities to measure")
    p.add_argument("--poses", type=int, default=2, help="held-out poses per id")
    p.add_argument("--out_json", default=_flagship.artifact("expression_matrix.json"))
    p.add_argument("--near", type=float, default=8.0)
    p.add_argument("--far", type=float, default=26.0)
    p.add_argument("--small", action="store_true",
                   help="morphable_flagship --small's toy dims, to read its checkpoint in a "
                        "CPU smoke (a flag the JAX script lacks)")
    args = p.parse_args(argv)
    dev = _scenes.device_of(args)

    cfg = _flagship.data_config(args, white_bkgd=True, near=args.near, far=args.far,
                                **(_flagship.SMALL_FLAGSHIP if args.small else {}))
    spec = cfg.model_spec()
    params, step = _flagship.restore(cfg, spec, dev, required=True)
    print("eval at step", step)
    fc = _flagship.Faces(cfg, params, spec, range(args.n_ids), dev)
    H, W, K = fc.H, fc.W, fc.K
    bank = fc.exp_bank

    def psnr(a, b):
        return float(-10 * np.log10(max(float(np.mean((np.asarray(a) - np.asarray(b)) ** 2)),
                                        1e-12)))

    B = len(bank)
    out = {"study": "expression-transfer matrix: every code vs every expression's "
                    "rasterized GT at shared held-out poses",
           "step": int(step), "bank": bank, "per_id": {}}
    all_row, all_col = [], []
    for pid in range(args.ids):
        tidx = fc.test_idx[pid]
        pose_picks = tidx[:: max(1, len(tidx) // args.poses)][: args.poses]
        M = np.zeros((B, B))
        for i0 in pose_picks:
            gts = [fc.raster_gt(fc.face_params[pid], g, i0, H, True) for g in bank]
            for ci, c in enumerate(bank):
                r = _scenes.np_maps(render_frame(params, spec, fc.cond(pid, c), H, W, K,
                                                 fc.pose(i0)))["rgb"]
                for gi in range(B):
                    M[ci, gi] += psnr(r, gts[gi]) / len(pose_picks)
        diag = np.diag(M)
        off = M - np.eye(B) * 1e9
        row_m = diag - off.max(1)
        col_m = diag - off.max(0)
        all_row.append(row_m)
        all_col.append(col_m)
        print(f"id {pid}: diag mean {diag.mean():.2f} dB, rows+ {(row_m > 0).sum()}/{B}, "
              f"cols+ {(col_m > 0).sum()}/{B}", flush=True)
        out["per_id"][pid] = {
            "matrix_psnr_db": np.round(M, 3).tolist(),
            "diag_mean_db": round(float(diag.mean()), 3),
            "row_margin_db": np.round(row_m, 3).tolist(),
            "col_margin_db": np.round(col_m, 3).tolist(),
        }
    row_mean = np.mean(all_row, axis=0)
    col_mean = np.mean(all_col, axis=0)
    out["summary"] = {
        "rows_positive_mean_over_ids": int((row_mean > 0).sum()),
        "cols_positive_mean_over_ids": int((col_mean > 0).sum()),
        "bank_size": B,
        "mean_row_margin_db": round(float(row_mean.mean()), 3),
        "mean_col_margin_db": round(float(col_mean.mean()), 3),
        "per_exp_row_margin_db": {int(bank[i]): round(float(row_mean[i]), 3)
                                  for i in range(B)},
    }
    out["device"] = _scenes.device_name(dev)
    print(f"rows positive (id-mean margins): {out['summary']['rows_positive_mean_over_ids']}"
          f"/{B}, cols: {out['summary']['cols_positive_mean_over_ids']}/{B}")
    _scenes.write_json(args.out_json, out)
    return out, {}


if __name__ == "__main__":
    main()
