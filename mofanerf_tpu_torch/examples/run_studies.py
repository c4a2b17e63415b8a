"""Run several studies in one process on the card, one after another, and
report each one's wall time and the two kernels' launches.

    python -m mofanerf_tpu_torch.examples.run_studies --out DIR \
        "dmorph distill_morphable" "dexp distill_expression --flagship" ...

Each argument is `tag study [flags...]`; the study runs as `--out DIR/tag`
(the expression and texture studies take it as their first argument; the
flagship chain's studies write their JSON and their working files under
DIR/tag, see `study_argv`) with its flags. `--basedir B` passes the flagship
run's directory (where morphable_flagship trains, and where the others read
its checkpoint) to the chain's studies. The kernels are built once, before
the first study. Each study
runs through `run_study`. A study that raises (a gate) is reported and the
next one runs. Prints one `[STUDY]` JSON line a study, and writes them all
to `DIR/studies.json`.

Two checks of a teacher's convergence, for every study of the process:
`--teacher_seed N` makes each teacher from seed N in place of the scripts' 0
(its init and its draws; the host sampler keeps its seed), and
`--exact_bf16_sums` turns off cuBLAS's reduced-precision reductions of bf16
products (`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`,
on by default in PyTorch; XLA does not reduce so).
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import time
import traceback

import torch

from mofanerf_tpu_torch.examples import _scenes
from mofanerf_tpu_torch.ops import field_kernel as fk
from mofanerf_tpu_torch.ops import serve_kernel as sk

POSITIONAL_OUT = ("expression_synthetic", "texture_synthetic")
# the flagship chain's studies: the JSON each writes, and its flags for working files
FLAGSHIP_OUT = {
    "morphable_flagship": ("morphable_flagship.json", {}),
    "serve_flagship": ("serve_flagship.json", {}),
    "fit_quality": ("fit_quality.json", {"--out_dir": "fit"}),
    "expression_matrix": ("expression_matrix.json", {}),
    "refine_nerf_corpus": ("refine_nerf_quality.json", {"--corpus_dir": "corpus"}),
    "wild_demo": ("wild_demo.json", {"--work_dir": "wild", "--out_png": "wild_demo.png"}),
}


def study_argv(study: str, out: str, flags: list, basedir: str | None = None) -> list:
    """The argv of a study run with its outputs under `out`: `--out out` (the expression
    and texture studies take it positionally); refine_synthetic's JSON as `--artifacts`;
    the flagship chain's `--out_json` and working directories under `out`, and
    `--basedir` when given; morphable_scaling's `--out_json`."""
    if study in POSITIONAL_OUT:
        return [out] + flags
    if study == "refine_synthetic":
        return ["--out", out, "--artifacts", os.path.join(out, "refine_quality.json")] + flags
    if study == "morphable_scaling":
        return ["--out_json", os.path.join(out, "morphable_scaling.json")] + flags
    if study in FLAGSHIP_OUT:
        name, dirs = FLAGSHIP_OUT[study]
        argv = ["--out_json", os.path.join(out, name)]
        for flag, sub in dirs.items():
            argv += [flag, os.path.join(out, sub)]
        return argv + (["--basedir", basedir] if basedir else []) + flags
    return ["--out", out] + flags


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_study(study: str, argv: list) -> dict:
    """The study's main() on `argv`, the field and serving kernels' launch counts
    (total and by shape) zeroed just before it and read just after: {"study", "argv",
    "status" ("ok", or what it raised: a gate), "wall_secs", "launches" [field,
    serving], "launch_shapes" {"field", "serve": [[*shape, launches], ...]}, "timing"}."""
    mod = importlib.import_module(f"mofanerf_tpu_torch.examples.{study}")
    _sync()
    fk.launch_count = sk.launch_count = 0
    fk.launch_shapes.clear()
    sk.launch_shapes.clear()
    t0 = time.perf_counter()
    timing, status = None, "ok"
    try:
        _, timing = mod.main(argv)
    except Exception as e:   # a gate, reported
        traceback.print_exc()
        status = f"{type(e).__name__}: {e}"[:300]
    _sync()
    return {"study": study, "argv": argv, "status": status,
            "wall_secs": time.perf_counter() - t0,
            "launches": [fk.launch_count, sk.launch_count],
            "launch_shapes": {name: [[*shape, n] for shape, n in sorted(c.items())]
                              for name, c in (("field", fk.launch_shapes),
                                              ("serve", sk.launch_shapes))},
            "timing": timing}


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("runs", nargs="+", help='"tag study [flags...]"')
    p.add_argument("--teacher_seed", type=int, default=0)
    p.add_argument("--exact_bf16_sums", action="store_true")
    p.add_argument("--basedir", default=None,
                   help="the flagship run's directory, passed to the chain's studies")
    args = p.parse_args(argv)
    if args.teacher_seed:
        _scenes.train_teacher = functools.partial(_scenes.train_teacher, seed=args.teacher_seed)
    if args.exact_bf16_sums:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from mofanerf_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for run in args.runs:
        tag, study, *flags = run.split()
        out = os.path.join(args.out, tag)
        rows.append(dict(run_study(study, study_argv(study, out, flags, args.basedir)),
                         tag=tag))
        print("[STUDY] " + json.dumps(rows[-1]), flush=True)
        with open(os.path.join(args.out, "studies.json"), "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
