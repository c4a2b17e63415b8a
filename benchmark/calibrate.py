"""Readings that the limits of a cell's comparison are set from, on the card
at the cell's own size, in one process: for each seed the program's numbers
(a short window at the cell's load, then the comparison a run makes), and on
the first `--control_seeds` seeds the control's (the reference in float8
e4m3 products in the program's place) and, for a training cell, a fault's
(the reference trained on half of each batch).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control_seeds 3 \
        --seconds 2 --out <file.json>

The benchmark's runs never run this."""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(n: int, base: int) -> list:
    """n seeds beside 2**31, as large as the benchmark's own are drawn."""
    return [base + 7919 * k for k in range(n)]


def readings(c: dict, seed: int, seconds: float, control: bool, device, workdir: str) -> dict:
    import torch

    from benchmark import harness
    from benchmark.reference.precision import Precision

    t0 = time.perf_counter()
    drv = harness.runner_class(c["traffic"])(c["config"], c["traffic"], seed, device, workdir)
    if seconds > 0:
        harness.measure(drv, seconds)
    sample = drv.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "program": drv.numbers(sample, "program")}
    if control:
        out["control_fp8"] = drv.numbers(sample, Precision("fp8"))
        out["reference_bf16"] = drv.numbers(sample, Precision("bf16"))
        if c["traffic"]["runner"] == "train":
            out["fault_half_batch"] = drv.numbers(sample, ("keep", 0.5))
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--seed_base", type=int, default=2**31 + 101)
    p.add_argument("--seed_list", type=int, nargs="*", default=None,
                   help="these seeds instead of --seeds from --seed_base")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="the window before the comparison; 0 runs none (training compares "
                        "the steps set-up drives)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    c = harness.cell(harness.load_benchmark(), args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for k, s in enumerate(args.seed_list or seeds(args.seeds, args.seed_base)):
        workdir = tempfile.mkdtemp(prefix="mofanerf-cal-")
        try:
            r = readings(c, s, args.seconds, k < args.control_seeds, torch.device(args.device),
                         workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        rows.append(r)
        print(json.dumps(r), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
