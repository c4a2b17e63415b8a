"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` a `breakdown`, and last `checks`: each number the comparison
with the reference read, beside its limit (also the last lines of standard
error). Without a card, or with fewer than the cell needs, it exits 2 and
prints no result. See README.md for how cells, configurations, traffic
mixes and metrics are added, and where caches live.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; few
    host threads."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(k, "4")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import json

    import torch

    from benchmark import harness

    marks = [("import", time.perf_counter())]

    bench = harness.load_benchmark()
    c = harness.cell(bench, args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell {args.workload} needs {chips} CUDA card(s); this machine "
              f"has {n}. Nothing was measured.", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    marks.append(("cuda", time.perf_counter()))
    workdir = tempfile.mkdtemp(prefix="mofanerf-bench-")
    try:
        out, checks = harness.run(c, args.seed, args.seconds, bool(args.trace), T_START,
                                  dev, workdir, chips, marks)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    steps = zip([("start", T_START)] + marks, marks)
    print("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in steps),
          file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: the process loaded {', '.join(bad)}; the benchmark may load none of "
              f"{', '.join(sorted(harness.FORBIDDEN))}. No result.", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
