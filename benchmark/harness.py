"""One run of one cell: find its configuration, traffic and metrics by the
names in BENCHMARK.json, set the runner up, measure the window, read the
trace, compare with the reference, and make the result line."""
from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "mofanerf_tpu"})


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The workload `name` with its configuration file, traffic file and
    cell file (`cells/<name>.json`: the limits of its comparison, set for this
    configuration under this traffic) read, and the metrics it reports."""
    wl = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], wl["config"], "configuration")
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR.name / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / BENCH_DIR.name / "cells" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"workload": wl, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": layer, "root": root}


def runner_class(traffic: dict):
    return importlib.import_module(f"benchmark.runners.{traffic['runner']}").Runner


def metric_file(name: str, root: Path = ROOT) -> Path:
    """benchmark/metrics/<name>.py, or else the file of the name's part before
    its first dot: one reader for a quantity split by cell (`device_idle.train`,
    `device_idle.frames`, ... read by `device_idle.py`)."""
    d = root / BENCH_DIR.name / "metrics"
    own = d / f"{name}.py"
    return own if own.exists() else d / f"{name.split('.')[0]}.py"


def metric_reader(name: str, root: Path = ROOT):
    """`read(ctx)` of the metric's file (`metric_file`)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  metric_file(name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def measure(drv, seconds: float, tracing: bool = False) -> float:
    """Units back to back until `seconds` have passed, the last one finished:
    the window's length in seconds, from its first unit's start to the card's
    end of its last."""
    drv.sync()
    drv.begin()
    t0 = time.perf_counter()
    while True:
        drv.unit(tracing)
        if time.perf_counter() - t0 >= seconds:
            break
    drv.sync()
    return time.perf_counter() - t0


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(c: dict, seed: int, seconds: float, trace: bool, t_start: float, device,
        workdir: str, chips: int = 1, marks: list | None = None) -> tuple:
    """(result dict, [(name, value, limit)]) of one run of the cell `c`.
    `marks`, if given, gets the set-up's steps appended as (name, clock
    time): the runner's own (its `marks`), then its end."""
    import torch

    from mofanerf_tpu_torch.ops import field_kernel, serve_kernel

    traffic = c["traffic"]
    drv = runner_class(traffic)(c["config"], traffic, seed, device, workdir)
    if marks is not None:
        marks += getattr(drv, "marks", []) + [("runner", time.perf_counter())]
    on_card = torch.device(device).type == "cuda"
    extra: dict = {}
    if not trace:
        t_first = time.perf_counter()
        window = measure(drv, seconds)
        values = drv.end_to_end(window)
        values["setup_s"] = t_first - t_start
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
        units = drv.layer_info()
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark import trace_reading

        for k in (field_kernel, serve_kernel):
            k.launch_shapes.clear()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(trace_reading.WINDOW_SPAN):
                measure(drv, min(seconds, traffic["trace_seconds"]), tracing=True)
        red = trace_reading.reduce(prof)
        del prof
        ctx = dict(red, info=drv.layer_info(), config=c["config"], traffic=traffic,
                   b1_shapes=collections.Counter(field_kernel.launch_shapes),
                   b2_shapes=collections.Counter(serve_kernel.launch_shapes))
        metrics = {}
        for m in c["per_layer"]:
            v = metric_reader(m["name"], c.get("root", ROOT))(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        units = ctx["info"]
        extra = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    sample = drv.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = drv.numbers(sample, "program")
    limits = c["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    device_info.update(extra)
    if on_card:
        device_info["power_limit_w"] = power_limit_w()
    attempted = units.get("requests", units.get("frames", units.get("steps", 0)))
    failed = sum(1 for _, v, lim in checks if not (math.isfinite(v) and v <= lim))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out, checks
