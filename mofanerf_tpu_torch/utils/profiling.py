"""Profiling and numerical-debug instrumentation (counterpart of
mofanerf_tpu/utils/profiling.py).

- `trace(log_dir)`: a context manager around `torch.profiler.profile` (the
  host and, with a card, its kernels) that writes a Chrome trace file,
  `<log_dir>/trace_<pid>_<n>.json`, loadable in Perfetto or TensorBoard.
- `annotate(name)`: a named range in the trace (`record_function`).
- `enable_nan_checks()`: `torch.autograd.set_detect_anomaly`. JAX's
  `jax_debug_nans` raises on a NaN out of any operation, forward included;
  anomaly mode checks the backward pass (a NaN out of a gradient raises
  and names the forward operation that made it), and costs that pass time.
- `StepTimer`: steady-state steps/sec with warmup exclusion.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the profiler, whose `trace_path` names the
    file written when the block ends."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    return torch.profiler.record_function(name)


def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.t0 = None

    def tick(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self.t0 is None or self.count <= self.warmup:
            return float("nan")
        return (self.count - self.warmup) / (time.perf_counter() - self.t0)
