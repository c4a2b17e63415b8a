"""Profiling and numerical-debug instrumentation (counterpart of
mofanerf_tpu/utils/profiling.py).

Tracing is on exactly while a `torch.profiler` records
(`torch._C._autograd._profiler_enabled()`, checked by `on()`); no flag or
environment variable turns it on. `trace(log_dir)` records, and so does
`benchmark/run.py --trace 1`.

- `trace(log_dir)`: a context manager around `torch.profiler.profile` (the
  host and, with a card, its kernels) that writes a Chrome trace file,
  `<log_dir>/trace_<pid>_<n>.json`, loadable in Perfetto or TensorBoard. It
  is the one exporter: the spans below land in its file.
- `annotate(name)`: a span. Off, it costs one check and returns one shared
  `contextlib.nullcontext()`; call sites whose name needs formatting build it
  only under `on()`. On, it opens a host range named `name` in the trace, on
  the clock of the card's kernels (`_Span`), and adds its host duration and a
  count to `span_totals[name] = [count, seconds]`.
- `host_read(t)`: `t.item()`, the one way the serving and training paths read
  a number back from the card (which makes the host wait for it). On, the
  read is the span `mofanerf.host_read` and adds one to
  `counters["host_reads"]`. Under `torch.cuda.set_sync_debug_mode` it lifts
  the mode for its own read, so the mode finds every other wait.
- `count(name, n)`: adds n to `counters[name]` while tracing is on
  (`ops/serve_rays.py` counts, at each launch, the frames whose rays its
  kernel makes).
- `reset()`: empties `span_totals` and `counters`. They are kept in memory,
  for the life of the process, and never written out by the program.
- `enable_nan_checks()`: `torch.autograd.set_detect_anomaly`. JAX's
  `jax_debug_nans` raises on a NaN out of any operation, forward included;
  anomaly mode checks the backward pass (a NaN out of a gradient raises
  and names the forward operation that made it), and costs that pass time.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

_TRACES = itertools.count()
_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()   # the host-data loop's sampler spans run on its prefetch thread

span_totals: dict = {}     # name -> [count, host seconds]
counters: dict = {}        # name -> count


def on() -> bool:
    """Whether a torch.profiler records in this process now."""
    return torch._C._autograd._profiler_enabled()


def reset() -> None:
    with _LOCK:
        span_totals.clear()
        counters.clear()


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


class _Span:
    """A host range of the trace whose host time, inside the range, is added
    to `span_totals`. The range is `_RecordFunctionFast`, as torch's own
    compile-time spans: `record_function` also puts a copy of the range on the
    card's timeline of a CUDA trace (a `gpu_user_annotation` over its kernels),
    which a reading of the card's busy time would count as work, and it costs
    ~9.5 µs a range against ~1.9 (H100 machine's host, profiler on)."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        seconds = (time.perf_counter_ns() - self.t0) / 1e9
        self.range.__exit__(*exc)
        with _LOCK:
            total = span_totals.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] += seconds
        return False


def annotate(name: str):
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def _item(t: torch.Tensor):
    mode = torch.cuda.get_sync_debug_mode() if t.is_cuda else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
        try:
            return t.item()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return t.item()


def host_read(t: torch.Tensor):
    """`t.item()`: a one-element tensor's value on the host."""
    if not torch._C._autograd._profiler_enabled():
        return _item(t)
    with _Span("mofanerf.host_read"):
        count("host_reads")
        return _item(t)


def count(name: str, n: int = 1) -> None:
    """Add n to `counters[name]` while a torch.profiler records."""
    if torch._C._autograd._profiler_enabled():
        with _LOCK:
            counters[name] = counters.get(name, 0) + n


def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
