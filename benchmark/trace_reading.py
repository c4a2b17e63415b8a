"""Reading a `torch.profiler` trace of a window: the card's busy time, its
operations by name, its idle gaps by what the host was doing, and the
kernels that per-layer metrics sum."""
from __future__ import annotations

import collections

import numpy as np

WINDOW_SPAN = "bench.window"


def _t(e):
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
    return start, start + dur


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def reduce(prof) -> dict:
    """{'window_s', 'busy_s', 'device': [(name, seconds)] of every device
    operation in the window in order, 'device_ops' (top 10 by time),
    'idle_gaps' (top 10 by what the host was doing)}."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() != cuda]
    if not win:
        raise RuntimeError("the trace holds no window span")
    ws, we = _t(win[0])
    main = win[0].start_thread_id()
    dev, host = [], []
    for e in events:
        name = e.name()
        if name.startswith("bench."):
            continue
        s, t = _t(e)
        if e.device_type() == cuda:
            if t > ws and s < we and t > s:
                dev.append((name, max(s, ws), min(t, we)))
        elif t > s and e.start_thread_id() == main:
            host.append((name, s, t))
    dev.sort(key=lambda x: x[1])
    busy = _merge([(s, t) for _, s, t in dev])
    busy_s = sum(t - s for s, t in busy) / 1e9
    by_name = collections.Counter()
    for name, s, t in dev:
        by_name[name] += (t - s) / 1e9
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_s,
            "device": [(n, (t - s) / 1e9) for n, s, t in dev],
            "device_ops": [[n[:160], v] for n, v in by_name.most_common(10)],
            "idle_gaps": _label_gaps(gaps, host)}


def _label_gaps(gaps, host, n_longest: int = 2000):
    """The idle gaps' seconds summed by the innermost host operation under way
    at each gap's middle (the longest `n_longest` gaps; the rest summed as
    'shorter gaps')."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    starts = np.array([s for _, s, _ in host], np.int64) if host else np.zeros(0, np.int64)
    ends = np.array([t for _, _, t in host], np.int64) if host else np.zeros(0, np.int64)
    by = collections.Counter()
    for s, t in gaps[:n_longest]:
        mid = (s + t) // 2
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if hit.size:
            k = hit[np.argmin(ends[hit] - starts[hit])]
            label = host[k][0]
        else:
            label = "host outside any traced operation"
        by[label[:160]] += (t - s) / 1e9
    rest = sum(t - s for s, t in gaps[n_longest:]) / 1e9
    if rest:
        by["shorter gaps"] += rest
    return [[n, v] for n, v in by.most_common(10)]


# --- what the per-layer metrics sum --------------------------------------------------

def kernel_seconds(ctx: dict, match) -> tuple:
    """(launches, seconds) of the window's kernels whose name `match` accepts."""
    ks = [d for n, d in ctx["device"] if is_kernel(n) and match(n)]
    return len(ks), sum(ks)


def field_kernel_split(ctx: dict, width: int, widths: tuple) -> tuple:
    """(launches, seconds) of the field kernel's launches at `width`, told
    apart by the width in the kernel's template name where the names
    differ, else by launch order: a frame's packets launch the widths in
    the order `widths` gives (coarse, then fine)."""
    b1 = [(n, d) for n, d in ctx["device"] if "field_kernel" in n]
    names = {n for n, _ in b1}
    if len(names) > 1:
        tagged = [(n, d) for n, d in b1 if f"<{width}>" in n or f"<{width}," in n]
        if tagged:
            return len(tagged), sum(d for _, d in tagged)
    k = widths.index(width)
    mine = [d for j, (_, d) in enumerate(b1) if j % len(widths) == k]
    return len(mine), sum(mine)
