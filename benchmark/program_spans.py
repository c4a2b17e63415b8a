"""What the program's own spans and counters recorded: the tables of
`mofanerf_tpu_torch/utils/profiling.py`, `span_totals` ({name: [count, host
seconds]}) and `counters` ({name: count}). The program fills them only while a
`torch.profiler` records, which in a `run.py` process is the traced window
alone. A program without the tables, or one that recorded no span, gives
None, so a metric that reads them falls silent there."""
from __future__ import annotations


def _tables():
    from mofanerf_tpu_torch.utils import profiling

    spans = getattr(profiling, "span_totals", None)
    return (spans, getattr(profiling, "counters", None)) if spans else (None, None)


def span(name: str) -> tuple | None:
    """(count, host seconds) of the program's span `name`; None where it
    never ran."""
    spans, _ = _tables()
    count, seconds = (spans or {}).get(name, (0, 0.0))
    return (count, seconds) if count else None


def counter(name: str) -> int | None:
    """The program's counter `name` (0 where it never counted); None where the
    program recorded no span at all."""
    spans, counters = _tables()
    if spans is None or counters is None:
        return None
    return counters.get(name, 0)


def per(value, ctx: dict, unit: str) -> float | None:
    """value over the window's `unit` count (`ctx["info"]`); None where either
    is missing."""
    n = ctx["info"].get(unit)
    if value is None or not n:
        return None
    return value / n
