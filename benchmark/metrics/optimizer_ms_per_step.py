"""Host milliseconds a train step spends in Adam, the finite check and the
skip's selects: the program's span `mofanerf.train.optimizer`
(benchmark/program_spans.py) over the traced window's steps."""
from benchmark.program_spans import per, span


def read(ctx):
    s = span("mofanerf.train.optimizer")
    return None if s is None else per(1e3 * s[1], ctx, "steps")
