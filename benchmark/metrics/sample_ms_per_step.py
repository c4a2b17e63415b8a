"""Host milliseconds a train step spends drawing its batch and its random
generators: the program's span `mofanerf.train.sample`
(benchmark/program_spans.py) over the traced window's steps."""
from benchmark.program_spans import per, span


def read(ctx):
    s = span("mofanerf.train.sample")
    return None if s is None else per(1e3 * s[1], ctx, "steps")
