"""Host milliseconds a packet takes to launch: the program's span
`mofanerf.sweep.packet` around each packet's call (the serving kernel
wrapper's checks and its launch; benchmark/program_spans.py) over its count."""
from benchmark.program_spans import span


def read(ctx):
    s = span("mofanerf.sweep.packet")
    return None if s is None else 1e3 * s[1] / s[0]
