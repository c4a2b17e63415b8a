"""Host milliseconds a served frame spends before its first packet: its rays
(`mofanerf.sweep.rays`), and its set-up, compaction, padding and ray operands
(`mofanerf.sweep.prepare`), the program's spans (benchmark/program_spans.py),
over the traced window's frames."""
from benchmark.program_spans import per, span


def read(ctx):
    rays, prep = span("mofanerf.sweep.rays"), span("mofanerf.sweep.prepare")
    if rays is None or prep is None:
        return None
    return per(1e3 * (rays[1] + prep[1]), ctx, "frames")
