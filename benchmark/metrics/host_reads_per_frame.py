"""Numbers a served frame reads back from the card (each read makes the host
wait for the card's queued work): the program's counter `host_reads`
(benchmark/program_spans.py) over the traced window's frames."""
from benchmark.program_spans import counter, per


def read(ctx):
    return per(counter("host_reads"), ctx, "frames")
