"""The train step's share of the card's bf16 peak: the model's operations of
the traced steps (fields and texture encoder, forward and backward, three
times the forward's; benchmark/counts.py) over the traced window."""
from benchmark.counts import PEAK_BF16


def read(ctx):
    info = ctx["info"]
    if not info.get("steps"):
        return None
    return 100.0 * info["steps"] * info["step_flops"] / ctx["window_s"] / PEAK_BF16
