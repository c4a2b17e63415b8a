"""Kernels the card ran in the traced window, a train step."""
from benchmark.trace_reading import kernel_seconds


def read(ctx):
    steps = ctx["info"].get("steps")
    if not steps:
        return None
    return kernel_seconds(ctx, lambda name: True)[0] / steps
