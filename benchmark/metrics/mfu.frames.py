"""The teacher frames' share of the card's bf16 peak: the fields' operations
on every sample of the traced window's rays (benchmark/counts.py), over the
window."""
from benchmark.counts import PEAK_BF16


def read(ctx):
    info = ctx["info"]
    if not info.get("rays"):
        return None
    return 100.0 * info["rays"] * info["ray_flops"] / ctx["window_s"] / PEAK_BF16
