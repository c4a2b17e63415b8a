"""The serving path's share of the card's bf16 peak: the student's operations
on the samples of the rays that hit the head's box, over the traced window."""
from benchmark.counts import PEAK_BF16, student_flops_per_sample


def read(ctx):
    info = ctx["info"]
    if not info.get("hit_rays"):
        return None
    depth, width, mr = info["student"]
    ops = info["hit_rays"] * info["n_samples"] * student_flops_per_sample(depth, width, mr)
    return 100.0 * ops / ctx["window_s"] / PEAK_BF16
