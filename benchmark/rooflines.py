"""Roofline shares of the two kernels over a traced window, which the per-layer
metrics of each cell read."""
from benchmark.counts import (PEAK_BF16, PEAK_BYTES, field_launch_bound_s, serve_kernel_bytes,
                               student_flops_per_sample)
from benchmark.trace_reading import field_kernel_split, kernel_seconds


def serve_kernel(ctx):
    """The serving kernel's share: the least time its launches could take (the
    operations of the rays that hit the head's box at the bf16 peak, or the
    launches' bytes at HBM's) over the device time of its launches."""
    n, secs = kernel_seconds(ctx, lambda name: "serve_kernel" in name)
    info = ctx["info"]
    if not n or secs <= 0 or not ctx["b2_shapes"]:
        return None
    depth, width, mr = info["student"]
    ops = info["hit_rays"] * info["n_samples"] * student_flops_per_sample(depth, width, mr)
    nbytes = sum(count * serve_kernel_bytes(key[4], key[1], key[2], key[3],
                                            2 if key[0] == "bfloat16" else 4)
                 for key, count in ctx["b2_shapes"].items())
    return 100.0 * max(ops / PEAK_BF16, nbytes / PEAK_BYTES) / secs


def field_kernel(ctx, field: str):
    """The field kernel's share at the `field` ("coarse" or "fine") width: the
    least time of its launches there, by their shapes, over their device time."""
    cfg = ctx["config"]
    widths = (cfg["netwidth"], cfg["netwidth_fine"])
    width = cfg["netwidth_fine"] if field == "fine" else cfg["netwidth"]
    bound = sum(count * field_launch_bound_s(width, key[1], cfg["multires"], key[3], key[4])
                for key, count in ctx["b1_shapes"].items() if key[2] == width)
    n, secs = field_kernel_split(ctx, width, widths)
    if not n or secs <= 0 or bound <= 0:
        return None
    return 100.0 * bound / secs
