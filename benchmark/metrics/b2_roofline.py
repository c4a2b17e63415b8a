"""The serving kernel's share of its roofline (benchmark/rooflines.py).
`b2_roofline.viewer` and `b2_roofline.paths` read it."""
from benchmark.rooflines import serve_kernel


def read(ctx):
    return serve_kernel(ctx)
