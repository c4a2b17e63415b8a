"""The field kernel's share of its roofline at the coarse field's width
(benchmark/rooflines.py)."""
from benchmark.rooflines import field_kernel


def read(ctx):
    return field_kernel(ctx, "coarse")
