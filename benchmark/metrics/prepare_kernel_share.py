"""Share of the served frames whose rays and operands the `serve_rays` kernel
made on the card (`ops/serve_rays.py`): 100 x the program's counter
`serve_rays_frames`, which each launch raises by its frames
(benchmark/program_spans.py), over the traced window's frames. None where
tracing recorded nothing or the counter never counted (a program without
`serve_rays`, or one whose frames took the plain version on the CPU)."""
from benchmark.program_spans import counter, per


def read(ctx):
    made = counter("serve_rays_frames")
    return per(100.0 * made, ctx, "frames") if made else None
