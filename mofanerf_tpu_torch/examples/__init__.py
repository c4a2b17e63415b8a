"""The JAX package's synthetic-data studies (examples/*.py), ported: each
renders its own scene with the software rasterizer, trains a teacher, and
reads what it learned; the distillation studies then serve students through
the serving kernel. Run one as `python -m mofanerf_tpu_torch.examples.<name>`
(on the card by default; `--device cpu` runs the plain PyTorch versions)."""
