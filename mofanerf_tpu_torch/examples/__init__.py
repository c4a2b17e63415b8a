"""The JAX package's sixteen example scripts (examples/*.py), ported. The
synthetic-data studies render their own scenes with the software rasterizer,
train a teacher and read what it learned, and the distillation studies serve
students through the serving kernel (`_scenes.py`); the flagship chain trains
the full-width model on `studydata/faces8` and serves, fits, refines and reads
it (`_flagship.py`). Run one as `python -m mofanerf_tpu_torch.examples.<name>`
(on the card by default; `--device cpu` runs the plain PyTorch versions)."""
