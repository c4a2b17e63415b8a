"""Shared BatchNorm folding for inference-only weight conversion (a numpy
copy of mofanerf_tpu/preprocess/bn_fold.py)."""
from __future__ import annotations

import numpy as np


def fold_bn(sd, prefix: str, eps: float = 1e-5):
    """torch BatchNorm2d running stats -> (scale, shift) so that
    `x * scale + shift == BN(x)` at inference."""
    g = np.asarray(sd[f"{prefix}.weight"])
    b = np.asarray(sd[f"{prefix}.bias"])
    m = np.asarray(sd[f"{prefix}.running_mean"])
    v = np.asarray(sd[f"{prefix}.running_var"])
    scale = g / np.sqrt(v + eps)
    return scale.astype(np.float32), (b - m * scale).astype(np.float32)
