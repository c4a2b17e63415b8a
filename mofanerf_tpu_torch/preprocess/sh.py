"""Spherical-harmonics lighting utilities (NumPy).

Parity with the used surface of tools/fit_data_pre/utils/utils_SH.py:7-35:
9-term real SH basis in the DPR convention — order
(1, Y, Z, X, YX, YZ, 3Z^2-1, XZ, X^2-Y^2), ALL-POSITIVE coefficients —
with cosine-lobe attenuation and shading reconstruction, so coefficient
files produced for the reference (e.g. fcspLight.npy) reconstruct the same
shading here. A numpy copy of mofanerf_tpu/preprocess/sh.py.
(The reference additionally wraps pyshtools for convention conversion; that
dependency is absent here and those helpers were only used by offline
analysis scripts.)
"""
from __future__ import annotations

import numpy as np

# cosine-lobe attenuation per band (Ramamoorthi & Hanrahan)
_A = [np.pi, 2 * np.pi / 3.0, np.pi / 4.0]


def sh_basis(normals: np.ndarray) -> np.ndarray:
    """normals: [N, 3] unit vectors -> [N, 9] attenuated SH basis."""
    x, y, z = normals[:, 0], normals[:, 1], normals[:, 2]
    sh = np.empty((normals.shape[0], 9), np.float64)
    sh[:, 0] = _A[0] * (1 / np.sqrt(4 * np.pi)) * np.ones_like(x)
    c1 = np.sqrt(3 / (4 * np.pi))
    sh[:, 1] = _A[1] * c1 * y
    sh[:, 2] = _A[1] * c1 * z
    sh[:, 3] = _A[1] * c1 * x
    c2 = np.sqrt(15 / (4 * np.pi))
    c3 = np.sqrt(5 / (16 * np.pi))
    c4 = np.sqrt(15 / (16 * np.pi))
    sh[:, 4] = _A[2] * c2 * y * x
    sh[:, 5] = _A[2] * c2 * y * z
    sh[:, 6] = _A[2] * c3 * (3 * z ** 2 - 1)
    sh[:, 7] = _A[2] * c2 * x * z
    sh[:, 8] = _A[2] * c4 * (x ** 2 - y ** 2)
    return sh


def sh_shading(normals: np.ndarray, sh_coeffs: np.ndarray) -> np.ndarray:
    """Shading for unit normals under 9-coeff lighting."""
    return sh_basis(normals) @ np.asarray(sh_coeffs).reshape(9)
