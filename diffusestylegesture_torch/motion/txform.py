"""Two-axis (6D) rotation representation, in numpy.

Port of `diffusestylegesture_tpu/motion/txform.py::orthogonalize_from_xy`
(reference `anim/txform.py:23-40`).
"""
from __future__ import annotations

import numpy as np


def _normalize(v: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + eps)


def orthogonalize_from_xy(xy: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """(..., 2, 3) rotated x and approximate y axes → (..., 3, 3) rotation
    matrix with the re-orthogonalized axes as columns."""
    x = xy[..., 0, :]
    y = xy[..., 1, :]
    z = np.cross(x, y)
    x = _normalize(x, eps)
    z = _normalize(z, eps)
    y = _normalize(np.cross(z, x), eps)
    return np.stack([x, y, z], axis=-1)
