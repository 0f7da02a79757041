"""Style vectors (port of `diffusestylegesture_tpu/sample/styles.py`):
one-hots scaled for intensity, the ZeroEGGS-style additive blend and a
styles × intensities batch."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..motion.zeggs_features import STYLE_NAMES


def style_vector(name: str, intensity: float = 1.0) -> np.ndarray:
    """One-hot × intensity (the reference scales one-hots for intensity)."""
    v = np.zeros(len(STYLE_NAMES), np.float32)
    v[STYLE_NAMES.index(name)] = intensity
    return v


def blend_styles(names: Sequence[str], weights: Sequence[float]) -> np.ndarray:
    """Additive style blending (ZeroEGGS 'add' blend)."""
    v = np.zeros(len(STYLE_NAMES), np.float32)
    for n, w in zip(names, weights):
        v[STYLE_NAMES.index(n)] += w
    return v


def style_grid(names: Sequence[str] = tuple(STYLE_NAMES),
               intensities: Sequence[float] = (1.0,)) -> np.ndarray:
    """(len(names)·len(intensities), 6) batch of style vectors."""
    return np.stack([style_vector(n, s) for n in names for s in intensities])
