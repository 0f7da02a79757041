"""Style vectors (port of `diffusestylegesture_tpu/sample/styles.py`):
the ZeroEGGS-style additive blend."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..motion.zeggs_features import STYLE_NAMES


def blend_styles(names: Sequence[str], weights: Sequence[float]) -> np.ndarray:
    """Additive style blending (ZeroEGGS 'add' blend)."""
    v = np.zeros(len(STYLE_NAMES), np.float32)
    for n, w in zip(names, weights):
        v[STYLE_NAMES.index(n)] += w
    return v
