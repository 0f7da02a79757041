"""The number that decides `correct`: how far the program's output lies from
the plain reference's."""
from __future__ import annotations

import math

import numpy as np


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got − want| over RMS(want): the widest error of any pose channel of
    any frame, relative to the output's scale. Infinite where the shapes
    differ or `got` holds a non-finite value."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    rms = float(np.sqrt(np.mean(want ** 2)))
    return float(np.max(np.abs(got - want))) / max(rms, 1e-30)
