"""Text-to-motion retrieval metrics (R-precision / matching score).

Port of `diffusestylegesture_tpu/eval/t2m.py` (reference
`main/data_loaders/humanml/utils/metrics.py:6-57`), numpy:

  * `euclidean_distance_matrix` (`eval/unconstrained.py`'s, shared);
  * `top_k_hits`: the cumulative "ground-truth index within the first k
    nearest neighbours" matrix (`calculate_top_k:22-34`);
  * `r_precision` (`calculate_R_precision:37-44`) and `matching_score`
    (`calculate_matching_score:47-57`).

FID / diversity / multimodality live in `eval/metrics.py`.
"""
from __future__ import annotations

import numpy as np

from .unconstrained import euclidean_distance_matrix

__all__ = ["euclidean_distance_matrix", "top_k_hits", "r_precision", "matching_score"]


def top_k_hits(argsorted: np.ndarray, top_k: int) -> np.ndarray:
    """(N, N) argsort of a distance matrix -> (N, top_k) bool: column k is
    true iff the row's own index appears among its first k + 1 neighbours
    (the reference's cumulative-OR loop)."""
    n = argsorted.shape[0]
    hits = argsorted[:, :top_k] == np.arange(n)[:, None]
    return np.cumsum(hits, axis=1).astype(bool)


def r_precision(embedding1: np.ndarray, embedding2: np.ndarray, top_k: int,
                sum_all: bool = False) -> np.ndarray:
    """R-precision of embedding2 retrieved by embedding1 (row i matches row
    i): the (N, top_k) hit matrix, or its column sums with `sum_all`."""
    dist = euclidean_distance_matrix(embedding1, embedding2)
    hits = top_k_hits(np.argsort(dist, axis=1), top_k)
    return hits.sum(axis=0) if sum_all else hits


def matching_score(embedding1: np.ndarray, embedding2: np.ndarray, sum_all: bool = False):
    """L2 between paired rows of two equal-shape embedding sets."""
    assert embedding1.ndim == 2 and embedding1.shape == embedding2.shape
    dist = np.linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist
