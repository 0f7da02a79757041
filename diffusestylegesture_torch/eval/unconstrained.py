"""KID and improved precision/recall, in numpy on the host.

The port's own copy of `diffusestylegesture_tpu/eval/unconstrained.py`
(reference `main/eval/unconstrained/metrics/{kid,precision_recall}.py`), with
the `euclidean_distance_matrix` helper of its `eval/t2m.py`:

  * `kid`: the unbiased polynomial-kernel MMD² averaged over random subsets
    (k(x, y) = (γ⟨x, y⟩ + c)³, γ = 1/dim);
  * `precision_and_recall`: a point is covered when it lies inside the k-NN
    ball (k = 3, itself included) of some point of the other set.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """dist[i, j] = ||matrix1[i] − matrix2[j]||₂ for (N1, D) × (N2, D)."""
    if matrix1.shape[1] != matrix2.shape[1]:
        raise ValueError(f"feature dims differ: {matrix1.shape[1]} vs {matrix2.shape[1]}")
    d1 = -2 * matrix1 @ matrix2.T
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def _polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                       gamma: Optional[float] = None, coef0: float = 1.0) -> np.ndarray:
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def _sqn(arr: np.ndarray) -> float:
    flat = np.ravel(arr)
    return float(flat @ flat)


def polynomial_mmd(codes_g: np.ndarray, codes_r: np.ndarray, degree: int = 3,
                   gamma: Optional[float] = None, coef0: float = 1.0,
                   var_at_m: Optional[int] = None, ret_var: bool = True):
    """Unbiased MMD² (and its variance) under the polynomial kernel: the
    reference's `_mmd2_and_variance` (kid.py:44-126)."""
    if codes_g.shape[0] != codes_r.shape[0]:
        raise ValueError("the unbiased MMD estimator needs sets of equal size")
    k_xx = _polynomial_kernel(codes_g, codes_g, degree, gamma, coef0)
    k_yy = _polynomial_kernel(codes_r, codes_r, degree, gamma, coef0)
    k_xy = _polynomial_kernel(codes_g, codes_r, degree, gamma, coef0)

    m = k_xx.shape[0]
    if var_at_m is None:
        var_at_m = m

    diag_x = np.diagonal(k_xx)
    diag_y = np.diagonal(k_yy)
    sum_diag2_x = _sqn(diag_x)
    sum_diag2_y = _sqn(diag_y)

    kt_xx_sums = k_xx.sum(axis=1) - diag_x
    kt_yy_sums = k_yy.sum(axis=1) - diag_y
    k_xy_sums_0 = k_xy.sum(axis=0)
    k_xy_sums_1 = k_xy.sum(axis=1)

    kt_xx_sum = kt_xx_sums.sum()
    kt_yy_sum = kt_yy_sums.sum()
    k_xy_sum = k_xy_sums_0.sum()

    mmd2 = (kt_xx_sum + kt_yy_sum) / (m * (m - 1)) - 2 * k_xy_sum / (m * m)
    if not ret_var:
        return mmd2

    kt_xx_2_sum = _sqn(k_xx) - sum_diag2_x
    kt_yy_2_sum = _sqn(k_yy) - sum_diag2_y
    k_xy_2_sum = _sqn(k_xy)
    dot_xx_xy = kt_xx_sums @ k_xy_sums_1
    dot_yy_yx = kt_yy_sums @ k_xy_sums_0

    m1 = m - 1
    m2 = m - 2
    zeta1 = (
        1 / (m * m1 * m2) * (_sqn(kt_xx_sums) - kt_xx_2_sum + _sqn(kt_yy_sums) - kt_yy_2_sum)
        - 1 / (m * m1) ** 2 * (kt_xx_sum ** 2 + kt_yy_sum ** 2)
        + 1 / (m * m * m1) * (_sqn(k_xy_sums_1) + _sqn(k_xy_sums_0) - 2 * k_xy_2_sum)
        - 2 / m ** 4 * k_xy_sum ** 2
        - 2 / (m * m * m1) * (dot_xx_xy + dot_yy_yx)
        + 2 / (m ** 3 * m1) * (kt_xx_sum + kt_yy_sum) * k_xy_sum
    )
    zeta2 = (
        1 / (m * m1) * (kt_xx_2_sum + kt_yy_2_sum)
        - 1 / (m * m1) ** 2 * (kt_xx_sum ** 2 + kt_yy_sum ** 2)
        + 2 / (m * m) * k_xy_2_sum
        - 2 / m ** 4 * k_xy_sum ** 2
        - 4 / (m * m * m1) * (dot_xx_xy + dot_yy_yx)
        + 4 / (m ** 3 * m1) * (kt_xx_sum + kt_yy_sum) * k_xy_sum
    )
    var_est = (4 * (var_at_m - 2) / (var_at_m * (var_at_m - 1)) * zeta1
               + 2 / (var_at_m * (var_at_m - 1)) * zeta2)
    return mmd2, var_est


def kid(real_activations: np.ndarray, generated_activations: np.ndarray,
        n_subsets: int = 100, subset_size: int = 1000, seed: int = 0):
    """(mean, std) of the subsets' MMD²: the reference's `calculate_kid` with a
    seeded generator instead of numpy's global state."""
    rng = np.random.default_rng(seed)
    m = min(generated_activations.shape[0], real_activations.shape[0])
    replace = subset_size < len(generated_activations)
    size = min(subset_size, len(generated_activations), len(real_activations))
    mmds = np.zeros(n_subsets)
    for i in range(n_subsets):
        g = generated_activations[rng.choice(len(generated_activations), size, replace=replace)]
        r = real_activations[rng.choice(len(real_activations), size, replace=replace)]
        mmds[i] = polynomial_mmd(g, r, var_at_m=m, ret_var=False)
    return float(mmds.mean()), float(mmds.std())


def manifold_estimate(a_features: np.ndarray, b_features: np.ndarray, k: int = 3) -> float:
    """Fraction of B inside the k-NN ball of some A (A's own zero distance is in
    its neighbour list, as in the reference's loop)."""
    d_aa = euclidean_distance_matrix(a_features, a_features)
    radii = np.partition(d_aa, k, axis=1)[:, k]
    d_ba = euclidean_distance_matrix(b_features, a_features)
    covered = (d_ba <= radii[None, :]).any(axis=1)
    return float(covered.mean())


def precision_and_recall(generated_features: np.ndarray, real_features: np.ndarray,
                         k: int = 3):
    """Improved precision/recall (Kynkäänniemi et al.) as the reference wires
    it: precision = generated covered by the real manifold, recall = real
    covered by the generated manifold."""
    n = min(len(generated_features), len(real_features))
    if n <= k:
        raise ValueError(f"precision/recall needs > {k} samples per feature set "
                         f"(k-NN manifold radius), got {n}")
    g = np.asarray(generated_features[:n], dtype=np.float64)
    r = np.asarray(real_features[:n], dtype=np.float64)
    return manifold_estimate(r, g, k), manifold_estimate(g, r, k)
