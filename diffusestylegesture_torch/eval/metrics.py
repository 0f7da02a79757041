"""Gesture evaluation metrics, in numpy on the host.

The port's own copy of `diffusestylegesture_tpu/eval/metrics.py` (reference
`main/data_loaders/humanml/utils/metrics.py:37-95`):

  * `frechet_distance`: FID/FGD between the Gaussians fit to two feature sets;
  * `diversity`: mean distance between random pairs of samples;
  * `multimodality`: the same within each condition;
  * `beat_alignment`: audio onsets against the motion's kinematic beats.
"""
from __future__ import annotations

import numpy as np
from scipy import linalg


def sqrtm(a: np.ndarray) -> np.ndarray:
    """Matrix square root without scipy's deprecated `disp` plumbing."""
    try:
        out = linalg.sqrtm(a)
    except TypeError:  # pragma: no cover - older scipy returns tuples only
        out = linalg.sqrtm(a, disp=False)[0]
    return out[0] if isinstance(out, tuple) else out


def activation_statistics(feats: np.ndarray):
    return np.mean(feats, axis=0), np.cov(feats, rowvar=False)


def frechet_distance(feats1: np.ndarray, feats2: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between Gaussians fit to two feature sets. Raises above
    8192 dimensions (two covariances of that size and an O(n³) sqrtm): embed
    the windows first (`cli/eval.py --embedding autoencoder`)."""
    if feats1.shape[1] > 8192:
        raise ValueError(
            f"feature dim {feats1.shape[1]} too large for covariance-based "
            "FGD; embed first (cli.eval --embedding autoencoder)")
    mu1, sigma1 = activation_statistics(feats1)
    mu2, sigma2 = activation_statistics(feats2)
    diff = mu1 - mu2
    covmean = sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        # the reference's guard (`main/eval/a2m/action2motion/fid.py:53-57`): a
        # non-trivial imaginary diagonal means the covariances are too
        # ill-conditioned to trust, and taking .real would report a wrong FGD
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                "FGD covariance sqrtm has imaginary component "
                f"{np.max(np.abs(covmean.imag)):.2e} (ill-conditioned "
                "covariances — too few windows?)")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def diversity(feats: np.ndarray, diversity_times: int = 300, seed: int = 0) -> float:
    """Mean pairwise L2 over random index pairs (ref `calculate_diversity`,
    `metrics.py:78-79`); each index set is drawn without replacement, capped at
    n (with replacement, first[i] == second[i] would bias it low)."""
    n = feats.shape[0]
    times = min(diversity_times, n)
    rng = np.random.default_rng(seed)
    first = rng.choice(n, times, replace=False)
    second = rng.choice(n, times, replace=False)
    return float(np.linalg.norm(feats[first] - feats[second], axis=1).mean())


def multimodality(feats_per_cond: np.ndarray, times: int = 20, seed: int = 0) -> float:
    """feats_per_cond: (n_cond, n_samples, D). Ref `calculate_multimodality`
    (`metrics.py:89-90`), index sets drawn without replacement."""
    _, n, _ = feats_per_cond.shape
    times = min(times, n)
    rng = np.random.default_rng(seed)
    first = rng.choice(n, times, replace=False)
    second = rng.choice(n, times, replace=False)
    d = np.linalg.norm(feats_per_cond[:, first] - feats_per_cond[:, second], axis=2)
    return float(d.mean())


def beat_alignment(motion: np.ndarray, onset_times: np.ndarray, fps: float,
                   sigma: float = 0.1) -> float:
    """Mean Gaussian score of the kinematic beat nearest each audio onset;
    motion (T, D), onsets in seconds. Kinematic beats are the local minima of
    the frame-to-frame speed (direction changes)."""
    if len(onset_times) == 0 or len(motion) < 3:
        return float("nan")
    vel = np.linalg.norm(np.diff(motion, axis=0), axis=1)
    beats = [i for i in range(1, len(vel) - 1) if vel[i] < vel[i - 1] and vel[i] <= vel[i + 1]]
    if not beats:
        return float("nan")
    beat_times = np.array(beats) / fps
    scores = [np.exp(-((np.min(np.abs(beat_times - t))) ** 2) / (2 * sigma ** 2))
              for t in onset_times]
    return float(np.mean(scores))
