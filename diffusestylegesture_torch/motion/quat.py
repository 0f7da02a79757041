"""Quaternion algebra and forward kinematics.

Port of the subset of `diffusestylegesture_tpu/motion/quat.py` (reference
`ubisoft-laforge-ZeroEGGS-main/ZEGGS/anim/quat.py`) that BVH import,
featurization and export and the ZeroEGGS decoder call: (w, x, y, z) order,
Hamilton product, the same Euler orders, the same `from_xform` branch
selection and the same frame-unrolling sign convention
(`anim/quat.py:130-136`). Arrays keep their dtype (the featurizer passes
float32, as the JAX path computes). `mul`, `mul_vec`, `inv`, `exp` and
`from_helical` also take torch tensors (the ZeroEGGS rollout runs them on
the card, with autograd in training).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _cat(parts, like):
    return torch.cat(parts, dim=-1) if torch.is_tensor(like) else np.concatenate(parts, axis=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1) if torch.is_tensor(a) else np.cross(a, b)


def mul(x, y):
    """Hamilton product x ⊗ y (`anim/quat.py:17`)."""
    w0, x0, y0, z0 = (x[..., i:i + 1] for i in range(4))
    w1, x1, y1, z1 = (y[..., i:i + 1] for i in range(4))
    return _cat([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ], x)


def mul_vec(q, v):
    """Rotate vector(s) v by quaternion(s) q (`anim/quat.py:36`)."""
    t = 2.0 * _cross(q[..., 1:], v)
    return v + q[..., :1] * t + _cross(q[..., 1:], t)


def to_euler(q: np.ndarray, order: str = "zyx") -> np.ndarray:
    w, x, y, z = (q[..., i:i + 1] for i in range(4))
    if order == "zyx":
        return np.concatenate([
            np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)),
            np.arcsin(np.clip(2.0 * (w * y - z * x), -1.0, 1.0)),
            np.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y)),
        ], axis=-1)
    if order == "xzy":
        return np.concatenate([
            np.arctan2(2.0 * (x * w - y * z), -x * x + y * y - z * z + w * w),
            np.arctan2(2.0 * (y * w - x * z), x * x - y * y - z * z + w * w),
            np.arcsin(np.clip(2.0 * (x * y + z * w), -1.0, 1.0)),
        ], axis=-1)
    raise NotImplementedError(f"unsupported euler order {order!r}")


def from_xform(ts: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """3x3 rotation matrix → quaternion, Shepperd branch selection as in the
    reference (`anim/quat.py:166-206`) so signs agree."""
    t = ts[..., 0, 0] + ts[..., 1, 1] + ts[..., 2, 2]

    s_w = 0.5 / np.sqrt(np.maximum(t + 1.0, eps))
    q_w = np.stack([0.25 / s_w,
                    s_w * (ts[..., 2, 1] - ts[..., 1, 2]),
                    s_w * (ts[..., 0, 2] - ts[..., 2, 0]),
                    s_w * (ts[..., 1, 0] - ts[..., 0, 1])], axis=-1)

    s_x = 2.0 * np.sqrt(np.maximum(1.0 + ts[..., 0, 0] - ts[..., 1, 1] - ts[..., 2, 2], eps))
    q_x = np.stack([(ts[..., 2, 1] - ts[..., 1, 2]) / s_x,
                    s_x * 0.25,
                    (ts[..., 0, 1] + ts[..., 1, 0]) / s_x,
                    (ts[..., 0, 2] + ts[..., 2, 0]) / s_x], axis=-1)

    s_y = 2.0 * np.sqrt(np.maximum(1.0 + ts[..., 1, 1] - ts[..., 0, 0] - ts[..., 2, 2], eps))
    q_y = np.stack([(ts[..., 0, 2] - ts[..., 2, 0]) / s_y,
                    (ts[..., 0, 1] + ts[..., 1, 0]) / s_y,
                    s_y * 0.25,
                    (ts[..., 1, 2] + ts[..., 2, 1]) / s_y], axis=-1)

    s_z = 2.0 * np.sqrt(np.maximum(1.0 + ts[..., 2, 2] - ts[..., 0, 0] - ts[..., 1, 1], eps))
    q_z = np.stack([(ts[..., 1, 0] - ts[..., 0, 1]) / s_z,
                    (ts[..., 0, 2] + ts[..., 2, 0]) / s_z,
                    (ts[..., 1, 2] + ts[..., 2, 1]) / s_z,
                    s_z * 0.25], axis=-1)

    c0 = (ts[..., 0, 0] > ts[..., 1, 1]) & (ts[..., 0, 0] > ts[..., 2, 2])
    c1 = (~c0) & (ts[..., 1, 1] > ts[..., 2, 2])
    qs = np.where(c1[..., None], q_y, q_z)
    qs = np.where(c0[..., None], q_x, qs)
    return np.where((t > 0.0)[..., None], q_w, qs)


def inv(q):
    """Conjugate (the inverse of a unit quaternion)."""
    if torch.is_tensor(q):
        return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return q * np.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def abs_(q: np.ndarray) -> np.ndarray:
    """Canonicalize to the w >= 0 hemisphere."""
    return np.where(q[..., :1] > 0.0, q, -q)


def normalize(q: np.ndarray, eps: float = 0.0) -> np.ndarray:
    return q / (np.sqrt(np.sum(q * q, axis=-1, keepdims=True)) + eps)


def log(q: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Quaternion log map → R^3 (half-angle scaled axis)."""
    length = np.sqrt(np.sum(np.square(q[..., 1:]), axis=-1, keepdims=True))
    with np.errstate(divide="ignore", invalid="ignore"):
        halfangle = np.where(length < eps, np.ones_like(length),
                             np.arctan2(length, q[..., :1]) / length)
    return halfangle * q[..., 1:]


def to_helical(q: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    return 2.0 * log(q, eps)


def exp(v, eps: float = 1e-5):
    """Quaternion exp map from R^3 (`anim/quat.py`); sinc is numpy's, sin(πx)/(πx)."""
    if torch.is_tensor(v):
        halfangle = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        small = halfangle < eps
        c = torch.where(small, torch.ones_like(halfangle), torch.cos(halfangle))
        s = torch.where(small, torch.ones_like(halfangle), torch.sinc(halfangle / np.pi))
        return torch.cat([c, s * v], dim=-1)
    halfangle = np.sqrt(np.sum(np.square(v), axis=-1, keepdims=True))
    c = np.where(halfangle < eps, np.ones_like(halfangle), np.cos(halfangle))
    s = np.where(halfangle < eps, np.ones_like(halfangle), np.sinc(halfangle / np.pi))
    return np.concatenate([c, s * v], axis=-1)


def from_helical(v, eps: float = 1e-5):
    """Helical (rotation-vector) form → quaternion: exp(v / 2)."""
    return exp(v / 2.0, eps)


def from_angle_axis(angle: np.ndarray, axis: np.ndarray) -> np.ndarray:
    c = np.cos(angle / 2.0)[..., None]
    s = np.sin(angle / 2.0)[..., None]
    return np.concatenate([c, s * axis], axis=-1)


def from_euler(e: np.ndarray, order: str = "zyx") -> np.ndarray:
    axes = {"x": np.array([1.0, 0.0, 0.0], dtype=e.dtype),
            "y": np.array([0.0, 1.0, 0.0], dtype=e.dtype),
            "z": np.array([0.0, 0.0, 1.0], dtype=e.dtype)}
    q0 = from_angle_axis(e[..., 0], axes[order[0]])
    q1 = from_angle_axis(e[..., 1], axes[order[1]])
    q2 = from_angle_axis(e[..., 2], axes[order[2]])
    return mul(q0, mul(q1, q2))


def between(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Quaternion rotating direction x onto y (unnormalized)."""
    w = (np.sqrt(np.sum(x * x, axis=-1) * np.sum(y * y, axis=-1))
         + np.sum(x * y, axis=-1))[..., None]
    return np.concatenate([w, np.cross(x, y)], axis=-1)


def unroll(q: np.ndarray) -> np.ndarray:
    """Sign continuity along the leading (time) axis: the sign applied at frame
    i is the running product of sign(dot(q_i, q_{i-1})), as the reference's
    frame loop (`anim/quat.py:130-136`) and the JAX cumprod give it."""
    d = np.sum(q[1:] * q[:-1], axis=-1)
    flips = np.where(d < 0.0, -1.0, 1.0).astype(q.dtype)
    signs = np.concatenate([np.ones_like(flips[:1]), np.cumprod(flips, axis=0)], axis=0)
    return q * signs[..., None]


def _levels(parents: Sequence[int]) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """Joints grouped by tree depth: ((joint ids, parent ids), ...) per level."""
    depth = [0] * len(parents)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    out = []
    for lvl in range(1, max(depth) + 1 if len(parents) else 1):
        ids = [i for i in range(1, len(parents)) if depth[i] == lvl]
        if ids:
            out.append((np.array(ids), np.array([parents[i] for i in ids])))
    return tuple(out)


def fk(lrot: np.ndarray, lpos: np.ndarray, parents: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Forward kinematics, local → global rotations and positions, one
    vectorized step per skeleton level (`anim/quat.py:209-215`).
    lrot (..., J, 4), lpos (..., J, 3)."""
    parents = [int(p) for p in parents]
    gr, gp = np.array(lrot), np.array(lpos)
    for ids, pids in _levels(parents):
        pr = gr[..., pids, :]
        gr[..., ids, :] = mul(pr, lrot[..., ids, :])
        gp[..., ids, :] = mul_vec(pr, lpos[..., ids, :]) + gp[..., pids, :]
    return gr, gp
