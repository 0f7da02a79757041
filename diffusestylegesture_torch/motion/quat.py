"""Quaternion algebra for BVH export, in numpy.

Port of the export subset of `diffusestylegesture_tpu/motion/quat.py`
(reference `ubisoft-laforge-ZeroEGGS-main/ZEGGS/anim/quat.py`): (w, x, y, z)
order, Hamilton product, the same Euler orders and the same `from_xform`
branch selection.
"""
from __future__ import annotations

import numpy as np


def mul(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Hamilton product x ⊗ y (`anim/quat.py:17`)."""
    w0, x0, y0, z0 = (x[..., i:i + 1] for i in range(4))
    w1, x1, y1, z1 = (y[..., i:i + 1] for i in range(4))
    return np.concatenate([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ], axis=-1)


def mul_vec(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) v by quaternion(s) q (`anim/quat.py:36`)."""
    t = 2.0 * np.cross(q[..., 1:], v)
    return v + q[..., :1] * t + np.cross(q[..., 1:], t)


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
