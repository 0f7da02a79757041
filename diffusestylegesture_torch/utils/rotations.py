"""Rotation-representation conversions (pytorch3d convention), on torch tensors.

Port of `diffusestylegesture_tpu/utils/rotations.py` (the reference's
vendored pytorch3d `main/utils/rotation_conversions.py`, used by the MDM-legacy
SMPL path): (w, x, y, z) quaternions, matrix <-> quaternion / axis-angle /
euler, and Zhou et al.'s continuous 6D representation (6D = the first two
matrix ROWS, Gram-Schmidt; `rotation_conversions.py:513`). Unlike
`motion/humanml.py::quaternion_to_cont6d`, which takes matrix columns.
"""
from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    r, i, j, k = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """pytorch3d's branchless variant: the case with the largest denominator."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1), min=0.0))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m[..., 2, 1] - m[..., 1, 2],
                     m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], q_abs[..., 1] ** 2,
                     m[..., 1, 0] + m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] + m[..., 0, 1],
                     q_abs[..., 2] ** 2, m[..., 2, 1] + m[..., 1, 2]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 2, 0] + m[..., 0, 2],
                     m[..., 2, 1] + m[..., 1, 2], q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1 * 1e-2))
    best = torch.argmax(q_abs, dim=-1)
    out = torch.gather(candidates, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def axis_angle_to_quaternion(axis_angle: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = angles.abs() < eps
    sin_half_over = torch.where(small, 0.5 - angles * angles / 48.0,
                                torch.sin(half) / torch.where(small, torch.ones_like(angles),
                                                              angles))
    return torch.cat([torch.cos(half), axis_angle * sin_half_over], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    small = angles.abs() < eps
    sin_half_over = torch.where(small, 0.5 - angles * angles / 48.0,
                                torch.sin(half_angles) / torch.where(
                                    small, torch.ones_like(angles), angles))
    return quaternions[..., 1:] / sin_half_over


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) two-row 6D -> (..., 3, 3) (ref `rotation_conversions.py:513`)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Intrinsic rotations applied in `convention` order (pytorch3d)."""

    def axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
        cos, sin = torch.cos(angle), torch.sin(angle)
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        if axis == "X":
            flat = [one, zero, zero, zero, cos, -sin, zero, sin, cos]
        elif axis == "Y":
            flat = [cos, zero, sin, zero, one, zero, -sin, zero, cos]
        else:
            flat = [cos, -sin, zero, sin, cos, zero, zero, zero, one]
        return torch.stack(flat, -1).reshape(angle.shape + (3, 3))

    mats = [axis_rot(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]
