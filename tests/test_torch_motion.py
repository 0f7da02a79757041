"""BVH export of the PyTorch port (numpy) vs the JAX package's.

A seeded, smoothly moving 1141-d pose array goes through both
`pose_features_to_bvh`; both files are parsed with the JAX package's
`motion/bvh.load` and positions and Euler rotations agree at atol 1e-4
(the JAX path computes in float32; the files print six decimals).
"""
import numpy as np
import pytest

from diffusestylegesture_tpu.motion import bvh as jax_bvh
from diffusestylegesture_tpu.motion import quat as jax_quat
from diffusestylegesture_tpu.motion import txform as jax_txform
from diffusestylegesture_tpu.motion import zeggs_features as jax_zf
from diffusestylegesture_torch.motion import quat, txform
from diffusestylegesture_torch.motion import zeggs_features as zf

J = zf.ZEGGS_NJOINTS


def _smooth_rotations(T, rng):
    """(T, J, 4) unit quaternions from slowly varying axis-angles, away from
    gimbal lock, so the 6D → Euler chain stays well conditioned."""
    axis = rng.standard_normal((J, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    phase = rng.random(J) * 2 * np.pi
    t = np.arange(T)[:, None]
    angle = 0.6 * np.sin(0.05 * t + phase)  # radians, |angle| ≤ 0.6
    return np.concatenate([np.cos(angle / 2)[..., None],
                           np.sin(angle / 2)[..., None] * axis], axis=-1).astype(np.float32)


def _poses(T=40, seed=0):
    rng = np.random.default_rng(seed)
    q = _smooth_rotations(T, rng)
    R = np.asarray(jax_quat.to_xform(q))  # (T, J, 3, 3)
    ltxy = np.stack([R[..., :, 0], R[..., :, 1]], axis=-2)  # rotated x and y axes
    poses = np.zeros((T, zf.ZEGGS_FEATURE_DIM), np.float32)
    poses[:, 0:3] = np.cumsum(rng.standard_normal((T, 3)) * 0.5, axis=0)
    poses[:, 3:7] = _smooth_rotations(T, rng)[:, 0]
    poses[:, 13: 13 + 3 * J] = (rng.standard_normal((1, 3 * J)) * 10
                                + 0.1 * rng.standard_normal((T, 3 * J)))
    poses[:, 13 + 3 * J: 13 + 9 * J] = (ltxy + 0.01 * rng.standard_normal(ltxy.shape)).reshape(T, -1)
    return poses


@pytest.mark.parametrize("smoothing", [True, False])
def test_pose_features_to_bvh_matches_jax(tmp_path, smoothing):
    poses = _poses()
    zf.pose_features_to_bvh(poses, str(tmp_path / "port.bvh"), smoothing=smoothing)
    jax_zf.pose_features_to_bvh(poses, str(tmp_path / "jax.bvh"), smoothing=smoothing)
    a, b = jax_bvh.load(str(tmp_path / "port.bvh")), jax_bvh.load(str(tmp_path / "jax.bvh"))
    assert a["names"] == b["names"] and a["order"] == b["order"] == "zyx"
    np.testing.assert_array_equal(a["parents"], b["parents"])
    assert a["rotations"].shape == (3 * len(poses), J, 3)
    np.testing.assert_allclose(a["positions"], b["positions"], atol=1e-4)
    np.testing.assert_allclose(a["rotations"], b["rotations"], atol=1e-4)
    assert a["frametime"] == b["frametime"]


def test_quat_and_txform_match_jax():
    rng = np.random.default_rng(1)
    q = _smooth_rotations(8, rng)
    r = _smooth_rotations(8, rng)
    v = rng.standard_normal((8, J, 3)).astype(np.float32)
    np.testing.assert_allclose(quat.mul(q, r), np.asarray(jax_quat.mul(q, r)), atol=1e-6)
    np.testing.assert_allclose(quat.mul_vec(q, v), np.asarray(jax_quat.mul_vec(q, v)), atol=1e-5)
    np.testing.assert_allclose(quat.to_euler(q), np.asarray(jax_quat.to_euler(q)), atol=1e-5)
    xy = rng.standard_normal((8, J, 2, 3)).astype(np.float32)
    m = txform.orthogonalize_from_xy(xy)
    np.testing.assert_allclose(m, np.asarray(jax_txform.orthogonalize_from_xy(xy)), atol=1e-5)
    np.testing.assert_allclose(quat.from_xform(m), np.asarray(jax_quat.from_xform(m)), atol=1e-5)


def test_style_onehot_matches_jax():
    for tok in zf.STYLE_NAMES + ["Unknown"]:
        a, b = zf.style_onehot(tok), jax_zf.style_onehot(tok)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
