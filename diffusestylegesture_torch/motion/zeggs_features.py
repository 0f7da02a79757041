"""ZEGGS 1141-d pose featurization and BVH re-synthesis, in numpy.

Port of `diffusestylegesture_tpu/motion/zeggs_features.py` (reference
`main/process/process_zeggs_bvh.py`):

* `featurize_animation` (`preprocess_animation:95-216`): 60 → fps decimation,
  quaternion unroll, FK, the Spine2 ground-projected root, the Hips-forward
  root rotation, the head-lookat median gaze, root-relative localization and
  finite-difference velocities with the reference's frame-0 extrapolation
  v[0] = v[1] - (v[3] - v[2]). Computes in float32, as the JAX path.
* `pose_features_to_bvh` (`pose2bvh:219-275`, `utils_zeggs.py:47-87`):
  optional Savitzky–Golay (15, 2) smoothing, 6D → quaternion
  re-orthogonalization, 20 → 60 fps frame repetition, root re-application,
  BVH write.

Layout of a frame: [root_pos(3) | root_rot(4) | root_vel(3) | root_vrt(3) |
lpos(3J) | ltxy(6J) | lvel(3J) | lvrt(3J) | gaze_dir(3)], J = 75.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import bvh, quat, txform

ZEGGS_BONE_NAMES = [
    "Hips", "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Neck1", "Head",
    "HeadEnd", "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "RightHandThumb1", "RightHandThumb2", "RightHandThumb3", "RightHandThumb4",
    "RightHandIndex1", "RightHandIndex2", "RightHandIndex3", "RightHandIndex4",
    "RightHandMiddle1", "RightHandMiddle2", "RightHandMiddle3",
    "RightHandMiddle4", "RightHandRing1", "RightHandRing2", "RightHandRing3",
    "RightHandRing4", "RightHandPinky1", "RightHandPinky2", "RightHandPinky3",
    "RightHandPinky4", "RightForeArmEnd", "RightArmEnd", "LeftShoulder",
    "LeftArm", "LeftForeArm", "LeftHand", "LeftHandThumb1", "LeftHandThumb2",
    "LeftHandThumb3", "LeftHandThumb4", "LeftHandIndex1", "LeftHandIndex2",
    "LeftHandIndex3", "LeftHandIndex4", "LeftHandMiddle1", "LeftHandMiddle2",
    "LeftHandMiddle3", "LeftHandMiddle4", "LeftHandRing1", "LeftHandRing2",
    "LeftHandRing3", "LeftHandRing4", "LeftHandPinky1", "LeftHandPinky2",
    "LeftHandPinky3", "LeftHandPinky4", "LeftForeArmEnd", "LeftArmEnd",
    "RightUpLeg", "RightLeg", "RightFoot", "RightToeBase", "RightToeBaseEnd",
    "RightLegEnd", "RightUpLegEnd", "LeftUpLeg", "LeftLeg", "LeftFoot",
    "LeftToeBase", "LeftToeBaseEnd", "LeftLegEnd", "LeftUpLegEnd",
]

# ZEGGS skeleton topology (75 joints), as the reference's re-synthesis writes it
ZEGGS_PARENTS = np.array(
    [-1, 0, 1, 2, 3, 4, 5, 6, 7, 4, 9, 10, 11, 12, 13, 14, 15, 12, 17, 18, 19,
     12, 21, 22, 23, 12, 25, 26, 27, 12, 29, 30, 31, 12, 11, 4, 35, 36, 37, 38,
     39, 40, 41, 38, 43, 44, 45, 38, 47, 48, 49, 38, 51, 52, 53, 38, 55, 56,
     57, 38, 37, 0, 61, 62, 63, 64, 63, 62, 0, 68, 69, 70, 71, 70, 69],
    dtype=np.int32,
)

ZEGGS_NJOINTS = 75
ZEGGS_FEATURE_DIM = 13 + ZEGGS_NJOINTS * 15 + 3  # 1141

STYLE_NAMES = ["Happy", "Sad", "Neutral", "Old", "Angry", "Relaxed"]


def style_onehot(name_token: str) -> Optional[np.ndarray]:
    """Filename token → one-hot style (`sample.py:20-27`); None if unknown."""
    if name_token not in STYLE_NAMES:
        return None
    out = np.zeros(len(STYLE_NAMES), np.float32)
    out[STYLE_NAMES.index(name_token)] = 1.0
    return out


def _edge_extrapolate(v: np.ndarray) -> np.ndarray:
    """The reference's frame-0 velocity fill: v[0] = v[1] - (v[3] - v[2])."""
    if len(v) < 4:  # no 4-frame stencil: v[0] stays
        return v
    v[0] = v[1] - (v[3] - v[2])
    return v


def featurize_animation(anim: Dict, fps: int = 20) -> Dict:
    """BVH dict (`bvh.load`) → {'features': (T, 1141) float32, and the
    skeleton's parents, dt, order, njoints, offsets, names}."""
    rotations = anim["rotations"]
    positions = anim["positions"]
    nframes = len(rotations)
    src_fps = round(1.0 / anim["frametime"])
    if fps != src_fps:
        if src_fps % fps or src_fps < fps:
            # the reference decimates by an integer stride only (`:100-104`)
            raise ValueError(f"target fps {fps} must integer-divide source fps {src_fps}")
        rate = src_fps // fps
        rotations = rotations[0:nframes:rate]
        positions = positions[0:nframes:rate]
        dt = 1.0 / fps
    else:
        dt = anim["frametime"]
    nframes = positions.shape[0]
    names = anim["names"]
    parents = anim["parents"]
    njoints = len(parents)
    f32 = np.float32

    lrot = quat.unroll(quat.from_euler(np.radians(rotations), anim["order"]))
    lpos = positions.astype(f32).copy()
    grot, gpos = quat.fk(lrot, lpos, parents)

    root_pos = gpos[:, names.index("Spine2")] * np.array([1, 0, 1], f32)
    root_fwd = quat.mul_vec(grot[:, names.index("Hips")], np.array([[0.0, 0.0, 1.0]], f32))
    root_fwd[:, 1] = 0
    root_fwd = root_fwd / np.linalg.norm(root_fwd, axis=-1, keepdims=True)
    z = np.broadcast_to(np.array([0.0, 0.0, 1.0], f32), root_fwd.shape)
    root_rot = quat.normalize(quat.between(z, root_fwd))

    gaze_lookat = quat.mul_vec(grot[:, names.index("Head")], np.array([0.0, 0.0, 1.0], f32))
    gaze_lookat[:, 1] = 0
    gaze_lookat = gaze_lookat / np.linalg.norm(gaze_lookat, axis=-1, keepdims=True)
    gaze_pos = np.median(root_pos + 100.0 * gaze_lookat, axis=0)
    gaze_pos = np.broadcast_to(gaze_pos, (nframes, 3)).copy()
    gaze_dir = quat.mul_vec(quat.inv(root_rot), gaze_pos - root_pos)

    lrot[:, 0] = quat.mul(quat.inv(root_rot), lrot[:, 0])
    lpos[:, 0] = quat.mul_vec(quat.inv(root_rot), lpos[:, 0] - root_pos)

    lvel = np.zeros_like(lpos)
    lvel[1:] = (lpos[1:] - lpos[:-1]) / dt
    lvel = _edge_extrapolate(lvel)

    lvrt = np.zeros_like(lpos)
    lvrt[1:] = quat.to_helical(quat.abs_(quat.mul(lrot[1:], quat.inv(lrot[:-1])))) / dt
    lvrt = _edge_extrapolate(lvrt)

    root_vrt = np.zeros_like(root_pos)
    root_vrt[1:] = quat.to_helical(quat.abs_(quat.mul(root_rot[1:], quat.inv(root_rot[:-1])))) / dt
    root_vrt = _edge_extrapolate(root_vrt)
    root_vrt[1:] = quat.mul_vec(quat.inv(root_rot[:-1]), root_vrt[1:])
    root_vrt[0] = quat.mul_vec(quat.inv(root_rot[0]), root_vrt[0])

    root_vel = np.zeros_like(root_pos)
    root_vel[1:] = (root_pos[1:] - root_pos[:-1]) / dt
    root_vel = _edge_extrapolate(root_vel)
    root_vel[1:] = quat.mul_vec(quat.inv(root_rot[:-1]), root_vel[1:])
    root_vel[0] = quat.mul_vec(quat.inv(root_rot[0]), root_vel[0])

    ltxy = np.zeros((nframes, njoints, 2, 3), f32)
    ltxy[..., 0, :] = quat.mul_vec(lrot, np.array([1.0, 0.0, 0.0], f32))
    ltxy[..., 1, :] = quat.mul_vec(lrot, np.array([0.0, 1.0, 0.0], f32))

    features = np.concatenate([
        root_pos, root_rot, root_vel, root_vrt, lpos.reshape(nframes, -1),
        ltxy.reshape(nframes, -1), lvel.reshape(nframes, -1), lvrt.reshape(nframes, -1),
        gaze_dir], axis=1).astype(f32)
    return {"features": features, "parents": parents, "dt": dt, "order": anim["order"],
            "njoints": njoints, "offsets": anim["offsets"], "names": names}


def featurize_bvh_file(path: str, fps: int = 20) -> Dict:
    return featurize_animation(bvh.load(path), fps=fps)


def pose_features_to_bvh(poses: np.ndarray, outpath: str, *, smoothing: bool = True,
                         fps_up: int = 3, names=None, parents: Optional[np.ndarray] = None) -> None:
    """(T, 1141) features → .bvh file. Computes in float32, as the JAX path."""
    from scipy.signal import savgol_filter

    length = poses.shape[0]
    njoints = ZEGGS_NJOINTS
    parents = ZEGGS_PARENTS if parents is None else parents
    names = ZEGGS_BONE_NAMES if names is None else names

    if smoothing:
        poses = savgol_filter(poses, 15, 2, axis=0)
    poses = np.asarray(poses, np.float32)

    root_pos = poses[:, 0:3]
    root_rot = poses[:, 3:7]
    lpos = poses[:, 13: 13 + njoints * 3].reshape(length, njoints, 3)
    ltxy = poses[:, 13 + njoints * 3: 13 + njoints * 9].reshape(length, njoints, 2, 3)
    lrot = quat.from_xform(txform.orthogonalize_from_xy(ltxy)).astype(np.float32)

    # 20 → 60 fps frame repetition (ref `:262-267`)
    root_pos = root_pos.repeat(fps_up, axis=0)
    root_rot = root_rot.repeat(fps_up, axis=0)
    lpos = lpos.repeat(fps_up, axis=0)
    lrot = lrot.repeat(fps_up, axis=0)

    write_bvh(outpath, root_pos, root_rot, lpos, lrot, parents, names, "zyx",
              1.0 / (20 * fps_up))


def write_bvh(filename, root_pos, root_rot, lpos, lrot, parents, names, order, dt):
    """Re-apply the root transform and save (`utils_zeggs.py:47-87`)."""
    lpos = lpos.copy()
    lrot = lrot.copy()
    lpos[:, 0] = quat.mul_vec(root_rot, lpos[:, 0]) + root_pos
    lrot[:, 0] = quat.mul(root_rot, lrot[:, 0])
    bvh.save(filename, dict(
        order=order,
        offsets=lpos[0],
        names=list(names),
        frametime=dt,
        parents=parents,
        positions=lpos,
        rotations=np.degrees(quat.to_euler(lrot, order=order)),
    ))
