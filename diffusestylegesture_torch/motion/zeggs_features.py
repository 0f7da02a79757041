"""ZEGGS 1141-d pose vector → BVH re-synthesis, in numpy.

Port of the export half of `diffusestylegesture_tpu/motion/zeggs_features.py`
(reference `main/process/process_zeggs_bvh.py::pose2bvh:219-275`,
`utils_zeggs.py:47-87`): optional Savitzky–Golay (15, 2) smoothing,
6D → quaternion re-orthogonalization, 20 → 60 fps frame repetition, root
re-application, BVH write. Layout of a frame: [root_pos(3) | root_rot(4) |
root_vel(3) | root_vrt(3) | lpos(3J) | ltxy(6J) | lvel(3J) | lvrt(3J) |
gaze_dir(3)], J = 75. Featurization comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

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
