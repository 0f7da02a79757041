"""SMPL body model (linear blend skinning) and Rotation2xyz, on torch tensors.

Port of `diffusestylegesture_tpu/models/smpl.py` (the reference's MDM-legacy
joint-position pipeline, `main/model/smpl.py`, `main/model/rotation2xyz.py`,
both wrapping `smplx` and the body-model files):

  * `SmplModel`: the SMPL arrays, from an npz export of the official
    `SMPL_NEUTRAL.pkl` (`smpl_pkl_to_npz` converts the pickle, which needs
    chumpy; it imports chumpy when called and raises a clear ImportError
    without it), on one device;
  * `lbs`: shape blendshapes -> pose blendshapes -> the kinematic chain's
    rigid transforms -> skinning, smplx's `lbs()` math;
  * `SmplJoints`: the reference's `SMPL` wrapper (smpl.py:67-96): 24 LBS
    joints + 21 selected vertices + the 9 extra-regressor joints, with the
    vibe / a2m / smpl / a2mpl maps;
  * `Rotation2xyz`: rotation features (rotvec / rotmat / rotquat / rot6d via
    `utils/rotations.py`) -> joints, with global orientation, root centring
    and translation (`rotation2xyz.py:11-92`).

The vertex-selector indices and joint maps are the public constants of smplx
and `main/model/smpl.py:13-62`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..utils import rotations as rot

# smplx VertexJointSelector constants (vertex ids on the SMPL mesh):
# face (nose, r/l eye, r/l ear), feet (big/small toe + heel ×2), and
# finger tips (thumb..pinky ×2) — appended after the 24 LBS joints.
_FACE_FEET_VERTS = [332, 6260, 2800, 4071, 583,
                    3216, 3226, 3387, 6617, 6624, 6787]
_TIP_VERTS = [2746, 2319, 2445, 2556, 2673,
              6191, 5782, 5905, 6016, 6133]
EXTRA_JOINT_VERTS = _FACE_FEET_VERTS + _TIP_VERTS

SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
                12, 13, 14, 16, 17, 18, 19, 20, 21]

# main/model/smpl.py:11-62
action2motion_joints = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14,
                        21, 24, 38]
JOINTSTYPE_ROOT = {"a2m": 0, "smpl": 0, "a2mpl": 0, "vibe": 8}
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17, "OP RElbow": 19,
    "OP RWrist": 21, "OP LShoulder": 16, "OP LElbow": 18, "OP LWrist": 20,
    "OP MidHip": 0, "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7, "OP REye": 25,
    "OP LEye": 26, "OP REar": 27, "OP LEar": 28, "OP LBigToe": 29,
    "OP LSmallToe": 30, "OP LHeel": 31, "OP RBigToe": 32,
    "OP RSmallToe": 33, "OP RHeel": 34, "Right Ankle": 8, "Right Knee": 5,
    "Right Hip": 45, "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48, "Pelvis (MPII)": 49,
    "Thorax (MPII)": 50, "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26, "Right Eye": 25,
    "Left Ear": 28, "Right Ear": 27,
}
JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye",
    "Right Eye", "Left Ear", "Right Ear",
]


@dataclasses.dataclass
class SmplModel:
    """SMPL arrays (the neutral model: V 6890, J 24, 10 betas), float32 tensors."""

    v_template: torch.Tensor       # (V, 3)
    shapedirs: torch.Tensor        # (V, 3, num_betas)
    posedirs: torch.Tensor         # ((J-1)*9, V*3), smplx layout
    j_regressor: torch.Tensor      # (J, V)
    lbs_weights: torch.Tensor      # (V, J)
    parents: tuple = tuple(SMPL_PARENTS)
    j_regressor_extra: Optional[torch.Tensor] = None  # (E, V)

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @classmethod
    def from_arrays(cls, device: Union[str, torch.device] = "cuda", **arrays) -> "SmplModel":
        """From numpy arrays named as in the npz (v_template, shapedirs,
        posedirs, J_regressor, weights, kintree_parents[, J_regressor_extra])."""
        from ..device import resolve_device

        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        extra = arrays.get("J_regressor_extra")
        return cls(v_template=t(arrays["v_template"]), shapedirs=t(arrays["shapedirs"]),
                   posedirs=t(arrays["posedirs"]), j_regressor=t(arrays["J_regressor"]),
                   lbs_weights=t(arrays["weights"]),
                   parents=tuple(int(p) for p in arrays["kintree_parents"]),
                   j_regressor_extra=None if extra is None else t(extra))

    @classmethod
    def from_npz(cls, path: str, device: Union[str, torch.device] = "cuda") -> "SmplModel":
        with np.load(path, allow_pickle=False) as data:
            return cls.from_arrays(device, **{k: data[k] for k in data.files})


def smpl_pkl_to_npz(pkl_path: str, npz_path: str,
                    j_regressor_extra_path: Optional[str] = None) -> None:
    """Offline converter: the official SMPL pkl (+ SPIN's extra regressor npy)
    -> the npz `SmplModel.from_npz` loads. The pickle holds chumpy arrays."""
    try:
        import chumpy  # noqa: F401  (the pickle's arrays are chumpy objects)
    except ImportError as e:
        raise ImportError("smpl_pkl_to_npz needs the `chumpy` package to read the official "
                          "SMPL pickle; convert it where chumpy is installed and copy the "
                          "npz") from e
    import pickle

    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def arr(x):
        return np.asarray(x, dtype=np.float64)

    posedirs = arr(data["posedirs"])  # (V, 3, 207)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # smplx layout
    out = {
        "v_template": arr(data["v_template"]),
        "shapedirs": arr(data["shapedirs"])[..., :10],
        "posedirs": posedirs,
        "J_regressor": (data["J_regressor"].toarray() if hasattr(data["J_regressor"], "toarray")
                        else arr(data["J_regressor"])),
        "weights": arr(data["weights"]),
        "kintree_parents": np.asarray(data["kintree_table"][0]).astype(np.int64),
    }
    out["kintree_parents"][0] = -1
    if j_regressor_extra_path is not None:
        out["J_regressor_extra"] = np.load(j_regressor_extra_path)
    np.savez(npz_path, **out)


def batch_rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) (smplx `batch_rodrigues`)."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    rx, ry, rz = axis.unbind(-1)
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(rot_vecs.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1 - cos) * (K @ K)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents):
    """(B, J, 3, 3) local rotations + (B, J, 3) rest joints -> the posed joints
    and each joint's 4 x 4 transform relative to its rest position (smplx
    `batch_rigid_transform`)."""
    parent_idx = [max(p, 0) for p in parents]
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent_idx[1:]]], dim=1)
    B = rot_mats.shape[0]
    bottom = rot_mats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, rot_mats.shape[1], 1, 4)
    local = torch.cat([torch.cat([rot_mats, rel[..., None]], dim=-1), bottom], dim=-2)
    transforms = [local[:, 0]]
    for j in range(1, joints.shape[1]):
        transforms.append(transforms[parents[j]] @ local[:, j])
    transforms = torch.stack(transforms, dim=1)  # (B, J, 4, 4)
    posed_joints = transforms[..., :3, 3]
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    correction = (transforms @ joints_h[..., None])[..., 0]
    rel_transforms = transforms - torch.cat(
        [torch.zeros_like(transforms[..., :3]), correction[..., None]], dim=-1)
    return posed_joints, rel_transforms


def lbs(model: SmplModel, betas: torch.Tensor, pose_rotmats: torch.Tensor):
    """betas (B, num_betas) + per-joint rotations (B, J, 3, 3) -> (vertices
    (B, V, 3), joints (B, J, 3)): smplx `lbs()` with pose2rot=False, returning
    the kinematic joints, as smplx does."""
    b = betas.shape[0]
    v_shaped = model.v_template[None] + torch.einsum("bl,vcl->bvc", betas, model.shapedirs)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    eye = torch.eye(3, dtype=pose_rotmats.dtype, device=pose_rotmats.device)
    pose_feature = (pose_rotmats[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(b, -1, 3)
    posed_joints, rel_transforms = batch_rigid_transform(pose_rotmats, j_rest, model.parents)
    vert_transforms = torch.einsum("vj,bjxy->bvxy", model.lbs_weights, rel_transforms)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = (vert_transforms @ v_h[..., None])[..., :3, 0]
    return verts, posed_joints


def vertices2joints(regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    return torch.einsum("jv,bvc->bjc", regressor, vertices)


class SmplJoints:
    """The reference's SMPL wrapper (smpl.py:67-96): LBS, then the 21
    selected-vertex joints and the 9 extra-regressor joints, and the vibe /
    a2m / smpl / a2mpl maps."""

    def __init__(self, model: SmplModel):
        self.model = model
        vibe = np.array([JOINT_MAP[n] for n in JOINT_NAMES])
        a2m = vibe[action2motion_joints]
        smpl_idx = np.arange(24)
        self.maps = {"vibe": vibe, "a2m": a2m, "smpl": smpl_idx,
                     "a2mpl": np.unique(np.r_[smpl_idx, a2m])}

    def __call__(self, body_pose: torch.Tensor, global_orient: torch.Tensor,
                 betas: torch.Tensor) -> dict:
        """body_pose (B, 23, 3, 3), global_orient (B, 3, 3) or (B, 1, 3, 3),
        betas (B, num_betas)."""
        if global_orient.dim() == 3:
            global_orient = global_orient[:, None]
        verts, joints24 = lbs(self.model, betas, torch.cat([global_orient, body_pose], dim=1))
        all_joints = torch.cat([joints24, verts[:, EXTRA_JOINT_VERTS]], dim=1)  # 45
        if self.model.j_regressor_extra is not None:
            all_joints = torch.cat(
                [all_joints, vertices2joints(self.model.j_regressor_extra, verts)], dim=1)
        out = {"vertices": verts}
        n = all_joints.shape[1]
        for name, indexes in self.maps.items():
            if indexes.max() >= n:
                raise ValueError(
                    f"joint map {name!r} needs {indexes.max() + 1} joints but only {n} are "
                    "available (is j_regressor_extra the 9-row SPIN regressor?)")
            out[name] = all_joints[:, torch.as_tensor(indexes, device=all_joints.device)]
        return out


JOINTSTYPES = ["a2m", "a2mpl", "smpl", "vibe", "vertices"]


class Rotation2xyz:
    """rotation2xyz.py:11-92: rotation features -> joint positions."""

    def __init__(self, smpl_joints: SmplJoints):
        self.smpl = smpl_joints

    def __call__(self, x: torch.Tensor, mask: Optional[torch.Tensor], pose_rep: str,
                 translation: bool, glob: bool, jointstype: str, vertstrans: bool,
                 betas: Optional[torch.Tensor] = None, beta: float = 0.0,
                 glob_rot=None) -> torch.Tensor:
        """x (B, J[, +1 translation], F, T) -> (B, J_out, 3, T). As in the JAX
        package, `mask` zeroes the masked frames of the output (every frame
        is computed)."""
        if pose_rep == "xyz":
            return x
        if jointstype not in JOINTSTYPES:
            raise NotImplementedError("This jointstype is not implemented.")
        if not glob and glob_rot is None:
            raise TypeError("You must specify global rotation if glob is False")
        if translation:
            x_translations = x[:, -1, :3]  # (B, 3, T)
            x_rotations = x[:, :-1]
        else:
            x_rotations = x
        x_rotations = x_rotations.permute(0, 3, 1, 2)  # (B, T, J, F)
        nsamples, time, njoints, feats = x_rotations.shape
        flat = x_rotations.reshape(-1, njoints, feats)
        if pose_rep == "rotvec":
            rotations = rot.axis_angle_to_matrix(flat)
        elif pose_rep == "rotmat":
            rotations = flat.reshape(-1, njoints, 3, 3)
        elif pose_rep == "rotquat":
            rotations = rot.quaternion_to_matrix(flat)
        elif pose_rep == "rot6d":
            rotations = rot.rotation_6d_to_matrix(flat)
        else:
            raise NotImplementedError("No geometry for this one.")
        if not glob:
            glob_rot_mat = rot.axis_angle_to_matrix(torch.as_tensor(
                np.asarray(glob_rot, np.float32), device=x.device))
            global_orient = glob_rot_mat.expand(rotations.shape[0], 3, 3)
        else:
            global_orient = rotations[:, 0]
            rotations = rotations[:, 1:]
        if betas is None:
            betas = torch.zeros(rotations.shape[0], self.smpl.model.num_betas, dtype=x.dtype,
                                device=x.device)
            betas[:, 1] = beta
        joints = self.smpl(body_pose=rotations, global_orient=global_orient,
                           betas=betas)[jointstype]
        x_xyz = joints.reshape(nsamples, time, -1, 3).permute(0, 2, 3, 1)  # (B, J_out, 3, T)
        if mask is not None:
            # where, not multiply: padded rot6d frames can give NaN joints
            x_xyz = torch.where(mask[:, None, None, :], x_xyz, torch.zeros_like(x_xyz))
        if jointstype != "vertices":
            root_idx = JOINTSTYPE_ROOT[jointstype]
            x_xyz = x_xyz - x_xyz[:, root_idx: root_idx + 1]
        if translation and vertstrans:
            x_translations = x_translations - x_translations[:, :, :1]
            x_xyz = x_xyz + x_translations[:, None]
        return x_xyz
