"""HumanML3D / KIT "RIC" motion representation math, on torch tensors.

Port of `diffusestylegesture_tpu/motion/humanml.py` (the reference's
MDM-legacy humanml kit):

  * quaternion helpers in the humanml **w-first** convention
    (`main/data_loaders/humanml/common/quaternion.py`: `qinv`, `qrot`, `qmul`,
    `qbetween`, `quaternion_to_cont6d:314`; that cont6d takes matrix
    *columns*, unlike `utils/rotations.py`'s pytorch3d rows);
  * `recover_root_rot_pos` / `recover_from_ric` / `recover_rot`
    (`motion_process.py:362-430`), the per-frame integrations as cumsums;
  * `Skeleton` forward / inverse kinematics over explicit kinematic chains
    (`common/skeleton.py`).

Tensors keep their dtype; the skeleton's offsets take the dtype of the
tensors they meet. The constant tables reproduce `utils/paramUtil.py:4-55`.
"""
from __future__ import annotations

import numpy as np
import torch

# --- dataset skeleton constants (paramUtil.py) -------------------------------

t2m_raw_offsets = np.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
     [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
     [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
     [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0]],
    dtype=np.float64,
)
t2m_kinematic_chain = [
    [0, 2, 5, 8, 11], [0, 1, 4, 7, 10], [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21], [9, 13, 16, 18, 20],
]
kit_raw_offsets = np.array(
    [[0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
     [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
     [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
     [0, -1, 0], [0, 0, 1], [0, 0, 1]],
    dtype=np.float64,
)
kit_kinematic_chain = [
    [0, 11, 12, 13, 14, 15], [0, 16, 17, 18, 19, 20], [0, 1, 2, 3, 4],
    [3, 5, 6, 7], [3, 8, 9, 10],
]

# --- RIC channel masks for inpainting-style editing (humanml_utils.py) ---------

HML_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
]
NUM_HML_JOINTS = len(HML_JOINT_NAMES)
HML_LOWER_BODY_JOINTS = [
    HML_JOINT_NAMES.index(n)
    for n in ("pelvis", "left_hip", "right_hip", "left_knee", "right_knee",
              "left_ankle", "right_ankle", "left_foot", "right_foot")
]
SMPL_UPPER_BODY_JOINTS = [i for i in range(NUM_HML_JOINTS) if i not in HML_LOWER_BODY_JOINTS]


def _hml_channel_mask(joint_binary: np.ndarray, foot_contact: bool) -> np.ndarray:
    """A per-joint flag in the 263-channel RIC layout: root (1+2+1) + ric
    (J-1)*3 + rot (J-1)*6 + vel J*3 + contacts 4."""
    return np.concatenate([
        [True] * (1 + 2 + 1),
        np.repeat(joint_binary[1:], 3),
        np.repeat(joint_binary[1:], 6),
        np.repeat(joint_binary, 3),
        [foot_contact] * 4,
    ])


HML_ROOT_BINARY = np.array([True] + [False] * (NUM_HML_JOINTS - 1))
HML_ROOT_MASK = _hml_channel_mask(HML_ROOT_BINARY, foot_contact=False)
HML_LOWER_BODY_JOINTS_BINARY = np.array([i in HML_LOWER_BODY_JOINTS for i in range(NUM_HML_JOINTS)])
HML_LOWER_BODY_MASK = _hml_channel_mask(HML_LOWER_BODY_JOINTS_BINARY, foot_contact=True)
HML_UPPER_BODY_MASK = ~HML_LOWER_BODY_MASK

# --- w-first quaternion helpers ----------------------------------------------


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (w, x, y, z)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the unit quaternion q; broadcasts over leading dims."""
    shape = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    q = q[..., :4].expand(shape + (4,))
    v = v.expand(shape + (3,))
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating u onto v (neither need be normalised)."""
    w = torch.sqrt((u ** 2).sum(-1) * (v ** 2).sum(-1)) + (u * v).sum(-1)
    q = torch.cat([w[..., None], _cross(u, v)], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """The first two matrix *columns* (humanml convention, quaternion.py:314)."""
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def cont6d_to_matrix(cont6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt from two columns (quaternion.py:321-340)."""
    x_raw, y_raw = cont6d[..., 0:3], cont6d[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    z = _cross(x, y_raw)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)


# --- RIC feature recovery -----------------------------------------------------


def recover_root_rot_pos(data: torch.Tensor):
    """(..., T, D) RIC features -> root yaw quaternion (..., T, 4) and root
    position (..., T, 3); the reference's per-frame integration
    (motion_process.py:362-381) as two cumsums."""
    rot_vel = data[..., 0]
    shifted = torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1)
    r_rot_ang = torch.cumsum(shifted, dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)
    lin = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_pos = torch.stack([lin[..., 0], torch.zeros_like(lin[..., 0]), lin[..., 1]], dim=-1)
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """RIC features -> global joint positions (..., T, J, 3)
    (motion_process.py:415-430)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    positions = qrot(qinv(r_rot_quat)[..., None, :], positions)
    positions = positions + torch.stack(
        [r_pos[..., 0], torch.zeros_like(r_pos[..., 0]), r_pos[..., 2]], dim=-1)[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def recover_rot(data: torch.Tensor) -> torch.Tensor:
    """RIC features -> per-joint cont6d with the root position padded as a
    pseudo-joint (motion_process.py:400-413); HumanML (263-d, 22 joints) or
    KIT (251-d, 21 joints) from the channel count."""
    joints_num = 22 if data.shape[-1] == 263 else 21
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    r_pos_pad = torch.cat([r_pos, torch.zeros_like(r_pos)], dim=-1)[..., None, :]
    start = 1 + 2 + 1 + (joints_num - 1) * 3
    cont6d = torch.cat([quaternion_to_cont6d(r_rot_quat),
                        data[..., start:start + (joints_num - 1) * 6]], dim=-1)
    cont6d = cont6d.reshape((-1, joints_num, 6))
    return torch.cat([cont6d, r_pos_pad.reshape((-1, 1, 6))], dim=-2)


def recover_from_rot(data: torch.Tensor, joints_num: int, skeleton: "Skeleton") -> torch.Tensor:
    """RIC rotation block -> joints by FK (motion_process.py:384-398)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    start = 1 + 2 + 1 + (joints_num - 1) * 3
    cont6d = torch.cat([quaternion_to_cont6d(r_rot_quat),
                        data[..., start:start + (joints_num - 1) * 6]], dim=-1)
    cont6d = cont6d.reshape((-1, joints_num, 6))
    return skeleton.forward_kinematics_cont6d(cont6d, r_pos.reshape((-1, 3)))


# --- Skeleton -----------------------------------------------------------------


class Skeleton:
    """Chain-based FK / IK over a fixed kinematic tree (skeleton.py:4-186)."""

    def __init__(self, raw_offsets: np.ndarray, kinematic_tree):
        self._raw_offset = np.asarray(raw_offsets, dtype=np.float64)
        self._tree = [list(c) for c in kinematic_tree]
        self._offset = None
        parents = [0] * len(self._raw_offset)
        parents[0] = -1
        for chain in self._tree:
            for j in range(1, len(chain)):
                parents[chain[j]] = chain[j - 1]
        self._parents = parents

    @property
    def parents(self):
        return list(self._parents)

    def njoints(self) -> int:
        return len(self._raw_offset)

    def _raw(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self._raw_offset, dtype=like.dtype, device=like.device)

    def set_offset(self, offsets) -> None:
        self._offset = torch.as_tensor(offsets)

    def get_offsets_joints(self, joints: torch.Tensor) -> torch.Tensor:
        """Unit raw offsets scaled by the bone lengths of a reference pose (J, 3)."""
        parent_idx = [max(p, 0) for p in self._parents]
        lengths = torch.linalg.norm(joints - joints[parent_idx], dim=-1)
        lengths = torch.cat([lengths.new_ones(1), lengths[1:]])
        raw = self._raw(joints)
        offsets = raw * lengths[:, None]
        self._offset = torch.cat([raw[:1], offsets[1:]])
        return self._offset

    def inverse_kinematics(self, joints: torch.Tensor, face_joint_idx,
                           smooth_forward: bool = False) -> torch.Tensor:
        """Global positions (T, J, 3) -> local quaternions (T, J, 4)
        (skeleton.py:54-102)."""
        l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
        across = across / torch.linalg.norm(across, dim=-1, keepdim=True)
        forward = _cross(joints.new_tensor([[0.0, 1.0, 0.0]]), across)
        if smooth_forward:
            from scipy.ndimage import gaussian_filter1d

            forward = torch.as_tensor(
                gaussian_filter1d(forward.cpu().numpy(), 20, axis=0, mode="nearest"),
                device=joints.device)
        forward = forward / torch.linalg.norm(forward, dim=-1, keepdim=True)
        target = forward.new_tensor([0.0, 0.0, 1.0]).expand(forward.shape)
        root_quat = qbetween(forward, target)
        root_quat = torch.cat([root_quat.new_tensor([[1.0, 0.0, 0.0, 0.0]]), root_quat[1:]])

        quat_params = [None] * joints.shape[1]
        quat_params[0] = root_quat
        raw = self._raw(joints)
        for chain in self._tree:
            rot = root_quat
            for j in range(len(chain) - 1):
                u = raw[chain[j + 1]].expand(len(joints), 3)
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
                local = qmul(qinv(rot), qbetween(u, v))
                quat_params[chain[j + 1]] = local
                rot = qmul(rot, local)
        zero = joints.new_zeros(len(joints), 4)
        return torch.stack([zero if q is None else q for q in quat_params], dim=1)

    def _offsets_for(self, batch: int, like: torch.Tensor, skel_joints=None) -> torch.Tensor:
        if skel_joints is not None:
            if skel_joints.dim() == 3:
                parent_idx = [max(p, 0) for p in self._parents]
                lengths = torch.linalg.norm(skel_joints - skel_joints[:, parent_idx], dim=-1)
                lengths = torch.cat([torch.ones_like(lengths[:, :1]), lengths[:, 1:]], dim=1)
                raw = self._raw(skel_joints)
                offsets = raw[None] * lengths[..., None]
                self._offset = torch.cat([raw[None, :1].expand(len(offsets), 1, 3),
                                          offsets[:, 1:]], dim=1)
            else:
                self.get_offsets_joints(skel_joints)
        if self._offset is None:
            raise ValueError("set_offset/get_offsets_joints must run first")
        off = self._offset.to(dtype=like.dtype, device=like.device)
        if off.dim() == 2:
            off = off.expand((batch,) + off.shape)
        return off

    def forward_kinematics(self, quat_params: torch.Tensor, root_pos: torch.Tensor,
                           skel_joints=None, do_root_R: bool = True) -> torch.Tensor:
        """Local quaternions (B, J, 4) + root position (B, 3) -> joints (B, J, 3)."""
        B, J = quat_params.shape[:2]
        offsets = self._offsets_for(B, quat_params, skel_joints)
        joints = [None] * J
        joints[0] = root_pos.to(quat_params.dtype)
        for chain in self._tree:
            if do_root_R:
                rot = quat_params[:, 0]
            else:
                rot = quat_params.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
            for i in range(1, len(chain)):
                rot = qmul(rot, quat_params[:, chain[i]])
                joints[chain[i]] = qrot(rot, offsets[:, chain[i]]) + joints[chain[i - 1]]
        zero = quat_params.new_zeros(B, 3)
        return torch.stack([zero if j is None else j for j in joints], dim=1)

    def forward_kinematics_cont6d(self, cont6d_params: torch.Tensor, root_pos: torch.Tensor,
                                  skel_joints=None, do_root_R: bool = True) -> torch.Tensor:
        """cont6d (B, J, 6) + root position (B, 3) -> joints (B, J, 3)."""
        B, J = cont6d_params.shape[:2]
        offsets = self._offsets_for(B, cont6d_params, skel_joints)
        joints = [None] * J
        joints[0] = root_pos.to(cont6d_params.dtype)
        for chain in self._tree:
            if do_root_R:
                mat = cont6d_to_matrix(cont6d_params[:, 0])
            else:
                mat = torch.eye(3, dtype=cont6d_params.dtype,
                                device=cont6d_params.device).expand(B, 3, 3)
            for i in range(1, len(chain)):
                mat = mat @ cont6d_to_matrix(cont6d_params[:, chain[i]])
                step = (mat @ offsets[:, chain[i]][..., None])[..., 0]
                joints[chain[i]] = step + joints[chain[i - 1]]
        zero = cont6d_params.new_zeros(B, 3)
        return torch.stack([zero if j is None else j for j in joints], dim=1)
