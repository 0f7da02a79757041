"""BEAT alternate BVH↔h5 processing (`beat_data_proc` in the reference).

Port of `diffusestylegesture_tpu/data/beat_proc.py`, which ports
`BEAT-TWH-main/process/beat_data_proc/{MyBVH.py,utils_io.py}` — an auxiliary
loader the BEAT tooling uses to move mocap between BVH files
and per-clip HDF5 bundles:

  * `load_bvh_data` — BVH -> dict of joint_names/parents/offsets/
    per-joint euler orders/euler angles/rotation matrices/root
    translation (MyBVH.py:33-173), built on this package's
    `motion.pipeline.parse_bvh`.
    Deviation: the reference's private pymo parser truncates motion to
    `line_count - 431` rows (parsers.py:240 — 431 is the BEAT skeleton
    header size, a guard against clips whose `Frames:` header overstates
    the real row count). Our parser reads the rows actually present, so
    no magic constant is needed;
  * `euler2mat` — per-joint intrinsic euler -> rotation matrices
    (MyBVH.py:17-30), vectorized by grouping joints with equal orders
    into one batched scipy call;
  * `select_joints` — joint-subset extraction that re-roots offsets
    through unselected ancestors via accumulated bind-pose transforms
    (MyBVH.py:112-150);
  * `write_bvh_data` — dict -> BVH file (MyBVH.py:175-263);
  * `load_h5_dataset` / `save_h5_dataset` — nested-dict HDF5 IO with
    gzip+fletcher32 and string-list encoding (utils_io.py:15-90); they need
    h5py, imported inside them, so the module imports without it.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial.transform import Rotation

from ..motion import pipeline as P
from .h5_loader import require_h5py


def euler2mat(angles: np.ndarray, euler_orders: Sequence[str]) -> np.ndarray:
    """(T, J, 3) degrees + per-joint order strings -> (T, J, 3, 3).
    Intrinsic rotations (upper-case scipy convention), like the
    reference."""
    if angles.ndim != 3 or angles.shape[2] != 3 or angles.shape[1] != len(euler_orders):
        raise ValueError(f"angles {angles.shape} do not match {len(euler_orders)} joint orders")
    t, j = angles.shape[:2]
    out = np.zeros((t, j, 3, 3), dtype=np.float32)
    orders = np.asarray([o.upper() for o in euler_orders])
    for order in np.unique(orders):
        idx = np.nonzero(orders == order)[0]
        block = angles[:, idx].reshape(-1, 3)
        mats = Rotation.from_euler(str(order), block, degrees=True).as_matrix()
        out[:, idx] = mats.reshape(t, len(idx), 3, 3)
    return out


def load_bvh_data(fn: str, keep_end_site: bool = False) -> dict:
    """BVH file -> the MyBVH info dict (MyBVH.py:152-173)."""
    data = P.parse_bvh(fn)
    joint_names = [n for n in data.names
                   if keep_end_site or not n.endswith("_Nub")]
    name_to_idx = {n: i for i, n in enumerate(joint_names)}
    parents = np.asarray(
        [name_to_idx.get(data.parents.get(n) or "", -1) if data.parents.get(n)
         else -1 for n in joint_names], dtype=np.int32)
    offsets = np.stack([np.asarray(data.offsets[n], dtype=np.float64)
                        for n in joint_names])

    col = data.column_index()
    t = data.values.shape[0]
    eulers = np.zeros((t, len(joint_names), 3))
    euler_orders: List[str] = []
    for i, name in enumerate(joint_names):
        order = ""
        for ch in data.channels.get(name, []):
            if ch.endswith("rotation"):
                eulers[:, i, len(order)] = data.values[:, col[f"{name}_{ch}"]]
                order += ch[0]
        if not order:
            order = "XYZ"
        if len(order) != 3:
            raise ValueError(f"{fn}: joint {name} has rotation channels {order!r}")
        euler_orders.append(order)
    rot_mats = euler2mat(eulers, euler_orders)

    global_pos = np.zeros((t, 3))
    for axis, ax_name in enumerate("XYZ"):
        key = f"{data.root_name}_{ax_name}position"
        if key in col:
            global_pos[:, axis] = data.values[:, col[key]]

    return {
        "joint_names": joint_names,
        "offsets": offsets,
        "parents": parents,
        "euler_orders": euler_orders,
        "framerate": float(np.round(1 / data.framerate)),
        "rot_angles": eulers,
        "rot_mats": rot_mats,
        "global_pos": global_pos,
    }


def _trans_mat(trans: np.ndarray) -> np.ndarray:
    mat = np.tile(np.eye(4), (*trans.shape[:-1], 1, 1))
    mat[..., :3, 3] = trans
    return mat


def select_joints(selected_joint_names: Sequence[str],
                  joint_names: Sequence[str], *, parents: Sequence[int],
                  offsets: Optional[np.ndarray] = None,
                  motion: Optional[np.ndarray] = None):
    """Subset a skeleton, folding unselected ancestors' offsets into the
    kept joints (MyBVH.py:112-150). Returns (parents', offsets',
    motion')."""
    names = list(joint_names)
    selected_idx = [names.index(n) for n in selected_joint_names]
    if offsets is None:
        offsets = np.zeros((len(names), 3))
    global_mat = np.tile(np.eye(4), (len(names), 1, 1))
    for j, parent in enumerate(list(parents)[1:], 1):
        global_mat[j] = global_mat[parent] @ _trans_mat(offsets[j])

    new_parents = np.zeros(len(selected_idx), dtype=np.int32)
    new_offsets = np.zeros((len(selected_idx), 3))
    for new_idx, joint in enumerate(selected_idx):
        parent = parents[joint]
        while True:
            if parent == -1:
                new_parents[new_idx] = -1
                new_offsets[new_idx] = global_mat[joint][:3, 3]
                break
            if parent in selected_idx:
                new_parents[new_idx] = selected_idx.index(parent)
                rel = np.linalg.inv(global_mat[parent]) @ global_mat[joint]
                new_offsets[new_idx] = rel[:3, 3]
                break
            parent = parents[parent]
    new_motion = None if motion is None else motion[:, selected_idx]
    return new_parents, new_offsets, new_motion


def write_bvh_data(bvh_fn: str, *, joint_names: Sequence[str],
                   skeleton_tree: Sequence[int], offsets: np.ndarray,
                   euler_orders: Sequence[str], framerate: float,
                   motion: np.ndarray,
                   global_trans: Optional[np.ndarray] = None,
                   with_endsite: bool = False) -> None:
    """Info dict -> BVH on disk (MyBVH.py:175-263). `motion` is euler
    angles (T, J, 3) in degrees; `framerate` is fps."""
    names = [str(n) for n in joint_names]
    parents_arr = list(skeleton_tree)
    has_children = set(parents_arr)

    full_names: List[str] = []
    parents: Dict[str, Optional[str]] = {}
    off: Dict[str, np.ndarray] = {}
    channels: Dict[str, List[str]] = {}
    root_name = None
    for i, name in enumerate(names):
        full_names.append(name)
        p = parents_arr[i]
        parents[name] = None if p == -1 else names[p]
        if p == -1:
            root_name = name
        off[name] = np.asarray(offsets[i], dtype=np.float64)
        is_endsite_joint = with_endsite and i not in has_children
        if is_endsite_joint:
            channels[name] = []
            continue
        rot = [f"{euler_orders[i][k]}rotation" for k in range(3)]
        channels[name] = (
            ["Xposition", "Yposition", "Zposition"] + rot if p == -1 else rot)
        if not with_endsite and i not in has_children:
            nub = f"{name}_Nub"
            full_names.append(nub)
            parents[nub] = name
            off[nub] = np.zeros(3)
            channels[nub] = []
    if root_name is None:
        raise ValueError("no root joint (parent == -1) in skeleton_tree")

    frame_count = motion.shape[0]
    if global_trans is None:
        global_trans = np.zeros((frame_count, 3))
    if with_endsite:
        keep = np.asarray([not n.endswith("Nub") for n in names])
        motion = motion[:, keep]
    values = np.concatenate(
        [global_trans, motion.reshape(frame_count, -1)], axis=1)
    columns = [f"{j}_{c}" for j in full_names for c in channels.get(j, [])]
    data = P.ChannelData(
        full_names, parents, off, channels, columns, values,
        1.0 / framerate, root_name)
    P.write_bvh_channels(data, bvh_fn)


# --- HDF5 IO (utils_io.py) -----------------------------------------------------


def load_h5_dataset(filename: str, *, ds_name_list=None, parser=None) -> dict:
    h5py = require_h5py()

    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)

    def load_dict(d):
        out = {}
        for item in d.keys():
            if ds_name_list is not None and item not in ds_name_list:
                continue
            if isinstance(d[item], h5py.Dataset):
                out[item] = d[item][()]
                if parser is not None and item in parser:
                    out[item] = parser[item](out[item])
            elif isinstance(d[item], h5py.Group):
                out[item] = load_dict(d[item])
        return out

    with h5py.File(filename, "r") as f:
        return load_dict(f)


def save_h5_dataset(filename: str, ds_dict: dict, *, overwrite: bool = True) -> None:
    h5py = require_h5py()

    parent = os.path.dirname(filename)
    if parent:
        os.makedirs(parent, exist_ok=True)
    if os.path.exists(filename):
        if not overwrite:
            raise FileExistsError(filename)
        os.remove(filename)

    def save_data(f, d):
        for key, value in d.items():
            if isinstance(value, dict):
                save_data(f.create_group(key), value)
                continue
            if (isinstance(value, (list, tuple)) and value
                    and isinstance(value[0], str)):
                value = [s.encode("ascii", "ignore") for s in value]
            arr = np.asarray(value)
            if arr.dtype.kind in "iuf" and arr.ndim > 0:
                f.create_dataset(key, data=arr, chunks=True, fletcher32=True,
                                 compression="gzip", compression_opts=4)
            else:
                f.create_dataset(key, data=value)

    with h5py.File(filename, "w") as f:
        save_data(f, ds_dict)
