"""Channel-level motion pipeline (pymo-equivalent, pandas-free), host numpy.

Port of `diffusestylegesture_tpu/motion/pipeline.py`, which re-implements the
subset of the vendored pymo library (`BEAT-TWH-main/process/pymo/`,
`pymo_TWH/`) that the BEAT/TWH gesture paths use:

  * channel-accurate BVH parsing (per-joint channel lists, 'Nub' end
    sites) ↔ `pymo/parsers.py:53-76`, in Python only;
  * `JointSelector` (substring channel match, root prepend, dropped
    channels remembered for inverse) ↔ `pymo/preprocessing.py:328-384`;
  * `DownSampler` (rate = orig_fps // tgt, `values[0:-1:rate]` — the
    last-frame drop is reproduced) ↔ `pymo/preprocessing.py:843-873`;
  * `Numpyfier` (+ inverse to the stored column template)
    ↔ `pymo/preprocessing.py:386-425`;
  * `ConstantsRemover` variants ↔ `pymo_TWH/preprocessing.py:959-…`;
  * BVH writing ↔ `pymo/writers.py`.

On top sit the dataset featurizers:
  * `beat_features` ↔ `process_BEAT_bvh.process_bvh_bugfix:53-85`
    (120→30 fps, 74 joints + root, euler-XYZ → 9-d rotation matrices,
    684-d — including the reference quirk that the root-position triplet
    also passes through the euler→matrix conversion);
  * `beat_features_to_bvh` ↔ `pose2bvh_bugfix:108-131` (savgol 15/2,
    matrix→euler, pipeline inverse, BVH write);
  * `twh_features` ↔ `process_TWH_bvh.load_bvh:26-65` (62 bones,
    rotmat mode: per joint [3 pos | 9 rotmat] = 744-d);
  * `twh_features_to_bvh` ↔ `process_TWH_bvh.pose2bvh:201-227`.

The quaternion helpers of `RootTransformer` are numpy float64 copies of the
JAX module's (the port's `motion/quat.py` is torch).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
from scipy.spatial.transform import Rotation as R


@dataclasses.dataclass
class ChannelData:
    """Per-channel mocap values with full skeleton structure."""

    names: List[str]  # joint order as parsed (incl. '<name>_Nub' end sites)
    parents: Dict[str, Optional[str]]
    offsets: Dict[str, np.ndarray]
    channels: Dict[str, List[str]]  # joint → channel names (file order)
    columns: List[str]  # flattened '<joint>_<channel>' in file order
    values: np.ndarray  # (T, C)
    framerate: float
    root_name: str

    def clone(self) -> "ChannelData":
        return ChannelData(
            list(self.names), dict(self.parents), dict(self.offsets),
            {k: list(v) for k, v in self.channels.items()}, list(self.columns),
            self.values.copy(), self.framerate, self.root_name,
        )

    def column_index(self) -> Dict[str, int]:
        return {c: i for i, c in enumerate(self.columns)}


def parse_bvh_python(path: str) -> ChannelData:
    """Channel-preserving BVH parse (pymo `BVHParser.parse` semantics; End
    Sites become zero-channel '<parent>_Nub' joints). The JAX package's
    `parse_bvh` may dispatch to its C++ parser; the port has only this one."""
    names: List[str] = []
    parents: Dict[str, Optional[str]] = {}
    offsets: Dict[str, np.ndarray] = {}
    channels: Dict[str, List[str]] = {}
    columns: List[str] = []
    stack: List[str] = []
    root_name = None
    frametime = 1.0 / 60.0
    rows: List[np.ndarray] = []
    in_motion = False

    with open(path) as f:
        current = None
        end_site = False
        for line in f:
            if in_motion:
                vals = line.strip().split()
                if vals:
                    rows.append(np.array([float(v) for v in vals], np.float64))
                continue
            m = re.match(r"\s*(ROOT|JOINT)\s+(\S+)", line)
            if m:
                # inline-brace declarations ('ROOT Hips {' / 'JOINT X{'):
                # open the scope here so OFFSET/CHANNELS target THIS joint
                name = m.group(2).rstrip("{").strip() or m.group(2)
                parent = stack[-1] if stack else None
                names.append(name)
                parents[name] = parent
                channels[name] = []
                if root_name is None:
                    root_name = name
                current = name
                if "{" in line[m.end(1):]:
                    stack.append(name)
                continue
            if "End Site" in line:
                end_site = True
                nub = f"{current}_Nub"
                names.append(nub)
                parents[nub] = current
                channels[nub] = []
                if "{" in line:  # 'End Site {'
                    stack.append(nub)
                continue
            if "{" in line:
                if end_site:
                    stack.append(f"{current}_Nub")
                else:
                    stack.append(current)
                continue
            if "}" in line:
                popped = stack.pop()
                if popped.endswith("_Nub"):
                    end_site = False
                current = stack[-1] if stack else None
                continue
            m = re.match(r"\s*OFFSET\s+(\S+)\s+(\S+)\s+(\S+)", line)
            if m:
                offsets[stack[-1]] = np.array([float(g) for g in m.groups()], np.float32)
                continue
            m = re.match(r"\s*CHANNELS\s+(\d+)\s+(.*)", line)
            if m:
                chans = m.group(2).split()[: int(m.group(1))]
                channels[stack[-1]] = chans
                for c in chans:
                    columns.append(f"{stack[-1]}_{c}")
                continue
            m = re.match(r"\s*Frame Time:\s*([\d.eE+-]+)", line)
            if m:
                frametime = float(m.group(1))
                in_motion = True
                continue

    values = np.stack(rows) if rows else np.zeros((0, len(columns)))
    return ChannelData(
        names, parents, offsets, channels, columns, values, frametime, root_name
    )


parse_bvh = parse_bvh_python


def write_bvh_channels(data: ChannelData, path: str) -> None:
    """BVH writer for ChannelData (pymo `BVHWriter.write` layout)."""
    children: Dict[str, List[str]] = {}
    for n in data.names:
        p = data.parents.get(n)
        if p is not None:
            children.setdefault(p, []).append(n)

    lines: List[str] = ["HIERARCHY"]
    ordered_cols: List[str] = []  # hierarchy-traversal channel order

    def emit(name: str, depth: int, tag: str):
        t = "\t" * depth
        if name.endswith("_Nub"):
            off = data.offsets.get(name, np.zeros(3))
            lines.append(f"{t}End Site")
            lines.append(f"{t}{{")
            lines.append(f"{t}\tOFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
            lines.append(f"{t}}}")
            return
        off = data.offsets.get(name, np.zeros(3))
        lines.append(f"{t}{tag} {name}")
        lines.append(f"{t}{{")
        lines.append(f"{t}\tOFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        ch = data.channels.get(name, [])
        if ch:
            lines.append(f"{t}\tCHANNELS {len(ch)} " + " ".join(ch))
            ordered_cols.extend(f"{name}_{c}" for c in ch)
        for c in children.get(name, []):
            emit(c, depth + 1, "JOINT")
        lines.append(f"{t}}}")

    emit(data.root_name, 0, "ROOT")
    # values are looked up BY COLUMN NAME in hierarchy order (pymo
    # `BVHWriter` semantics, `writers.py:58-63`) — transforms whose
    # inverse appends restored columns at the end must still write a
    # correctly ordered motion block
    idx = data.column_index()
    missing = [c for c in ordered_cols if c not in idx]
    if missing:
        raise ValueError(f"columns missing for BVH write: {missing[:5]}")
    perm = [idx[c] for c in ordered_cols]
    vals = data.values[:, perm]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write("MOTION\n")
        f.write(f"Frames: {len(data.values)}\n")
        f.write(f"Frame Time: {data.framerate:.8f}\n")
        for row in vals:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


class JointSelector:
    """pymo `JointSelector` parity (`preprocessing.py:328-384`).

    `exact` selects the pymo_TWH matching rule
    (`pymo_TWH/preprocessing.py:345`: `joint + "_" + channel == column`)
    instead of BEAT-pymo's substring rule — TWH bone names collide
    (`b_l_arm` is a prefix of `b_l_arm_twist`), so substring matching
    would select every twist channel twice (816-d instead of 744-d).
    """

    def __init__(self, joints: Sequence[str], include_root: bool = False,
                 exact: bool = False):
        self.joints = list(joints)
        self.include_root = include_root
        self.exact = exact

    def fit(self, data: ChannelData) -> "JointSelector":
        selected_joints = ([data.root_name] if self.include_root else []) + self.joints
        # NB: when include_root=True and the root also appears in `joints`
        # (TWH: 'body_world' is bone_names[0]), pymo selects the root's
        # channels TWICE and its expmap mode then crashes on the duplicated
        # pandas columns (`pymo_TWH/preprocessing.py:195`). We keep the
        # selection order but de-duplicate — the only behavior that runs.
        seen = set()
        sj = []
        for j in selected_joints:
            if j not in seen:
                seen.add(j)
                sj.append(j)
        selected_joints = sj
        selected_channels: List[str] = []
        for j in selected_joints:
            if self.exact:
                selected_channels.extend(
                    [c for c in data.columns
                     if j + "_" + c.split("_")[-1] == c and "Nub" not in c]
                )
            else:
                selected_channels.extend(
                    [c for c in data.columns if (j + "_") in c and "Nub" not in c]
                )
        self.selected_joints = selected_joints
        self.selected_channels = selected_channels
        not_selected = [c for c in data.columns if c not in set(selected_channels)]
        idx = data.column_index()
        self.not_selected = not_selected
        self.not_selected_values = {
            c: float(data.values[0, idx[c]]) if len(data.values) else 0.0
            for c in not_selected
        }
        # inverse needs only structure + the not-selected constants, not
        # the whole (T, C) value block — keep a zero-row clone
        self.orig = data.clone()
        self.orig.values = self.orig.values[:0]
        return self

    def transform(self, data: ChannelData) -> ChannelData:
        idx = data.column_index()
        out = data.clone()
        out.values = data.values[:, [idx[c] for c in self.selected_channels]]
        out.columns = list(self.selected_channels)
        keep = set(self.selected_joints)
        out.names = [n for n in data.names if n in keep]
        out.channels = {n: data.channels[n] for n in out.names}
        return out

    def inverse_transform(self, data: ChannelData) -> ChannelData:
        """Re-add dropped channels as constant first-frame values
        (`preprocessing.py:373-384`)."""
        out = self.orig.clone()
        T = len(data.values)
        vals = np.zeros((T, len(out.columns)), np.float64)
        idx_out = out.column_index()
        for c, v in self.not_selected_values.items():
            vals[:, idx_out[c]] = v
        idx_in = data.column_index()
        for c in self.selected_channels:
            vals[:, idx_out[c]] = data.values[:, idx_in[c]]
        out.values = vals
        return out


class DownSampler:
    """pymo `DownSampler` parity incl. the `[0:-1:rate]` last-frame drop.

    The live BEAT pipeline uses `keep_all=False` (`process_BEAT_bvh.py:60`)
    — one track. pymo's `keep_all=True` (its default) emits `rate`
    phase-shifted tracks for augmentation; that multi-track shape does not
    fit the single-track pipeline composition here, so use
    `transform_all()` for it — `transform()` refuses rather than silently
    dropping the other phases."""

    def __init__(self, tgt_fps: int, keep_all: bool = False):
        self.tgt_fps = tgt_fps
        self.keep_all = keep_all

    def fit(self, data: ChannelData) -> "DownSampler":
        return self

    def _rate(self, data: ChannelData) -> int:
        """Validated integer decimation rate — the same guard
        `zeggs_features.featurize_animation` applies: a floor-divided
        rate on a non-divisor source (100→30 fps) would silently emit
        the wrong frame rate, desynced from the audio timeline, and a
        sub-target source (20→30) would step by zero."""
        orig_fps = round(1.0 / data.framerate)
        if self.tgt_fps <= 0 or orig_fps % self.tgt_fps != 0:
            raise ValueError(
                f"DownSampler: source {orig_fps} fps is not an integer "
                f"multiple of target {self.tgt_fps} fps")
        return orig_fps // self.tgt_fps

    def transform_all(self, data: ChannelData) -> List[ChannelData]:
        """All `rate` phase-shifted tracks (pymo keep_all=True semantics)."""
        rate = self._rate(data)
        out = []
        for ii in range(rate):
            t = data.clone()
            t.values = data.values[ii:-1:rate].copy()
            t.framerate = 1.0 / self.tgt_fps
            out.append(t)
        return out

    def transform(self, data: ChannelData) -> ChannelData:
        if self.keep_all:
            raise ValueError(
                "keep_all=True yields multiple phase-shifted tracks; "
                "call transform_all()")
        rate = self._rate(data)
        out = data.clone()
        out.values = data.values[0:-1:rate].copy()
        out.framerate = 1.0 / self.tgt_fps
        return out

    def inverse_transform(self, data: ChannelData) -> ChannelData:
        return data


class Numpyfier:
    """pymo `Numpyfier` parity."""

    def fit(self, data: ChannelData) -> "Numpyfier":
        self.template = data.clone()
        self.template.values = np.zeros((0, len(data.columns)))
        return self

    def transform(self, data: ChannelData) -> np.ndarray:
        return data.values

    def inverse_transform(self, arr: np.ndarray) -> ChannelData:
        out = self.template.clone()
        out.values = np.asarray(arr, np.float64)
        return out


class ConstantsRemover:
    """pymo `ConstantsRemover` parity: drop zero-variance channels and
    restore their constant values on inverse."""

    def __init__(self, eps: float = 1e-6, keep_root: bool = False):
        self.eps = eps
        self.keep_root = keep_root

    def fit(self, data: ChannelData) -> "ConstantsRemover":
        # pandas sample std (ddof=1), matching pymo's X.values.std() via
        # DataFrame — numpy's population default classifies near-threshold
        # channels differently from a reference-fitted pipeline
        T = len(data.values)
        stds = data.values.std(axis=0, ddof=1 if T > 1 else 0)
        root_prefix = data.root_name + "_"
        self.const_cols = []
        self.const_values = {}
        for i, c in enumerate(data.columns):
            if stds[i] < self.eps and not (self.keep_root and c.startswith(root_prefix)):
                self.const_cols.append(c)
                self.const_values[c] = float(data.values[0, i]) if len(data.values) else 0.0
        return self

    def transform(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        keep = [c for c in data.columns if c not in self.const_values]
        idx = data.column_index()
        out.values = data.values[:, [idx[c] for c in keep]]
        out.columns = keep
        return out

    def inverse_transform(self, data: ChannelData) -> ChannelData:
        T = len(data.values)
        out = data.clone()
        # restore constants by appending them after the kept columns
        all_cols = list(data.columns) + list(self.const_cols)
        vals = np.zeros((T, len(all_cols)))
        vals[:, : len(data.columns)] = data.values
        for j, c in enumerate(self.const_cols):
            vals[:, len(data.columns) + j] = self.const_values[c]
        out.columns = all_cols
        out.values = vals
        return out


class MotionPipeline:
    """Minimal sklearn-Pipeline stand-in (fit_transform / inverse_transform)."""

    def __init__(self, steps):
        self.steps = steps

    def fit_transform(self, data):
        for step in self.steps:
            step.fit(data)
            data = step.transform(data)
        return data

    def transform(self, data):
        for step in self.steps:
            data = step.transform(data)
        return data

    def inverse_transform(self, data):
        for step in reversed(self.steps):
            data = step.inverse_transform(data)
        return data


# ---------------------------------------------------------------------------
# BEAT
# ---------------------------------------------------------------------------

BEAT_TARGET_JOINTS = [
    "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Neck1", "Head", "HeadEnd",
    "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "RightHandMiddle1", "RightHandMiddle2", "RightHandMiddle3", "RightHandMiddle4",
    "RightHandRing", "RightHandRing1", "RightHandRing2", "RightHandRing3",
    "RightHandRing4", "RightHandPinky", "RightHandPinky1", "RightHandPinky2",
    "RightHandPinky3", "RightHandPinky4", "RightHandIndex", "RightHandIndex1",
    "RightHandIndex2", "RightHandIndex3", "RightHandIndex4", "RightHandThumb1",
    "RightHandThumb2", "RightHandThumb3", "RightHandThumb4",
    "LeftShoulder", "LeftArm", "LeftForeArm", "LeftHand",
    "LeftHandMiddle1", "LeftHandMiddle2", "LeftHandMiddle3", "LeftHandMiddle4",
    "LeftHandRing", "LeftHandRing1", "LeftHandRing2", "LeftHandRing3",
    "LeftHandRing4", "LeftHandPinky", "LeftHandPinky1", "LeftHandPinky2",
    "LeftHandPinky3", "LeftHandPinky4", "LeftHandIndex", "LeftHandIndex1",
    "LeftHandIndex2", "LeftHandIndex3", "LeftHandIndex4", "LeftHandThumb1",
    "LeftHandThumb2", "LeftHandThumb3", "LeftHandThumb4",
    "RightUpLeg", "RightLeg", "RightFoot", "RightForeFoot", "RightToeBase",
    "RightToeBaseEnd", "LeftUpLeg", "LeftLeg", "LeftFoot", "LeftForeFoot",
    "LeftToeBase", "LeftToeBaseEnd",
]

BEAT_EULER_ORDER = "XYZ"
TWH_EULER_ORDER = "ZXY"

TWH_BONE_NAMES = [
    "body_world", "b_root", "b_l_upleg", "b_l_leg", "b_l_foot_twist",
    "b_l_foot", "b_r_upleg", "b_r_leg", "b_r_foot_twist", "b_r_foot",
    "b_spine0", "b_spine1", "b_spine2", "b_spine3", "b_neck0", "b_head",
    "b_l_shoulder", "p_l_scap", "b_l_arm", "b_l_arm_twist", "b_l_forearm",
    "b_l_wrist_twist", "b_l_wrist", "b_l_thumb0", "b_l_thumb1", "b_l_thumb2",
    "b_l_thumb3", "b_l_index1", "b_l_index2", "b_l_index3", "b_l_middle1",
    "b_l_middle2", "b_l_middle3", "b_l_ring1", "b_l_ring2", "b_l_ring3",
    "b_l_pinky1", "b_l_pinky2", "b_l_pinky3", "b_r_shoulder", "p_r_scap",
    "b_r_arm", "b_r_arm_twist", "b_r_forearm", "b_r_wrist_twist", "b_r_wrist",
    "b_r_index1", "b_r_index2", "b_r_index3", "b_r_ring1", "b_r_ring2",
    "b_r_ring3", "b_r_middle1", "b_r_middle2", "b_r_middle3", "b_r_pinky1",
    "b_r_pinky2", "b_r_pinky3", "b_r_thumb0", "b_r_thumb1", "b_r_thumb2",
    "b_r_thumb3",
]


def beat_pipeline() -> MotionPipeline:
    return MotionPipeline(
        [
            DownSampler(tgt_fps=30, keep_all=False),
            JointSelector(BEAT_TARGET_JOINTS, include_root=True),
            Numpyfier(),
        ]
    )


def _parsed(bvh: Union[str, ChannelData]) -> ChannelData:
    return bvh if isinstance(bvh, ChannelData) else parse_bvh(bvh)


def beat_features(bvh: Union[str, ChannelData]):
    """BVH (a path, or its parse) → (T, 684) rotation-matrix features + fitted
    pipeline (parity: `process_bvh_bugfix:53-85`)."""
    data = _parsed(bvh)
    pipe = beat_pipeline()
    out = pipe.fit_transform(data)  # (T, C) euler triplets (+ root pos triplet)
    T = out.shape[0]
    trip = out.reshape(T, -1, 3)
    # NB: the first triplet is the ROOT POSITION but the reference runs it
    # through the euler→matrix conversion too — quirk preserved.
    rot = R.from_euler(BEAT_EULER_ORDER, trip.reshape(-1, 3), degrees=True)
    mats = rot.as_matrix().reshape(T, -1, 9)
    return mats.reshape(T, -1).astype(np.float32), pipe


def beat_features_to_bvh(
    poses: np.ndarray, pipe: MotionPipeline, out_path: str, smoothing: bool = True
) -> None:
    """(T, 684) → .bvh (parity: `pose2bvh_bugfix:108-131`)."""
    from scipy.signal import savgol_filter

    if smoothing:
        poses = savgol_filter(poses, 15, 2, axis=0)
    T = poses.shape[0]
    mats = poses.reshape(T, -1, 3, 3)
    euler = (
        R.from_matrix(mats.reshape(-1, 3, 3))
        .as_euler(BEAT_EULER_ORDER, degrees=True)
        .reshape(T, -1)
    )
    data = pipe.inverse_transform(euler)
    write_bvh_channels(data, out_path)


def twh_pipeline() -> MotionPipeline:
    return MotionPipeline(
        [JointSelector(TWH_BONE_NAMES, include_root=False, exact=True), Numpyfier()]
    )


def twh_features(bvh: Union[str, ChannelData]):
    """BVH (a path, or its parse) → (T, 744) [pos | rotmat] features + fitted
    pipeline (parity: `process_TWH_bvh.load_bvh:26-65`, rotmat mode)."""
    data = _parsed(bvh)
    pipe = twh_pipeline()
    out = pipe.fit_transform(data)
    T = out.shape[0]
    j6 = out.reshape(T, -1, 6)  # [Xpos Ypos Zpos | Zrot Xrot Yrot]
    mats = (
        R.from_euler(TWH_EULER_ORDER, j6[..., 3:].reshape(-1, 3), degrees=True)
        .as_matrix()
        .reshape(T, -1, 9)
    )
    feats = np.concatenate([j6[..., :3], mats], axis=-1)
    return feats.reshape(T, -1).astype(np.float32), pipe


def twh_features_to_bvh(
    poses: np.ndarray, pipe: MotionPipeline, out_path: str, smoothing: bool = True
) -> None:
    """(T, 744) → .bvh (parity: `process_TWH_bvh.pose2bvh:201-227`)."""
    from scipy.signal import savgol_filter

    if smoothing:
        poses = savgol_filter(poses, 15, 2, axis=0)
    T = poses.shape[0]
    j12 = poses.reshape(T, -1, 12)
    euler = (
        R.from_matrix(j12[..., 3:].reshape(-1, 3, 3))
        .as_euler(TWH_EULER_ORDER, degrees=True)
        .reshape(T, -1, 3)
    )
    out = np.concatenate([j12[..., :3], euler], axis=-1).reshape(T, -1)
    data = pipe.inverse_transform(out)
    write_bvh_channels(data, out_path)


# ---------------------------------------------------------------------------
# additional pymo transforms (expmap parameterization, mirror, root norm)
# ---------------------------------------------------------------------------


def joint_rot_order(data: ChannelData, joint: str) -> str:
    """'ZXY'-style rotation order from a joint's channel list."""
    return "".join(c[0] for c in data.channels.get(joint, []) if c.endswith("rotation"))


def fix_rotvec(rots: np.ndarray) -> np.ndarray:
    """Rotation-vector continuity fix (parity:
    `pymo_TWH/preprocessing.py:60-85`, incl. the odd-swap-drop behavior)."""
    new_rots = rots.copy()
    angs = np.linalg.norm(rots, axis=1)
    alt_angs = 2 * np.pi - angs
    d_angs = np.diff(angs, axis=0)
    d_angs2 = alt_angs[1:] - angs[:-1]
    swps = np.where(np.abs(d_angs2) < np.abs(d_angs))[0]
    if swps.shape[0] % 2 == 1:
        swps = swps[:-1]
    intv = 1 + swps.reshape((swps.shape[0] // 2, 2))
    for ii in range(intv.shape[0]):
        s, e = intv[ii, 0], intv[ii, 1]
        new_ax = -rots[s:e] / np.tile(angs[s:e, None], (1, 3))
        new_rots[s:e] = new_ax * np.tile(alt_angs[s:e, None], (1, 3))
    return new_rots


class MocapParameterizer:
    """pymo `MocapParameterizer` parity for the live modes:
    'euler' (identity), 'expmap' (+ inverse), 'position' (FK).

    Column-ordering quirk preserved: expmap trios are inserted at the
    FRONT per joint (`preprocessing.py:198-201`), so after iterating
    joints in skeleton order the front of the frame is
    [last-joint α β γ | … | first-joint α β γ | remaining pos columns].
    Euler→rotvec uses scipy with the LOWERCASE (extrinsic) order string,
    matching the reference exactly.
    """

    def __init__(self, param_type: str = "euler"):
        if param_type not in ("euler", "expmap", "position"):
            raise ValueError(f"unknown param_type {param_type!r}")
        self.param_type = param_type

    def fit(self, data: ChannelData) -> "MocapParameterizer":
        return self

    def transform(self, data: ChannelData):
        if self.param_type == "euler":
            return data
        if self.param_type == "expmap":
            return self._to_expmap(data)
        return self._to_pos(data)

    def inverse_transform(self, data):
        if self.param_type == "euler":
            return data
        if self.param_type == "expmap":
            return self._expmap_to_euler(data)
        raise NotImplementedError("positions → eulers is not supported (parity)")

    def _joints(self, data: ChannelData):
        return [n for n in data.names if "Nub" not in n]

    def _to_expmap(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        idx = data.column_index()
        cols = list(data.columns)
        series: Dict[str, np.ndarray] = {c: data.values[:, idx[c]] for c in cols}
        for joint in self._joints(data):
            order = joint_rot_order(data, joint)
            if len(order) != 3:
                continue
            rc = [f"{joint}_{a}rotation" for a in order]
            euler = np.stack([series[c] for c in rc], axis=1)
            exps = fix_rotvec(
                R.from_euler(order.lower(), euler, degrees=True).as_rotvec()
            )
            for c in rc:
                cols.remove(c)
                series.pop(c)
            for name, vals in (
                (f"{joint}_gamma", exps[:, 2]),
                (f"{joint}_beta", exps[:, 1]),
                (f"{joint}_alpha", exps[:, 0]),
            ):
                cols.insert(0, name)
                series[name] = vals
            out.channels[joint] = [
                c for c in data.channels[joint] if not c.endswith("rotation")
            ] + ["alpha", "beta", "gamma"]
        out.columns = cols
        out.values = np.stack([series[c] for c in cols], axis=1)
        self._orders = {j: joint_rot_order(data, j) for j in self._joints(data)}
        self._orig_channels = {k: list(v) for k, v in data.channels.items()}
        return out

    def _expmap_to_euler(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        idx = data.column_index()
        cols = list(data.columns)
        series: Dict[str, np.ndarray] = {c: data.values[:, idx[c]] for c in cols}
        for joint in self._joints(data):
            order = self._orders.get(joint, "")
            if len(order) != 3:
                continue
            trio = [f"{joint}_alpha", f"{joint}_beta", f"{joint}_gamma"]
            exp = np.stack([series[c] for c in trio], axis=1)
            eul = R.from_rotvec(exp).as_euler(order.lower(), degrees=True)
            for c in trio:
                cols.remove(c)
                series.pop(c)
            # reference appends euler cols at the END per joint
            for k, a in enumerate(order):
                name = f"{joint}_{a}rotation"
                cols.append(name)
                series[name] = eul[:, k]
            out.channels[joint] = list(self._orig_channels[joint])
        out.columns = cols
        out.values = np.stack([series[c] for c in cols], axis=1)
        return out

    def _to_pos(self, data: ChannelData) -> ChannelData:
        """Euler channels → global joint positions (pymo `_to_pos`,
        `preprocessing.py:88-169`): INTRINSIC (uppercase) euler order,
        position channels ADDED to the stored offsets for non-root joints,
        Nub end-sites included with zero rotations. Joints are visited in
        pymo's `traverse()` order (stack DFS, children popped last-first,
        `pymo/data.py:17-23`) so the OUTPUT COLUMN ORDER matches a
        reference-fitted pipeline on branching skeletons — plain parse
        order would silently permute position columns for any consumer
        that indexes them positionally."""
        T = len(data.values)
        idx = data.column_index()
        ginv: Dict[str, R] = {}  # pymo stores the INVERSE global rotation
        gpos: Dict[str, np.ndarray] = {}
        out_cols: List[str] = []
        series: Dict[str, np.ndarray] = {}
        for joint in _pymo_traverse(data):
            parent = data.parents.get(joint)
            order = joint_rot_order(data, joint)
            if len(order) == 3:
                euler = np.stack(
                    [data.values[:, idx[f"{joint}_{a}rotation"]] for a in order], axis=1
                )
                rot_inv = R.from_euler(order, euler, degrees=True).inv()
            else:
                rot_inv = R.identity(T).inv()
            pos_cols = [c for c in data.channels.get(joint, []) if c.endswith("position")]
            if len(pos_cols) == 3:
                pos_values = np.stack(
                    [data.values[:, idx[f"{joint}_{a}position"]] for a in "XYZ"], axis=1
                )
            else:
                pos_values = np.zeros((T, 3))
            if parent is None:
                ginv[joint] = rot_inv
                gpos[joint] = pos_values
            else:
                ginv[joint] = rot_inv * ginv[parent]
                k = pos_values + np.asarray(data.offsets.get(joint, np.zeros(3)))
                gpos[joint] = gpos[parent] + ginv[parent].inv().apply(k)
            for k_i, a in enumerate("XYZ"):
                name = f"{joint}_{a}position"
                out_cols.append(name)
                series[name] = np.asarray(gpos[joint])[:, k_i]
        out = data.clone()
        out.columns = out_cols
        out.values = np.stack([series[c] for c in out_cols], axis=1)
        return out


def _pymo_traverse(data: ChannelData) -> List[str]:
    """Joint order of pymo `MocapData.traverse()` (`pymo/data.py:17-23`):
    stack-based DFS from the root, children pushed in declaration order
    and popped last-first. Guarantees parent-before-child; reproduces the
    reference's column ordering for branching skeletons."""
    children: Dict[str, List[str]] = {n: [] for n in data.names}
    root = None
    for n in data.names:
        p = data.parents.get(n)
        if p is None:
            root = n
        else:
            children[p].append(n)
    order: List[str] = []
    stack = [root] if root is not None else []
    while stack:
        j = stack.pop()
        order.append(j)
        stack.extend(children[j])
    return order


class ConstantsRemoverWithRoot:
    """TWH `ConstantsRemover_withroot` parity (`preprocessing.py:959-1006`):
    drops every position/rotation channel EXCEPT the root's world position,
    plus the root's expmap trio; restores the first-frame constants on
    inverse."""

    def __init__(self, root_name: str = "body_world"):
        self.root_name = root_name

    def fit(self, data: ChannelData) -> "ConstantsRemoverWithRoot":
        cols = list(data.columns)
        const = [c for c in cols if "position" in c or "rotation" in c]
        for a in "XYZ":
            name = f"{self.root_name}_{a}position"
            if name in const:
                const.remove(name)
        for g in ("alpha", "beta", "gamma"):
            const.append(f"{self.root_name}_{g}")
        idx = data.column_index()
        self.const_dims = const
        self.const_values = {
            c: float(data.values[0, idx[c]]) if c in idx and len(data.values) else 0.0
            for c in const
        }
        return self

    def transform(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        drop = set(self.const_dims)
        idx = data.column_index()
        keep = [c for c in data.columns if c not in drop]
        out.columns = keep
        out.values = data.values[:, [idx[c] for c in keep]]
        return out

    def inverse_transform(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        cols = list(data.columns) + [c for c in self.const_dims]
        T = len(data.values)
        vals = np.zeros((T, len(cols)))
        vals[:, : len(data.columns)] = data.values
        for j, c in enumerate(self.const_dims):
            vals[:, len(data.columns) + j] = self.const_values[c]
        out.columns = cols
        out.values = vals
        return out


def mirror(data: ChannelData, axis: str = "X") -> ChannelData:
    """pymo `Mirror` parity for one track (`preprocessing.py:244-319`):
    negated root positions, Left↔Right rotation swap with per-axis signs,
    trunk rotations sign-flipped. Returns the mirrored track; pymo's
    append=True semantics = [data, mirror(data)]."""
    signs = {"X": np.array([1, -1, -1]), "Y": np.array([-1, 1, -1]),
             "Z": np.array([-1, -1, 1])}[axis]
    idx = data.column_index()
    cols: List[str] = []
    series: Dict[str, np.ndarray] = {}

    root = data.root_name
    for k, a in enumerate("XYZ"):
        name = f"{root}_{a}position"
        cols.append(name)
        series[name] = -signs[k] * data.values[:, idx[name]]

    def put(dst, src, k):
        name = f"{dst}_{'XYZ'[k]}rotation"
        cols.append(name)
        series[name] = signs[k] * data.values[:, idx[f"{src}_{'XYZ'[k]}rotation"]]

    lft = [j for j in data.names if "Left" in j and "Nub" not in j]
    for lj in lft:
        rj = lj.replace("Left", "Right")
        for k in range(3):
            put(lj, rj, k)
        for k in range(3):
            put(rj, lj, k)
    for j in data.names:
        if "Nub" in j or "Left" in j or "Right" in j:
            continue
        if joint_rot_order(data, j):
            for k in range(3):
                put(j, j, k)
    out = data.clone()
    out.columns = cols
    out.values = np.stack([series[c] for c in cols], axis=1)
    return out


def root_normalizer(data: ChannelData) -> ChannelData:
    """TWH `RootNormalizer` parity (`preprocessing.py:720-768`): center the
    root's mean position, zero X/Z root rotation, and face ±90° about Y
    depending on the starting X position."""
    out = data.clone()
    idx = data.column_index()
    vals = data.values.copy()
    root = data.root_name
    xp, yp, zp = (idx[f"{root}_{a}position"] for a in "XYZ")
    for col in (xp, yp, zp):
        vals[:, col] = vals[:, col] - vals[:, col].mean()
    new_yr = -90.0 if data.values[0, xp] < 0 else 90.0
    for a, v in (("X", 0.0), ("Y", new_yr), ("Z", 0.0)):
        c = f"{root}_{a}rotation"
        if c in idx:
            vals[:, idx[c]] = v
    out.values = vals
    return out


def twh_expmap_pipeline() -> MotionPipeline:
    """TWH expmap mode (`process_TWH_bvh.load_bvh:33-40`): JointSelector
    (root included) → MocapParameterizer('expmap') → ConstantsRemover_withroot
    → Numpyfier."""
    return MotionPipeline(
        [
            JointSelector(TWH_BONE_NAMES, include_root=True, exact=True),
            MocapParameterizer("expmap"),
            ConstantsRemoverWithRoot(),
            Numpyfier(),
        ]
    )


def twh_features_expmap(bvh_path: str):
    """BVH → (T, C) expmap features + fitted pipeline (TWH 'expmap' mode)."""
    data = parse_bvh(bvh_path)
    pipe = twh_expmap_pipeline()
    out = pipe.fit_transform(data)
    return out.astype(np.float32), pipe


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, w-first (pymo Quaternions.__mul__)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    v = np.broadcast_to(v, q.shape[:-1] + (3,))
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def _quat_between(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Quaternion rotating u onto v (pymo Quaternions.between)."""
    w = np.sqrt((u ** 2).sum(-1) * (v ** 2).sum(-1)) + (u * v).sum(-1)
    q = np.concatenate([w[..., None], np.cross(u, v)], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


_AXIS = {"X": np.array([1.0, 0, 0]), "Y": np.array([0, 1.0, 0]),
         "Z": np.array([0, 0, 1.0])}


def _quat_from_euler_intrinsic(es: np.ndarray, order: str) -> np.ndarray:
    """pymo Quaternions.from_euler(world=False): q0 ⊗ q1 ⊗ q2 with
    es[..., i] the angle about axis order[i]."""
    out = None
    for i, axis_name in enumerate(order.upper()):
        axis = _AXIS[axis_name]
        half = es[..., i] / 2.0
        q = np.concatenate(
            [np.cos(half)[..., None], np.sin(half)[..., None] * axis], axis=-1)
        out = q if out is None else _quat_mul(out, q)
    return out


def _quat_to_euler_intrinsic(q: np.ndarray, order: str) -> np.ndarray:
    """Intrinsic euler angles in `order` — equals the reference's
    `t3d.euler.quat2euler(q, 's' + order[::-1].lower())[::-1]`."""
    from scipy.spatial.transform import Rotation

    xyzw = np.concatenate([q[..., 1:], q[..., :1]], axis=-1)
    return Rotation.from_quat(xyzw.reshape(-1, 4)).as_euler(
        order.upper()).reshape(q.shape[:-1] + (3,))


class RootTransformer:
    """pymo `RootTransformer` parity (`pymo/preprocessing.py:481-718`).

    Methods:
      * 'hip_centric': zero the root's position and rotation channels;
      * 'abdolute_translation_deltas' (pymo's spelling): replace root X/Z
        positions with frame deltas `_dXposition`/`_dZposition`
        (d[0] = d[1]).  With `position_smoothing` > 0 the deltas come
        from the gaussian-smoothed trajectory and the absolute columns
        keep the residual x − x_smoothed (pymo:512-530);
      * 'pos_rot_deltas': remove the smoothed ground trajectory and the
        heading (y) rotation from the root, appending `_dXposition`/
        `_dZposition` ground velocity and `_dYrotation` angular pivot
        velocity columns (pymo:535-636).
    Inverse restores absolute positions by cumulative summation from a
    configurable start position (pymo's inverse with start_pos=0; like
    pymo, ONLY abdolute_translation_deltas inverts — hip_centric and
    pos_rot_deltas pass through).
    """

    def __init__(self, method: str, position_smoothing: float = 0,
                 rotation_smoothing: float = 0):
        if method not in ("hip_centric", "abdolute_translation_deltas", "pos_rot_deltas"):
            raise ValueError(f"unknown method {method!r}")
        self.method = method
        self.position_smoothing = position_smoothing
        self.rotation_smoothing = rotation_smoothing

    def fit(self, data: ChannelData) -> "RootTransformer":
        return self

    def transform(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        root = data.root_name
        idx = data.column_index()
        if self.method == "hip_centric":
            for a in "XYZ":
                for ch in ("position", "rotation"):
                    c = f"{root}_{a}{ch}"
                    if c in idx:
                        out.values[:, idx[c]] = 0.0
            return out
        if self.method == "pos_rot_deltas":
            return self._pos_rot_deltas(data, out, idx)
        # abdolute_translation_deltas
        xp, zp = f"{root}_Xposition", f"{root}_Zposition"
        x = data.values[:, idx[xp]]
        z = data.values[:, idx[zp]]
        if self.position_smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            x_sm = gaussian_filter1d(x, self.position_smoothing, axis=0, mode="nearest")
            z_sm = gaussian_filter1d(z, self.position_smoothing, axis=0, mode="nearest")
            dx = np.diff(x_sm, prepend=np.nan)
            dz = np.diff(z_sm, prepend=np.nan)
            dx[0] = dx[1]
            dz[0] = dz[1]
            out.values[:, idx[xp]] = x - x_sm
            out.values[:, idx[zp]] = z - z_sm
            out.columns = list(data.columns) + [f"{root}_dXposition", f"{root}_dZposition"]
            out.values = np.concatenate([out.values, dx[:, None], dz[:, None]], axis=1)
            return out
        dx = np.diff(x, prepend=np.nan)
        dz = np.diff(z, prepend=np.nan)
        dx[0] = dx[1]
        dz[0] = dz[1]
        keep = [c for c in data.columns if c not in (xp, zp)]
        vals = data.values[:, [idx[c] for c in keep]]
        out.columns = keep + [f"{root}_dXposition", f"{root}_dZposition"]
        out.values = np.concatenate([vals, dx[:, None], dz[:, None]], axis=1)
        return out

    def _pos_rot_deltas(self, data: ChannelData, out: ChannelData, idx) -> ChannelData:
        """pymo:535-636. Quaternion math follows pymo's Quaternions lib
        (standard hamilton products, w-first)."""
        root = data.root_name
        rot_order = joint_rot_order(data, root)
        pos_cols = [f"{root}_{a}position" for a in "XYZ"]
        rot_cols = [f"{root}_{a}rotation" for a in rot_order]
        positions = np.stack([data.values[:, idx[c]] for c in pos_cols], axis=1)
        rotations = np.deg2rad(
            np.stack([data.values[:, idx[c]] for c in rot_cols], axis=1))

        reference = positions * np.array([1.0, 0.0, 1.0])
        if self.position_smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            reference = gaussian_filter1d(
                reference, self.position_smoothing, axis=0, mode="nearest")
        velocity = np.diff(reference, axis=0)
        velocity = np.vstack([velocity[:1], velocity])
        positions = positions - reference

        quats = _quat_from_euler_intrinsic(rotations, rot_order)
        forward = _quat_rotate(quats, np.array([0.0, 0.0, 1.0]))
        forward[:, 1] = 0.0
        if self.rotation_smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            forward = gaussian_filter1d(
                forward, self.rotation_smoothing, axis=0, mode="nearest")
        forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

        target = np.tile(np.array([0.0, 0.0, 1.0]), (len(forward), 1))
        heading = _quat_between(target, forward)
        inv = heading * np.array([1.0, -1.0, -1.0, -1.0])
        positions = _quat_rotate(inv, positions)
        new_rotations = _quat_mul(inv, quats)
        velocity = _quat_rotate(inv, velocity)
        # pivot angular velocity (pymo Pivots.from_quaternions: heading
        # delta rotating z-forward, arctan2 on the xz plane)
        delta = _quat_mul(heading[1:], inv[:-1])
        dirs = _quat_rotate(delta, np.array([0.0, 0.0, 1.0]))
        rvelocity = np.arctan2(dirs[:, 0], dirs[:, 2])
        rvelocity = np.concatenate([rvelocity[:1], rvelocity])

        eulers = np.rad2deg(_quat_to_euler_intrinsic(new_rotations, rot_order))

        for a, col in enumerate(pos_cols):
            out.values[:, idx[col]] = positions[:, a]
        for a, col in enumerate(rot_cols):
            out.values[:, idx[col]] = eulers[:, a]
        out.columns = list(data.columns) + [
            f"{root}_dXposition", f"{root}_dZposition", f"{root}_dYrotation"]
        out.values = np.concatenate(
            [out.values, velocity[:, :1], velocity[:, 2:3],
             rvelocity[:, None]], axis=1)
        return out

    def inverse_transform(self, data: ChannelData, start_pos=(0.0, 0.0)) -> ChannelData:
        out = data.clone()
        root = data.root_name
        idx = data.column_index()
        if self.method in ("hip_centric", "pos_rot_deltas"):
            # pymo's inverse only handles abdolute_translation_deltas
            # (preprocessing.py:666-716); other methods PASS THROUGH —
            # restoring fit-time root values here would paste the training
            # clip's trajectory onto generated motion
            return out
        dxc, dzc = f"{root}_dXposition", f"{root}_dZposition"
        dx = data.values[:, idx[dxc]]
        dz = data.values[:, idx[dzc]]
        x = start_pos[0] + np.concatenate([[0.0], np.cumsum(dx[1:])])
        z = start_pos[1] + np.concatenate([[0.0], np.cumsum(dz[1:])])
        keep = [c for c in data.columns if c not in (dxc, dzc)]
        vals = data.values[:, [idx[c] for c in keep]]
        xpc, zpc = f"{root}_Xposition", f"{root}_Zposition"
        if self.position_smoothing > 0:
            # smoothed path kept the residual absolute columns: add the
            # reconstructed trajectory back onto them (pymo:693-695)
            out.columns = keep
            out.values = vals
            kidx = out.column_index()
            out.values[:, kidx[xpc]] += x
            out.values[:, kidx[zpc]] += z
            return out
        out.columns = keep + [xpc, zpc]
        out.values = np.concatenate([vals, x[:, None], z[:, None]], axis=1)
        return out
