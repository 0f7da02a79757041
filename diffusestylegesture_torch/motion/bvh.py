"""BVH reader and writer (port of `diffusestylegesture_tpu/motion/bvh.py`,
reference `ubisoft-laforge-ZeroEGGS-main/ZEGGS/anim/bvh.py:4-234`):
euler-degree rotation channels, per-joint offsets, DFS joint order, End
Sites for leaves, translation channels on the root."""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

_CHANNEL_MAP = {"Xrotation": "x", "Yrotation": "y", "Zrotation": "z"}
_CHANNEL_INV = {v: k for k, v in _CHANNEL_MAP.items()}


def load(filename: str, order: Optional[str] = None) -> Dict:
    """Parse a BVH file → dict(rotations (T, J, 3) degrees, positions (T, J, 3),
    offsets, parents, names, order, frametime), the reference loader's output."""
    names: List[str] = []
    offsets: List[np.ndarray] = []
    parents: List[int] = []
    active = -1
    end_site = False
    channels = 0
    frametime = 1.0 / 60.0
    frames: List[np.ndarray] = []
    in_motion = False

    with open(filename, "r") as f:
        for line in f:
            if in_motion:
                vals = line.split()
                if vals:
                    frames.append(np.array(vals, np.float64))
                continue
            # declarations match before the generic '{' skip: exporters may
            # put the brace inline ('ROOT Hips {', 'End Site {')
            m = re.match(r"\s*(ROOT|JOINT)\s+(\S+)", line)
            if m:
                name = m.group(2).rstrip("{").strip()
                names.append(name or m.group(2))
                offsets.append(np.zeros(3, np.float32))
                parents.append(active)
                active = len(parents) - 1
                continue
            if "End Site" in line:
                end_site = True
                continue
            if "HIERARCHY" in line or "MOTION" in line or "{" in line:
                continue
            if "}" in line:
                if end_site:
                    end_site = False
                else:
                    active = parents[active]
                continue
            m = re.match(r"\s*OFFSET\s+(\S+)\s+(\S+)\s+(\S+)", line)
            if m:
                if not end_site:
                    offsets[active] = np.array([float(g) for g in m.groups()], np.float32)
                continue
            m = re.match(r"\s*CHANNELS\s+(\d+)", line)
            if m:
                channels = int(m.group(1))
                if order is None:
                    rot_parts = [p for p in line.split()[2:] if p in _CHANNEL_MAP]
                    if len(rot_parts) >= 3:
                        order = "".join(_CHANNEL_MAP[p] for p in rot_parts[:3])
                continue
            m = re.match(r"\s*Frame Time:\s*([\d.eE+-]+)", line)
            if m:
                frametime = float(m.group(1))
                in_motion = True

    J = len(parents)
    offsets_arr = np.stack(offsets)
    data = np.stack(frames) if frames else np.zeros((0, 0))
    T = data.shape[0]
    positions = np.broadcast_to(offsets_arr, (T, J, 3)).copy().astype(np.float32)
    rotations = np.zeros((T, J, 3), np.float32)
    if T:
        if channels == 3:
            if data.shape[1] == 3 * J + 3:  # the root carries position + rotation
                positions[:, 0] = data[:, 0:3]
                rotations[:] = data[:, 3:].reshape(T, J, 3)
            elif data.shape[1] == 3 * J:  # rotation channels only
                rotations[:] = data.reshape(T, J, 3)
            else:
                raise ValueError(f"frame width {data.shape[1]} does not match {J} joints")
        elif channels == 6:
            blk = data.reshape(T, J, 6)
            positions[:] = blk[..., 0:3]
            rotations[:] = blk[..., 3:6]
        else:
            raise ValueError(f"unsupported channel count {channels}")
    return {"rotations": rotations, "positions": positions, "offsets": offsets_arr,
            "parents": np.asarray(parents, np.int32), "names": names, "order": order,
            "frametime": frametime}


def save(filename: str, data: Dict, translations: bool = False) -> None:
    rots = np.asarray(data["rotations"])
    poss = np.asarray(data["positions"])
    offsets = np.asarray(data["offsets"])
    parents = np.asarray(data["parents"])
    names = data.get("names") or [f"joint_{i}" for i in range(len(parents))]
    order = data.get("order", "zyx")
    frametime = data.get("frametime", 1.0 / 60.0)
    chan_names = " ".join(_CHANNEL_INV[c] for c in order)

    children: Dict[int, List[int]] = {}
    for j in range(1, len(parents)):
        children.setdefault(int(parents[j]), []).append(j)

    lines: List[str] = []
    jseq: List[int] = []

    def emit(i: int, depth: int):
        t = "\t" * depth
        jseq.append(i)
        lines.append(f"{t}{'ROOT' if i == 0 else 'JOINT'} {names[i]}")
        lines.append(f"{t}{{")
        t2 = "\t" * (depth + 1)
        lines.append(f"{t2}OFFSET {offsets[i, 0]:f} {offsets[i, 1]:f} {offsets[i, 2]:f}")
        if translations or i == 0:
            lines.append(f"{t2}CHANNELS 6 Xposition Yposition Zposition {chan_names} ")
        else:
            lines.append(f"{t2}CHANNELS 3 {chan_names}")
        kids = children.get(i, [])
        for c in kids:
            emit(c, depth + 1)
        if not kids:
            lines.append(f"{t2}End Site")
            lines.append(f"{t2}{{")
            lines.append(f"{t2}\tOFFSET {0.0:f} {0.0:f} {0.0:f}")
            lines.append(f"{t2}}}")
        lines.append(f"{t}}}")

    with open(filename, "w") as f:
        f.write("HIERARCHY\n")
        emit(0, 0)
        f.write("\n".join(lines) + "\n")
        f.write("MOTION\n")
        f.write(f"Frames: {len(rots)}\n")
        f.write(f"Frame Time: {frametime:f}\n")
        for i in range(rots.shape[0]):
            parts = []
            for j in jseq:
                if translations or j == 0:
                    parts.append(f"{poss[i, j, 0]:f} {poss[i, j, 1]:f} {poss[i, j, 2]:f} "
                                 f"{rots[i, j, 0]:f} {rots[i, j, 1]:f} {rots[i, j, 2]:f} ")
                else:
                    parts.append(f"{rots[i, j, 0]:f} {rots[i, j, 1]:f} {rots[i, j, 2]:f} ")
            f.write("".join(parts) + "\n")
