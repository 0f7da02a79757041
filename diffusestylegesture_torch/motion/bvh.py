"""BVH writer (port of `diffusestylegesture_tpu/motion/bvh.py::save`,
reference `ubisoft-laforge-ZeroEGGS-main/ZEGGS/anim/bvh.py:137-191`):
euler-degree rotation channels, per-joint offsets, DFS joint order, End
Sites for leaves, translation channels on the root."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_CHANNEL_INV = {"x": "Xrotation", "y": "Yrotation", "z": "Zrotation"}


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
