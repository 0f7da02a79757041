"""BEAT raw-BVH repair utilities (port of
`diffusestylegesture_tpu/data/bvh_repair.py`, plain Python).

Parity with `BEAT-TWH-main/process/process_BEAT_bvh.py`:
  * `fix_frame_count` ↔ `pre_processing:284-311` — many raw BEAT files
    declare a `Frames:` count that disagrees with the actual data block;
    rewrite the header from the true line count (the reference assumes
    the header sits at line 430 with 431 header lines; here the header
    line is located robustly but the same correction is applied);
  * `reorient_t_pose` ↔ `process_T_pose:314-352` — speaker-2 clips face
    backwards: negate X/Z offsets, subtract 180° from the root's first
    rotation channel, and flip the Z/X rotation signs of every joint.
"""
from __future__ import annotations

from typing import Optional, Tuple


def fix_frame_count(path: str, write: bool = True) -> Tuple[bool, int]:
    """Rewrite a BVH 'Frames:' header to match the actual data rows.

    Returns (was_fixed, correct_frames).
    """
    with open(path, "r") as f:
        content = f.readlines()
    frames_line = None
    for i, line in enumerate(content):
        if line.startswith("Frames:"):
            frames_line = i
            break
    if frames_line is None:
        raise ValueError(f"no Frames: header in {path}")
    declared = int(content[frames_line].split(":")[1])
    data_start = frames_line + 2  # Frames: / Frame Time: / data...
    actual = sum(1 for l in content[data_start:] if l.strip())
    if actual == declared:
        return False, declared
    content[frames_line] = f"Frames: {actual}\n"
    if write:
        with open(path, "w") as f:
            f.writelines(content)
    return True, actual


def reorient_t_pose(path: str, out_path: Optional[str] = None) -> None:
    """Flip a backwards-facing clip (ref `process_T_pose:314-352`).

    OFFSET lines: negate X and Z. Motion rows (per reference
    `process_T_pose`: `line[4] -= 180`, `line[5]` negated): the root's
    SECOND rotation channel −180°, THIRD negated (row layout = 3 position
    channels then 3 rotation channels, so vals[4]/vals[5] are rotation
    channels 1/2), and for every subsequent joint triplet negate channels
    0 and 2 (the Z/X rotations under the BEAT ZXY ordering).
    """
    with open(path, "r") as f:
        content = f.readlines()
    frames_line = next(
        i for i, l in enumerate(content) if l.startswith("Frames:")
    )
    data_start = frames_line + 2
    out = []
    for i, line in enumerate(content):
        if "OFFSET" in line and i < data_start:
            parts = line.rstrip("\n").split(" ")
            parts[-3] = str(0.0 - float(parts[-3]))
            parts[-1] = str(0.0 - float(parts[-1]))
            out.append(" ".join(parts) + "\n")
        elif i >= data_start and line.strip():
            vals = line.strip().replace("  ", " ").split(" ")
            vals[4] = str(float(vals[4]) - 180.0)
            vals[5] = str(0.0 - float(vals[5]))
            for j in range(2 + 6, len(vals), 3):
                vals[j] = str(0.0 - float(vals[j]))
                vals[j - 2] = str(0.0 - float(vals[j - 2]))
            out.append(" ".join(vals) + "\n")
        else:
            out.append(line)
    with open(out_path or path, "w") as f:
        f.writelines(out)
