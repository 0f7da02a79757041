"""BVH -> glTF 2.0 (GLB) skeleton-animation exporter.

Port of `diffusestylegesture_tpu/motion/gltf_export.py` (numpy + scipy, the
port's own copy on the port's `motion/pipeline.py::{parse_bvh,
joint_rot_order}`). The reference's `ZEGGS/bvh2fbx/bvh2fbx.py` drives the
Windows-only FBX SDK; the hand-off here is glTF 2.0: one node per joint (rest
pose = the BVH offsets), one animation with a rotation sampler per animated
joint and a translation sampler for joints with position channels, in one
binary GLB container. The FK semantics are the package's BVH FK
(`MocapParameterizer("position")`). The bytes equal the JAX exporter's,
its `asset.generator` string included.

Usage::

    from diffusestylegesture_torch.motion.gltf_export import bvh_to_glb
    bvh_to_glb("generated.bvh", "generated.glb")
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as R

from .pipeline import ChannelData, joint_rot_order, parse_bvh

_GLB_MAGIC = 0x46546C67  # "glTF"
_CHUNK_JSON = 0x4E4F534A  # "JSON"
_CHUNK_BIN = 0x004E4942  # "BIN\0"

_COMPONENT_F32 = 5126


class _BufferBuilder:
    """Accumulates little-endian float32 blobs into one glTF buffer and
    emits the matching bufferView/accessor table entries."""

    def __init__(self):
        self.blob = bytearray()
        self.views: List[dict] = []
        self.accessors: List[dict] = []

    def add(self, arr: np.ndarray, gltf_type: str,
            with_minmax: bool = False) -> int:
        arr = np.ascontiguousarray(arr, dtype="<f4")
        offset = len(self.blob)
        self.blob.extend(arr.tobytes())
        self.views.append({
            "buffer": 0, "byteOffset": offset, "byteLength": arr.nbytes,
        })
        acc = {
            "bufferView": len(self.views) - 1,
            "componentType": _COMPONENT_F32,
            "count": int(arr.shape[0]),
            "type": gltf_type,
        }
        if with_minmax:  # required on animation sampler inputs (spec 3.11)
            flat = arr.reshape(arr.shape[0], -1)
            acc["min"] = [float(v) for v in flat.min(axis=0)]
            acc["max"] = [float(v) for v in flat.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1


def _local_quats(track: ChannelData, joint: str,
                 idx: Dict[str, int]) -> Optional[np.ndarray]:
    """Per-frame local rotation as glTF xyzw quaternions, or None for
    rotation-less joints (Nub end sites)."""
    order = joint_rot_order(track, joint)
    if len(order) != 3:
        return None
    euler = np.stack(
        [track.values[:, idx[f"{joint}_{a}rotation"]] for a in order], axis=1)
    q = R.from_euler(order, euler, degrees=True).as_quat()  # xyzw (glTF's)
    # enforce temporal hemisphere continuity so linear interpolation
    # between keyframes never crosses the antipode
    flips = np.cumsum((q[1:] * q[:-1]).sum(axis=1) < 0) % 2
    q[1:][flips == 1] *= -1.0
    return q.astype(np.float32)


def _local_translations(track: ChannelData, joint: str,
                        idx: Dict[str, int]) -> Optional[np.ndarray]:
    """Per-frame local translation for joints with position channels
    (root always; others only in position-animated rigs). BVH semantics
    (`pipeline.py _to_pos`): root = position channels alone; non-root =
    offset + position channels."""
    pos_cols = [c for c in track.channels.get(joint, [])
                if c.endswith("position")]
    if len(pos_cols) != 3:
        return None
    pos = np.stack(
        [track.values[:, idx[f"{joint}_{a}position"]] for a in "XYZ"], axis=1)
    if track.parents.get(joint) is not None:
        pos = pos + np.asarray(track.offsets.get(joint, np.zeros(3)))
    return pos.astype(np.float32)


def channeldata_to_gltf(track: ChannelData) -> Tuple[dict, bytes]:
    """Build the glTF JSON dict + binary buffer for a parsed BVH track."""
    idx = track.column_index()
    T = len(track.values)
    times = (np.arange(T, dtype=np.float32) * track.framerate)

    node_index = {n: i for i, n in enumerate(track.names)}
    nodes: List[dict] = []
    for name in track.names:
        node: dict = {"name": name}
        off = [float(v) for v in np.asarray(
            track.offsets.get(name, np.zeros(3)), dtype=np.float64)]
        if any(off):
            node["translation"] = off
        children = [node_index[c] for c in track.names
                    if track.parents.get(c) == name]
        if children:
            node["children"] = children
        nodes.append(node)
    roots = [node_index[n] for n in track.names
             if track.parents.get(n) is None]

    buf = _BufferBuilder()
    time_acc = buf.add(times[:, None], "SCALAR", with_minmax=True)
    samplers: List[dict] = []
    channels: List[dict] = []

    def emit(node: int, path: str, values: np.ndarray, gltf_type: str):
        out_acc = buf.add(values, gltf_type)
        samplers.append({"input": time_acc, "interpolation": "LINEAR",
                         "output": out_acc})
        channels.append({"sampler": len(samplers) - 1,
                         "target": {"node": node, "path": path}})

    for name in track.names:
        q = _local_quats(track, name, idx)
        if q is not None:
            emit(node_index[name], "rotation", q, "VEC4")
        t = _local_translations(track, name, idx)
        if t is not None:
            emit(node_index[name], "translation", t, "VEC3")

    gltf = {
        "asset": {"version": "2.0",
                  # the JAX exporter's name, so that both write the same bytes
                  "generator": "diffusestylegesture_tpu.motion.gltf_export"},
        "scene": 0,
        "scenes": [{"nodes": roots}],
        "nodes": nodes,
        "animations": [{"name": "mocap", "samplers": samplers,
                        "channels": channels}],
        "buffers": [{"byteLength": len(buf.blob)}],
        "bufferViews": buf.views,
        "accessors": buf.accessors,
    }
    return gltf, bytes(buf.blob)


def write_glb(gltf: dict, blob: bytes, out_path: str) -> str:
    """Pack JSON + buffer into a binary glTF container (GLB, spec §4):
    12-byte header, 4-aligned JSON chunk (space-padded), BIN chunk
    (zero-padded)."""
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    bb = blob + b"\x00" * (-len(blob) % 4)
    total = 12 + 8 + len(js) + 8 + len(bb)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _CHUNK_JSON))
        f.write(js)
        f.write(struct.pack("<II", len(bb), _CHUNK_BIN))
        f.write(bb)
    return out_path


def bvh_to_glb(bvh_path: str, out_path: str) -> str:
    """`bvh2fbx.py` product surface: generated BVH file → a single binary
    asset any DCC/engine/browser viewer imports. Returns ``out_path``."""
    track = parse_bvh(bvh_path)
    gltf, blob = channeldata_to_gltf(track)
    return write_glb(gltf, blob, out_path)


def read_glb(path: str) -> Tuple[dict, bytes]:
    """Parse a GLB back into (json, buffer) — used by tests and sanity
    tooling; strict about the container invariants it wrote."""
    with open(path, "rb") as f:
        magic, version, total = struct.unpack("<III", f.read(12))
        if magic != _GLB_MAGIC or version != 2:
            raise ValueError(
                f"{path}: not a GLB v2 container "
                f"(magic 0x{magic:08x}, version {version})")
        jlen, jtype = struct.unpack("<II", f.read(8))
        if jtype != _CHUNK_JSON:
            raise ValueError(f"{path}: first chunk is not JSON (0x{jtype:08x})")
        gltf = json.loads(f.read(jlen))
        blen, btype = struct.unpack("<II", f.read(8))
        if btype != _CHUNK_BIN:
            raise ValueError(f"{path}: second chunk is not BIN (0x{btype:08x})")
        blob = f.read(blen)
        if 12 + 8 + jlen + 8 + blen != total:
            raise ValueError(
                f"{path}: header total {total} != chunk sum "
                f"{12 + 8 + jlen + 8 + blen}")
    return gltf, blob
