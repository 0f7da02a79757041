"""Mocap visualisation tools, pymo `viz_tools` parity.

Port of `diffusestylegesture_tpu/motion/viz.py` (numpy, the port's own copy;
reference `BEAT-TWH-main/process/pymo_TWH/viz_tools.py:6-234`) on the port's
:class:`~diffusestylegesture_torch.motion.pipeline.ChannelData`. The draw
functions take a position-parameterised track (`MocapParameterizer("position")`,
columns `<joint>_{X,Y,Z}position`).

matplotlib is imported when a draw function runs, never at import: the
package imports on a machine without it (the card's machine has none), and
callers pick a non-interactive backend themselves (the tests use Agg).
`mocapplayer_buffer` writes the reference's `data.js` buffer for the player
of `motion/mocap_player.py`.
"""
from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence

import numpy as np

from .pipeline import ChannelData


def _plt():
    import matplotlib.pyplot as plt

    return plt


def skeleton_children(track: ChannelData) -> Dict[str, List[str]]:
    """children lists in parse order (pymo tracks them in `skeleton[j]['children']`)."""
    ch: Dict[str, List[str]] = {n: [] for n in track.names}
    for n in track.names:
        p = track.parents.get(n)
        if p is not None:
            ch[p].append(n)
    return ch


def save_fig(fig_id: str, tight_layout: bool = True) -> None:
    """`viz_tools.py:6-10` — save the current figure as `<fig_id>.png` @300 dpi."""
    plt = _plt()
    if tight_layout:
        plt.tight_layout()
    plt.savefig(fig_id + ".png", format="png", dpi=300)


def _frame_value(track, data, idx, col, frame):
    values = track.values if data is None else data
    return values[frame, idx[col]]


def draw_stickfigure(track: ChannelData, frame: int, data: Optional[np.ndarray] = None,
                     joints: Optional[Sequence[str]] = None, draw_names: bool = False,
                     ax=None, figsize=(8, 8)):
    """2-D (X up-right-plane) stick figure — `viz_tools.py:12-47`."""
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
    joints_to_draw = list(track.names) if joints is None else list(joints)
    idx = track.column_index()
    children = skeleton_children(track)
    for joint in joints_to_draw:
        px = _frame_value(track, data, idx, f"{joint}_Xposition", frame)
        py = _frame_value(track, data, idx, f"{joint}_Yposition", frame)
        ax.scatter(x=px, y=py, alpha=0.6, c="b", marker="o")
        for c in (c for c in children[joint] if c in joints_to_draw):
            cx = _frame_value(track, data, idx, f"{c}_Xposition", frame)
            cy = _frame_value(track, data, idx, f"{c}_Yposition", frame)
            ax.plot([px, cx], [py, cy], "k-", lw=2)
        if draw_names:
            ax.annotate(joint, (px + 0.1, py + 0.1))
    return ax


def draw_stickfigure3d(track: ChannelData, frame: int, data: Optional[np.ndarray] = None,
                       joints: Optional[Sequence[str]] = None, draw_names: bool = False,
                       ax=None, figsize=(8, 8)):
    """3-D stick figure, mocap Y-up mapped to matplotlib z — `viz_tools.py:49-96`."""
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111, projection="3d")
    joints_to_draw = list(track.names) if joints is None else list(joints)
    idx = track.column_index()
    children = skeleton_children(track)
    for joint in joints_to_draw:
        px = _frame_value(track, data, idx, f"{joint}_Xposition", frame)
        py = _frame_value(track, data, idx, f"{joint}_Zposition", frame)
        pz = _frame_value(track, data, idx, f"{joint}_Yposition", frame)
        ax.scatter(xs=px, ys=py, zs=pz, alpha=0.6, c="b", marker="o")
        for c in (c for c in children[joint] if c in joints_to_draw):
            cx = _frame_value(track, data, idx, f"{c}_Xposition", frame)
            cy = _frame_value(track, data, idx, f"{c}_Zposition", frame)
            cz = _frame_value(track, data, idx, f"{c}_Yposition", frame)
            ax.plot([px, cx], [py, cy], [pz, cz], "k-", lw=2)
        if draw_names:
            ax.text(x=px + 0.1, y=py + 0.1, z=pz + 0.1, s=joint, color="black")
    return ax


def sketch_move(track: ChannelData, data: Optional[np.ndarray] = None,
                ax=None, figsize=(16, 8)):
    """Gray motion-trail sketch, every 4th frame with time-fading alpha —
    `viz_tools.py:98-122`."""
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(111)
    values = track.values if data is None else data
    idx = track.column_index()
    children = skeleton_children(track)
    for frame in range(0, values.shape[0], 4):
        frame_alpha = frame / values.shape[0]
        for joint in track.names:
            px = values[frame, idx[f"{joint}_Xposition"]]
            py = values[frame, idx[f"{joint}_Yposition"]]
            for c in children[joint]:
                cx = values[frame, idx[f"{c}_Xposition"]]
                cy = values[frame, idx[f"{c}_Yposition"]]
                ax.plot([px, cx], [py, cy], "-", lw=1, color="gray",
                        alpha=frame_alpha)
    return ax


def viz_cnn_filter(feature_to_viz: np.ndarray, track: ChannelData,
                   data: Optional[np.ndarray] = None, gap: float = 25):
    """Per-joint activation dots over a time-unrolled skeleton —
    `viz_tools.py:125-152`."""
    plt = _plt()
    plt.figure(figsize=(16, 4))
    ax = plt.subplot2grid((1, 8), (0, 0))
    ax.imshow(feature_to_viz.T, aspect="auto", interpolation="nearest")
    ax = plt.subplot2grid((1, 8), (0, 1), colspan=7)
    values = track.values if data is None else data
    idx = track.column_index()
    children = skeleton_children(track)
    frame_alpha = 0.2
    for frame in range(feature_to_viz.shape[0]):
        for joint_i, joint in enumerate(track.names):
            px = values[frame, idx[f"{joint}_Xposition"]] + frame * gap
            py = values[frame, idx[f"{joint}_Yposition"]]
            act = feature_to_viz[frame][joint_i] * 10000
            ax.scatter(x=px, y=py, alpha=0.6, cmap="RdBu", c=act,
                       marker="o", s=abs(act))
            plt.axis("off")
            for c in children[joint]:
                cx = values[frame, idx[f"{c}_Xposition"]] + frame * gap
                cy = values[frame, idx[f"{c}_Yposition"]]
                ax.plot([px, cx], [py, cy], "-", lw=1, color="gray",
                        alpha=frame_alpha)
    return ax


def print_skel(track: ChannelData, out=None) -> str:
    """Indented skeleton dump, DFS via an explicit stack with indentation =
    stack depth — `viz_tools.py:155-163` (exact line format `'| '*tab- name (parent)`)."""
    children = skeleton_children(track)
    buf = io.StringIO()
    stack = [track.root_name]
    while stack:
        joint = stack.pop()
        tab = len(stack)
        print("%s- %s (%s)" % ("| " * tab, joint, track.parents.get(joint)),
              file=buf)
        for c in children[joint]:
            stack.append(c)
    text = buf.getvalue()
    print(text, end="", file=out) if out is not None else print(text, end="")
    return text


def _position_csv(track: ChannelData) -> str:
    """CSV of the position columns only (header + rows), pandas `to_csv`
    layout. The reference drops rotation columns with a modify-while-
    iterating loop (`viz_tools.py:206-208`) that only removes every other
    one; on its intended input (position-parameterized tracks) there are
    none, and we drop them all."""
    cols = [c for c in track.columns if "rotation" not in c]
    idx = track.column_index()
    sub = track.values[:, [idx[c] for c in cols]]
    lines = [",".join(cols)]
    for row in sub:
        lines.append(",".join(_fmt_num(v) for v in row))
    return "\n".join(lines) + "\n"


def _fmt_num(v: float) -> str:
    # pandas to_csv prints repr-style shortest float
    return repr(float(v)) if not float(v).is_integer() else str(float(v))


def mocapplayer_buffer(track: ChannelData, meta: Optional[np.ndarray] = None,
                       frame_time: float = 1 / 30, scale: float = 1,
                       camera_z: float = 500) -> str:
    """Build the `data.js` buffer string the in-browser mocap player loads —
    the data-serialization half of `nb_play_mocap` (`viz_tools.py:190-231`):
    position-column CSV spliced into the JS template with metadata, camera-z,
    scale and frame-time. Returns the JS text instead of writing it next to a
    vendored player."""
    data_csv = _position_csv(track)
    if meta is not None:
        lines = [",".join(item) for item in np.asarray(meta).astype("str")]
        meta_csv = "[" + ",".join("[%s]" % ln for ln in lines) + "]"
    else:
        meta_csv = "[]"
    out = "var dataBuffer = `$$DATA$$`;"
    out += "var metadata = $$META$$;"
    out += "start(dataBuffer, metadata, $$CZ$$, $$SCALE$$, $$FRAMETIME$$);"
    out = out.replace("$$DATA$$", data_csv)
    out = out.replace("$$META$$", meta_csv)
    out = out.replace("$$CZ$$", str(camera_z))
    out = out.replace("$$SCALE$$", str(scale))
    out = out.replace("$$FRAMETIME$$", str(frame_time))
    return out
