"""Remaining pymo preprocessing transforms, beyond the live-path subset in
`pipeline.py`: port of `diffusestylegesture_tpu/motion/pipeline_extras.py`.

Ports, on `ChannelData` (arrays, no pandas):

  * `Slicer` — overlapping fixed-size windows + inverse back to tracks
    (`pymo_TWH/preprocessing.py:428-479`);
  * `RootCentricPositionNormalizer` — subtract the root's ground
    projection from every non-root joint position (`:778-846`; the
    root-joint test is pymo's substring check `root_name not in joint`);
  * `Flattener` — concatenate along time (`:848-856`);
  * `ListStandardScaler` / `ListMinMaxScaler` — per-feature z/minmax
    normalization fit over a list of arrays (`:1018-1117`);
  * `ReverseTime` — append (or replace with) time-reversed tracks
    (`:1157-1176`);
  * `TemplateTransform` — identity placeholder (`:1187-1196`);
  * `ConstantsRemoverAllPosRot` (pymo's `ConstantsRemover_`) — drop every
    position/rotation channel outright, remembering first-frame values
    (`:904-957`; dead in the reference, kept for surface completeness).

Transforms that take/return single tracks elsewhere in this package keep
that convention; list-valued ones (Slicer, scalers, Flattener,
ReverseTime) take sequences like pymo.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .pipeline import ChannelData


class Slicer:
    """Equal-size overlapping windows over each track's values."""

    def __init__(self, window_size: int, overlap: float = 0.5):
        self.window_size = window_size
        self.overlap = overlap

    def fit(self, tracks: Sequence[ChannelData]) -> "Slicer":
        self.org_mocap_ = tracks[0].clone()
        self.org_mocap_.values = self.org_mocap_.values[:0]
        return self

    def transform(self, tracks: Sequence[ChannelData]) -> np.ndarray:
        out = []
        overlap_frames = int(self.overlap * self.window_size)
        step = self.window_size - overlap_frames
        for track in tracks:
            vals = track.values
            n_sequences = (len(vals) - overlap_frames) // step
            for i in range(max(n_sequences, 0)):
                out.append(vals[i * step: i * step + self.window_size])
        return np.array(out)

    def inverse_transform(self, windows: Sequence[np.ndarray]) -> List[ChannelData]:
        out = []
        for win in windows:
            track = self.org_mocap_.clone()
            track.values = np.asarray(win)
            out.append(track)
        return out


class RootCentricPositionNormalizer:
    """Positions relative to the root's ground projection."""

    def fit(self, data: ChannelData) -> "RootCentricPositionNormalizer":
        return self

    @staticmethod
    def _joints(data: ChannelData, include_root: bool):
        root = data.root_name
        for joint in data.names:
            # pymo uses the substring test `root_name not in joint`
            if include_root or root not in joint:
                if f"{joint}_Xposition" in data.columns:
                    yield joint

    def transform(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        idx = data.column_index()
        root = data.root_name
        proj = np.stack([
            data.values[:, idx[f"{root}_Xposition"]],
            np.zeros(len(data.values)),
            data.values[:, idx[f"{root}_Zposition"]],
        ], axis=1)
        for joint in self._joints(data, include_root=False):
            for a, ax in enumerate("XYZ"):
                c = idx[f"{joint}_{ax}position"]
                out.values[:, c] = data.values[:, c] - proj[:, a]
        return out

    def inverse_transform(self, data: ChannelData) -> ChannelData:
        out = data.clone()
        idx = data.column_index()
        root = data.root_name
        proj = np.stack([
            data.values[:, idx[f"{root}_Xposition"]],
            np.zeros(len(data.values)),
            data.values[:, idx[f"{root}_Zposition"]],
        ], axis=1)
        # pymo's inverse adds the projection to EVERY joint incl. the root
        # (preprocessing.py:836-840)
        for joint in self._joints(data, include_root=True):
            for a, ax in enumerate("XYZ"):
                c = idx[f"{joint}_{ax}position"]
                out.values[:, c] = data.values[:, c] + proj[:, a]
        return out


class ConstantsRemoverAllPosRot:
    """pymo `ConstantsRemover_` (`pymo_TWH/preprocessing.py:904-957`):
    unconditionally drops every column containing "position" or "rotation"
    (fit looks only at the first track), remembering each dropped column's
    first-frame value; inverse re-appends them as constants. The `eps`
    argument is accepted and ignored exactly like the reference (its
    std-threshold logic is commented out there)."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def fit(self, tracks: Sequence[ChannelData]) -> "ConstantsRemoverAllPosRot":
        first = tracks[0]
        idx = first.column_index()
        self.const_dims_ = [c for c in first.columns
                            if "position" in c or "rotation" in c]
        self.const_values_ = {c: float(first.values[0, idx[c]])
                              for c in self.const_dims_}
        return self

    def transform(self, tracks: Sequence[ChannelData]) -> List[ChannelData]:
        out = []
        for track in tracks:
            t2 = track.clone()
            idx = track.column_index()
            keep = [c for c in track.columns if c not in self.const_dims_]
            t2.columns = keep
            t2.values = track.values[:, [idx[c] for c in keep]]
            out.append(t2)
        return out

    def inverse_transform(self, tracks: Sequence[ChannelData]) -> List[ChannelData]:
        out = []
        for track in tracks:
            t2 = track.clone()
            t2.columns = list(track.columns) + list(self.const_dims_)
            const = np.tile(
                np.array([self.const_values_[c] for c in self.const_dims_]),
                (len(track.values), 1))
            t2.values = np.concatenate([track.values, const], axis=1)
            out.append(t2)
        return out


class Flattener:
    def fit(self, arrays) -> "Flattener":
        return self

    def transform(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        return np.concatenate(list(arrays), axis=0)


class ListStandardScaler:
    """Per-feature mean/std fit over a list of (T, C) arrays."""

    def fit(self, arrays: Sequence[np.ndarray]) -> "ListStandardScaler":
        flat = np.concatenate([np.asarray(a) for a in arrays], axis=0)
        self.data_mean_ = flat.mean(axis=0)
        self.data_std_ = flat.std(axis=0)
        return self

    def transform(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        return np.array([(np.asarray(a) - self.data_mean_) / self.data_std_
                         for a in arrays])

    def inverse_transform(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        return np.array([np.asarray(a) * self.data_std_ + self.data_mean_
                         for a in arrays])


class ListMinMaxScaler:
    """Per-feature min/max fit over a list of (T, C) arrays."""

    def fit(self, arrays: Sequence[np.ndarray]) -> "ListMinMaxScaler":
        flat = np.concatenate([np.asarray(a) for a in arrays], axis=0)
        self.data_max_ = flat.max(axis=0)
        self.data_min_ = flat.min(axis=0)
        return self

    def transform(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        span = self.data_max_ - self.data_min_
        return np.array([(np.asarray(a) - self.data_min_) / span for a in arrays])

    def inverse_transform(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        span = self.data_max_ - self.data_min_
        return np.array([np.asarray(a) * span + self.data_min_ for a in arrays])


class ReverseTime:
    """Data augmentation: append time-reversed copies of every track."""

    def __init__(self, append: bool = True):
        self.append = append

    def fit(self, tracks) -> "ReverseTime":
        return self

    def transform(self, tracks: Sequence[ChannelData]) -> List[ChannelData]:
        out = list(tracks) if self.append else []
        for track in tracks:
            rev = track.clone()
            rev.values = track.values[::-1].copy()
            out.append(rev)
        return out

    def inverse_transform(self, tracks):
        return tracks


class TemplateTransform:
    def fit(self, x) -> "TemplateTransform":
        return self

    def transform(self, x):
        return x
