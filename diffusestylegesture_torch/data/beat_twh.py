"""BEAT/TWH end-to-end feature assembly, host numpy.

Port of `diffusestylegesture_tpu/data/beat_twh.py`. Parity targets:
  * `load_audio_features` (reference `load_audio`, `process_TWH_bvh.py:100-132`):
    the 1133-d per-frame audio vector [MFCC-40 | log-mel-64 | prosody-4 |
    WavLM-1024 interpolated | onset-1], cropped to the shortest of the host
    features;
  * `load_metadata` (`process_TWH_bvh.py:228-268`): GENEA metadata CSV →
    (num_speakers, by-fname and by-index dicts of (has_finger, speaker_id));
  * `textgrid_to_tsv` (`Grid2tsv`, `process_BEAT_bvh.py:213-220`): the first
    tier of a Praat TextGrid (long, short or header-less long format) →
    tab-separated (start, end, word) rows, with a small built-in reader;
  * `build_beat_twh_clip`: gesture + audio + text of one clip, cropped to a
    common length, the dict the dataset store is built from
    (`data/h5_loader.py::build_h5_dataset`).
"""
from __future__ import annotations

import csv
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..audio import features as AF
from ..models.wavlm.model import interpolate_linear
from ..motion import pipeline as MP
from .text import load_tsv


def load_audio_features(wav: np.ndarray, sr: int,
                        wavlm_features: Optional[np.ndarray] = None) -> np.ndarray:
    """(T, 1133) fused per-frame audio features, float32.

    `wavlm_features` is the (T', 1024) output of `models.wavlm.make_twh_wavlm_fn`,
    linearly interpolated (align_corners) to the T frames on the host; zeros
    stand in when it is None, as in the JAX package.
    """
    mfcc_f = AF.mfcc(wav, sr)
    melspec_f = AF.log_melspectrogram(wav, sr)
    prosody = AF.prosodic_features(wav, sr)
    crop = min(mfcc_f.shape[0], melspec_f.shape[0], prosody.shape[0])
    if wavlm_features is None:
        wavlm_i = np.zeros((crop, 1024), np.float32)
    else:
        feats = torch.as_tensor(np.asarray(wavlm_features, np.float32))[None]
        wavlm_i = interpolate_linear(feats, crop)[0].numpy()
    onsets = AF.onset_flags(wav, sr, crop)
    return np.concatenate([mfcc_f[:crop], melspec_f[:crop], prosody[:crop], wavlm_i,
                           onsets.reshape(-1, 1).astype(np.float32)], axis=1)


def load_metadata(metadata_csv: str, participant: str = "main-agent"):
    """GENEA-2023 metadata (parity: `load_metadata:228-268`): (number of
    distinct speakers, {'<fname>_<participant>': (has_finger, speaker_id)},
    {row: (has_finger, speaker_id)}), speaker ids 0-based."""
    if participant not in ("main-agent", "interloctr"):
        raise ValueError(f"participant must be main-agent or interloctr, not {participant!r}")
    metadict_byfname: Dict[str, Tuple[bool, int]] = {}
    metadict_byindex: Dict[int, Tuple[bool, int]] = {}
    speaker_ids: List[int] = []
    with open(metadata_csv) as f:
        for i, line in enumerate(f.readlines()[1:]):
            fname, main_id, main_finger, iloc_id, iloc_finger = line.strip().split(",")
            if participant == "main-agent":
                has_finger, speaker_id = main_finger == "finger_incl", int(main_id) - 1
            else:
                has_finger, speaker_id = iloc_finger == "finger_incl", int(iloc_id) - 1
            speaker_ids.append(speaker_id)
            metadict_byindex[i] = (has_finger, speaker_id)
            metadict_byfname[f"{fname}_{participant}"] = (has_finger, speaker_id)
    return len(set(speaker_ids)), metadict_byfname, metadict_byindex


def textgrid_to_tsv(textgrid_path: str, tsv_path: Optional[str] = None) -> str:
    """The first tier of a Praat TextGrid → tsv, empty intervals dropped
    (parity: `Grid2tsv:213-220`). Returns the tsv's path."""
    intervals = _read_textgrid_first_tier(textgrid_path)
    tsv_path = tsv_path or textgrid_path.replace(".TextGrid", ".tsv")
    with open(tsv_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        for xmin, xmax, mark in intervals:
            if mark:
                w.writerow([xmin, xmax, mark])
    return tsv_path


_LONG_INTERVAL = re.compile(
    r"intervals\s*\[\d+\]\s*:?\s*xmin\s*=\s*([\d.eE+-]+)\s*xmax\s*=\s*([\d.eE+-]+)"
    r"\s*text\s*=\s*\"(.*?)\"", re.S)


def _read_textgrid_first_tier(path: str) -> List[Tuple[float, float, str]]:
    """(xmin, xmax, text) intervals of the first tier (the reference reads
    `tg.tiers[0]`). Long format: the chunk after the first `item [k]:` header
    only, so a later phones tier never leaks in; long format without item
    headers: one tier; short format: after the tier header ("IntervalTier",
    name, xmin, xmax, count) the intervals as bare (xmin, xmax, "text")."""
    with open(path, encoding="utf-8", errors="ignore") as f:
        text = f.read()
    tier_chunks = re.split(r"item\s*\[\d+\]\s*:", text)
    if len(tier_chunks) > 1:
        return [(float(a), float(b), m) for a, b, m in _LONG_INTERVAL.findall(tier_chunks[1])]
    matches = _LONG_INTERVAL.findall(text)
    if matches:
        return [(float(a), float(b), m) for a, b, m in matches]
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    out: List[Tuple[float, float, str]] = []
    try:
        ti = next(i for i, ln in enumerate(lines) if "IntervalTier" in ln)
        pos = ti + 5
        for _ in range(int(float(lines[ti + 4]))):
            out.append((float(lines[pos]), float(lines[pos + 1]),
                        lines[pos + 2].strip().strip('"')))
            pos += 3
        return out
    except (StopIteration, ValueError, IndexError):
        raise ValueError(f"unrecognized TextGrid format: {path}") from None


def build_beat_twh_clip(
    bvh_path: str,
    wav: np.ndarray,
    sr: int,
    tsv_path: str,
    word2vector: Dict[str, np.ndarray],
    speaker_onehot: np.ndarray,
    dataset: str = "TWH",
    wavlm_features: Optional[np.ndarray] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """One clip → the store's dict {'speaker_id', 'gesture', 'audio', 'text'}:
    gesture 684-d (BEAT) or 744-d (TWH) from the BVH, the 1133-d audio
    features, the 301-d (BEAT) or 302-d (TWH, laughter flag) text rows, all
    float32 and cropped to the shorter of gesture and audio. `timings`, when
    given, receives the seconds of the BVH parse ('bvh_parse'), of the rest of
    the gesture features ('gesture') and of the audio and text features
    ('audio_text')."""
    if dataset not in ("BEAT", "TWH"):
        raise ValueError(f"dataset must be BEAT or TWH, not {dataset!r}")
    t0 = time.perf_counter()
    data = MP.parse_bvh(bvh_path)
    t1 = time.perf_counter()
    featurize = MP.beat_features if dataset == "BEAT" else MP.twh_features
    gesture, _ = featurize(data)
    t2 = time.perf_counter()
    audio = load_audio_features(wav, sr, wavlm_features)
    clip_len = min(len(gesture), len(audio))
    text = load_tsv(tsv_path, word2vector, clip_len, laughter_flag=dataset == "TWH")
    if timings is not None:
        timings.update(bvh_parse=t1 - t0, gesture=t2 - t1, audio_text=time.perf_counter() - t2)
    return dict(speaker_id=speaker_onehot.astype(np.float32), gesture=gesture[:clip_len],
                audio=audio[:clip_len].astype(np.float32), text=text.astype(np.float32))
