"""ZeroEGGS data-pipeline essentials (port of `diffusestylegesture_tpu/data/zeroeggs_data.py`).

Functional counterparts of `ubisoft-laforge-ZeroEGGS-main/ZEGGS/
data_pipeline.py` + `dataset.py` for the ported RNN system:

  * `audio_features` ↔ `preprocess_audio:33-86`: log-mel spectrogram
    (optional pre-emphasis) + per-frame energy, linearly resampled from the
    hop rate to the animation frame rate, on the port's `audio/features.py`
    mel machinery (the reference's TTS-grade mel extractor exposes more
    normalization knobs; this keeps the default mel → log → frame-rate
    shape, as the JAX module does);
  * `window_index` ↔ `SGDataset.__init__`'s window building
    (`dataset.py:79-97`): every (start … start+window) index row per labelled
    range, with one-hot labels and sample ids;
  * `feature_statistics` ↔ the pipeline's input / output mean-std (the
    stats.npz fields).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..audio import features as AF


def audio_features(audio: np.ndarray, sr: int, anim_fs: float, anim_length: int,
                   n_mels: int = 80, n_fft: int = 1024, hop_length: int = 256,
                   pre_emphasis: bool = True, pre_emph_coeff: float = 0.97,
                   include_energy: bool = True) -> np.ndarray:
    """(anim_length, n_mels [+1]) log-mel (+ energy) at the motion rate."""
    y = np.asarray(audio, np.float32)
    if pre_emphasis:
        y = np.concatenate([y[:1], y[1:] - pre_emph_coeff * y[:-1]])
    mel = AF.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
    log_mel = np.log(np.maximum(np.sqrt(np.maximum(mel, 0.0)), 1e-5)).T  # (T', n_mels)

    hop_rate = sr / hop_length
    dst_t = np.clip((hop_rate / anim_fs) * np.arange(anim_length), 0, len(log_mel) - 1)
    lo = np.floor(dst_t).astype(int)
    hi = np.minimum(lo + 1, len(log_mel) - 1)
    w = (dst_t - lo)[:, None]
    feats = [log_mel[lo] * (1 - w) + log_mel[hi] * w]
    if include_energy:
        energy = np.linalg.norm(np.exp(log_mel), axis=1)
        feats.append((energy[lo] * (1 - w[:, 0]) + energy[hi] * w[:, 0])[:, None])
    return np.concatenate(feats, axis=1).astype(np.float32)


def window_index(ranges: Sequence[Tuple[int, int]], range_labels: Sequence[int], nlabels: int,
                 window: int):
    """(R, L, S) window rows, one-hot labels, sample ids (`dataset.py:79-97`)."""
    R: List[np.ndarray] = []
    L: List[np.ndarray] = []
    S: List[int] = []
    for sample_number, ((start, end), label) in enumerate(zip(ranges, range_labels)):
        onehot = np.zeros(nlabels, np.float32)
        onehot[label] = 1.0
        for ri in range(start, end - window):
            R.append(np.arange(ri, ri + window))
            L.append(onehot)
            S.append(sample_number)
    return np.asarray(R, np.int64), np.asarray(L, np.float32), np.asarray(S, np.int16)


def feature_statistics(arrays: Dict[str, np.ndarray], eps: float = 1e-8) -> Dict[str, np.ndarray]:
    """{name: (T, D)} → {name_mean, name_std} (the stats.npz layout)."""
    out = {}
    for name, arr in arrays.items():
        out[f"{name}_mean"] = arr.mean(axis=0).astype(np.float32)
        out[f"{name}_std"] = (arr.std(axis=0) + eps).astype(np.float32)
    return out
