"""BEAT/TWH per-frame audio features for the serving CLI's live path.

Port of `diffusestylegesture_tpu/data/beat_twh.py::load_audio_features`
(reference `load_audio`, `process_TWH_bvh.py:100-132`): the 1133-d per-frame
audio vector [MFCC-40 | log-mel-64 | prosody-4 | WavLM-1024 interpolated |
onset-1], cropped to the shortest of the host features. The rest of that
file (metadata, TextGrid → tsv, the h5 clip assembly) belongs to data
preparation and is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..audio import features as AF
from ..models.wavlm.model import interpolate_linear


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
