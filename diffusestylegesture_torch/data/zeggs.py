"""ZEGGS audio input (port of `diffusestylegesture_tpu/data/zeggs.py::load_wav_16k`).
The windowed training dataset comes with the training slice."""
from __future__ import annotations

import math

import numpy as np


def load_wav_16k(path: str) -> np.ndarray:
    """Read a wav file as float32 mono 16 kHz (scipy backend)."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != 16000:
        g = math.gcd(int(sr), 16000)
        data = resample_poly(data, 16000 // g, sr // g).astype(np.float32)
    return data
