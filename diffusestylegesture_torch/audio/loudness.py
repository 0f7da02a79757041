"""EBU R128 / ITU-R BS.1770-4 loudness measurement and normalization.

The port's own copy of `diffusestylegesture_tpu/audio/loudness.py` (the port
imports nothing of the JAX package), used by `cli/sample.py
--normalize_loudness`.

The reference shells out to `ffmpeg-normalize` before feature extraction
(`main/mydiffusion_zeggs/zeggs_data_to_lmdb.py:133`, `sample.py:349-356`),
whose default mode is EBU R128 loudness normalization. This module
implements the underlying standard natively so the pipeline has no ffmpeg
dependency:

  * K-weighting prefilter — stage-1 high-shelf (+4 dB, fc 1681.97 Hz,
    Q 1/√2) and stage-2 high-pass (fc 38.135 Hz, Q 0.5), designed for the
    actual sample rate from the analog prototypes; at 48 kHz the
    coefficients reproduce BS.1770-4 Tables 1–2 (test-asserted);
  * gated integrated loudness — 400 ms blocks, 75 % overlap, −70 LUFS
    absolute gate then −10 LU relative gate (BS.1770-4 §4.2);
  * 4× oversampled true-peak (Annex 2);
  * `normalize_loudness` — linear gain to the target (ffmpeg-normalize
    target: −23 LUFS) with a true-peak ceiling. This equals ffmpeg's
    two-pass `loudnorm` in its linear mode; ffmpeg's *dynamic* mode
    (time-varying gain) is intentionally not reproduced.

Mono (the gesture pipelines are mono-16 kHz); host-side NumPy/SciPy — a
data-prep pass that runs before any device work.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import lfilter, resample_poly


def _high_shelf(fs: float, gain_db: float = 3.999843853973347,
                fc: float = 1681.9744509555319, q: float = 0.7071752369554196):
    """BS.1770 stage-1 shelf, De Man's analog-prototype parametrization
    ("Evaluation of Implementations of the EBU R128 Loudness Measurement",
    AES 2014 — the derivation pyloudnorm uses): bilinear transform with
    K = tan(π·fc/fs), reproducing the 48 kHz spec table to 1e-6."""
    K = np.tan(np.pi * fc / fs)
    Vh = 10.0 ** (gain_db / 20.0)
    Vb = Vh ** 0.4996667741545416
    d = 1.0 + K / q + K * K
    b0 = (Vh + Vb * K / q + K * K) / d
    b1 = 2.0 * (K * K - Vh) / d
    b2 = (Vh - Vb * K / q + K * K) / d
    a1 = 2.0 * (K * K - 1.0) / d
    a2 = (1.0 - K / q + K * K) / d
    return np.array([b0, b1, b2]), np.array([1.0, a1, a2])


def _high_pass(fs: float, fc: float = 38.13547087602444, q: float = 0.5003270373238773):
    """BS.1770 stage-2 high-pass. The spec deliberately uses the
    UN-normalized numerator b = [1, −2, 1] (Table 2)."""
    K = np.tan(np.pi * fc / fs)
    d = 1.0 + K / q + K * K
    a1 = 2.0 * (K * K - 1.0) / d
    a2 = (1.0 - K / q + K * K) / d
    return np.array([1.0, -2.0, 1.0]), np.array([1.0, a1, a2])


def k_weighting_coeffs(fs: float):
    """((b1, a1), (b2, a2)) for the two K-weighting stages at `fs`."""
    return _high_shelf(fs), _high_pass(fs)


def k_weight(y: np.ndarray, fs: float) -> np.ndarray:
    (b1, a1), (b2, a2) = k_weighting_coeffs(fs)
    return lfilter(b2, a2, lfilter(b1, a1, np.asarray(y, np.float64)))


def integrated_loudness(y: np.ndarray, fs: float) -> float:
    """Gated integrated loudness in LUFS (BS.1770-4 §4; mono weight 1.0).

    Returns -inf for silence / audio shorter than one 400 ms block.
    """
    z = k_weight(y, fs)
    block = int(round(0.4 * fs))
    hop = block // 4  # 75 % overlap
    if len(z) < block:
        return float("-inf")
    # strided view, not a gathered index matrix: O(1) extra memory even
    # for hours-long recordings
    power = np.lib.stride_tricks.sliding_window_view(z * z, block)[::hop].mean(axis=1)
    with np.errstate(divide="ignore"):
        l_blocks = -0.691 + 10.0 * np.log10(power)
    above_abs = power[l_blocks > -70.0]
    if len(above_abs) == 0:
        return float("-inf")
    rel_gate = -0.691 + 10.0 * np.log10(above_abs.mean()) - 10.0
    keep = power[(l_blocks > -70.0) & (l_blocks > rel_gate)]
    if len(keep) == 0:
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(keep.mean()))


def true_peak_db(y: np.ndarray, fs: float) -> float:
    """True peak in dBTP (Annex 2). The spec's 4× factor assumes 48 kHz
    material (192 kHz measurement rate); oversample to ≥192 kHz whatever
    the input rate (12× at 16 kHz), matching ffmpeg loudnorm."""
    factor = max(4, int(np.ceil(192000.0 / fs)))
    over = resample_poly(np.asarray(y, np.float64), factor, 1)
    peak = np.max(np.abs(over)) if len(over) else 0.0
    if peak <= 0:
        return float("-inf")
    return float(20.0 * np.log10(peak))


def normalize_loudness(y: np.ndarray, fs: float, target_lufs: float = -23.0,
                       true_peak_ceiling_db: float = -2.0) -> np.ndarray:
    """Linear-gain EBU R128 normalization (ffmpeg-normalize defaults:
    I=-23 LUFS, TP=-2 dBTP). Gain is reduced if it would push the 4×
    oversampled true peak above the ceiling. Silence passes through."""
    loud = integrated_loudness(y, fs)
    if not np.isfinite(loud):
        return np.asarray(y, np.float32)
    gain_db = target_lufs - loud
    tp = true_peak_db(y, fs)
    if np.isfinite(tp):
        gain_db = min(gain_db, true_peak_ceiling_db - tp)
    return (np.asarray(y, np.float64) * 10.0 ** (gain_db / 20.0)).astype(np.float32)
