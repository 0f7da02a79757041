"""Audio onsets: the high-frequency-content onset function and essentia's
`Onsets` peak picker, in numpy on the host.

The port's own copy of the onset part of `diffusestylegesture_tpu/audio/
features.py` (`_hann_symmetric`, `hfc_odf`, `_biquad`, `essentia_onsets`,
`detect_onsets`), which `cli/eval.py`'s beat alignment uses. The rest of that
file (prosody, pitch, the BEAT/TWH feature rows) comes with the BEAT/TWH slice
of the port.
"""
from __future__ import annotations

import numpy as np


def _hann_symmetric(n: int) -> np.ndarray:
    """essentia `Windowing` hann: symmetric (N−1 denominator), area-
    normalized then scaled by 2 (windowing.cpp `normalize()`; the scale
    cancels under the ODF max-normalization but is kept for fidelity)."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return w * (2.0 / w.sum())


def hfc_odf(y: np.ndarray, sr: int = 16000, frame: int = 1024, hop: int = 512) -> np.ndarray:
    """High-frequency-content onset detection function per frame.

    essentia semantics (`tool.py:226-238`): `FrameGenerator(frameSize=
    1024, hopSize=512)` with the default startFromZero=false — frame j is
    centered on sample j·hop, the first frame half zero-padded, frames
    emitted while they overlap the signal; symmetric hann; `HFC` type
    "Masri": Σ_i f_i·|X_i|² with f_i the bin frequency in Hz
    (hfc.cpp — the sampleRate parameter exists precisely for this bin→Hz
    conversion; a linear-in-i weighting either way, so it only scales the
    ODF, which downstream max-normalization removes).
    """
    y = np.asarray(y, np.float64)
    half = frame // 2
    # frame j spans [j·hop − half, j·hop + half); emitted while start < len
    n = max(0, int(np.ceil((len(y) + half) / hop)))
    if n == 0:
        return np.zeros(0, np.float64)
    padded = np.pad(y, (half, frame))  # right pad ≥ frame covers the tail
    view = np.lib.stride_tricks.sliding_window_view(padded, frame)[::hop]
    frames = view[:n] * _hann_symmetric(frame)[None, :]
    spec = np.fft.rfft(frames, axis=1)
    mag2 = spec.real**2 + spec.imag**2
    freqs = np.arange(mag2.shape[1]) * (sr / frame)
    return (mag2 * freqs[None, :]).sum(axis=1)


# aubio peakpicker.c biquad low-pass (Brossier's thesis §2.4.3): these
# constants are the published aubio values; essentia's `Onsets` states it
# is based on the aubio implementation.
_AUBIO_B = (0.15998789, 0.31997577, 0.15998789)
_AUBIO_A = (-0.59488894, 0.23484048)  # a1, a2 (a0 = 1)


def _biquad(x: np.ndarray) -> np.ndarray:
    """Direct-form-I biquad with zero initial state (aubio filters the
    7-tap window buffer afresh each frame)."""
    b0, b1, b2 = _AUBIO_B
    a1, a2 = _AUBIO_A
    y = np.empty_like(x, dtype=np.float64)
    x1 = x2 = y1 = y2 = 0.0
    for i, xi in enumerate(x):
        yi = b0 * xi + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        y[i] = yi
        x2, x1 = x1, xi
        y2, y1 = y1, yi
    return y


def essentia_onsets(
    odfs: np.ndarray,
    weights,
    frame_rate: float,
    silence_threshold: float = 0.02,
    alpha: float = 0.1,
    delay: int = 5,
) -> np.ndarray:
    """Onset times (s) from a matrix of onset detection functions —
    a port of essentia `Onsets` (rhythm/onsets.cpp), itself based on the
    aubio/Brossier peak-picker (aubio peakpicker.c):

      1. weighted sum of the ODFs, normalized by the weight sum;
      2. max-normalization (essentia's `silenceThreshold` default 0.02 is
         only meaningful on a normalized function);
      3. per frame j, the window detection[j−delay … j+1] (aubio
         win_post=5=:`delay`, win_pre=1; zeros before the start, matching
         aubio's zero-initialized circular buffer) is biquad-smoothed and
         the "peek" value is proc[j] − median(proc) − alpha·mean(proc);
      4. onset at j when peek is a strictly rising-then-falling local
         maximum above 0 (aubio `peek[1]>0 && peek[0]<peek[1] &&
         peek[1]>peek[2]`) and the normalized ODF somewhere in j's
         thresholding window clears the silence gate (the biquad delays
         a sharp attack ~1 frame past its raw ODF spike, so gating the
         single frame j would reject exactly the sharpest onsets; aubio
         gates on signal-frame dB, which essentia cannot, having only
         the ODF); time = j / frameRate.

    Defaults mirror essentia (alpha 0.1, delay 5, silenceThreshold 0.02);
    the reference calls it with frameRate=16000/512, silenceThreshold=0.04
    (`tool.py:244`).
    """
    odfs = np.atleast_2d(np.asarray(odfs, np.float64))
    weights = np.asarray(weights, np.float64)
    if odfs.shape[0] != len(weights):
        raise ValueError("one weight per detection function required")
    detection = weights @ odfs / weights.sum()
    n = detection.shape[0]
    if n == 0 or detection.max() <= 0:
        return np.zeros(0)
    detection = detection / detection.max()

    win_post, win_pre = delay, 1
    buf_len = win_post + win_pre + 1
    # windows[j] = detection[j-win_post … j+win_pre], zero-padded at edges
    padded = np.concatenate(
        [np.zeros(win_post), detection, np.zeros(win_pre)])
    peek = np.empty(n)
    for j in range(n):
        proc = _biquad(padded[j: j + buf_len])
        peek[j] = proc[win_post] - np.median(proc) - alpha * proc.mean()

    times = []
    for j in range(n):
        prev = peek[j - 1] if j > 0 else 0.0
        nxt = peek[j + 1] if j + 1 < n else 0.0
        if peek[j] > 0 and prev < peek[j] and peek[j] > nxt \
                and padded[j: j + buf_len].max() > silence_threshold:
            times.append(j / frame_rate)
    return np.asarray(times)


def detect_onsets(y: np.ndarray, sr: int = 16000, silence_threshold: float = 0.04) -> np.ndarray:
    """Onset times (s) via HFC ODF + essentia `Onsets` peak-picking,
    with the reference's parameters (`tool.py:226-244`: frameSize 1024,
    hop 512, frameRate sr/512, silenceThreshold 0.04, single ODF with
    weight 1)."""
    odf = hfc_odf(y, sr)
    if len(odf) == 0:
        return np.zeros(0)
    return essentia_onsets(
        odf[None, :], [1.0], frame_rate=sr / 512.0,
        silence_threshold=silence_threshold)
