"""BEAT/TWH per-frame audio features and audio onsets, numpy/scipy on the host.

The port's own copy of `diffusestylegesture_tpu/audio/features.py` (the
reference's `BEAT-TWH-main/process/tool.py`; NFFT=4096, hop=1/30 s, 64 mels,
40 MFCCs, `tool.py:19-22,106-148`):

* `melspectrogram`, `mfcc` and `log_melspectrogram` reproduce librosa's
  stft(center=True, reflect pad, periodic hann) → Slaney mel bank →
  power_to_db(top_db=80) → ortho DCT-II pipeline (librosa itself is not a
  dependency).
* `prosodic_features` follows `extract_prosodic_features` / `compute_prosody`
  (`tool.py:151-217`): pitch and intensity at 1/300 s steps from the
  Boersma-1993 port in `praat_pitch.py`, Chiu-style log normalization, the
  FDM derivative with its 1-sample convolve shift and der[0] = 0, then 10×
  averaging to 30 fps.
* `detect_onsets` / `onset_flags`: the high-frequency-content onset function
  and essentia's `Onsets` peak picker (`tool.py:219-244`), per-motion-frame
  max-pooled flags (`process_TWH_bvh.py:124-131`); `cli/eval.py`'s beat
  alignment uses the onsets too.
"""
from __future__ import annotations

import numpy as np

NFFT = 4096
MFCC_INPUTS = 40
HOP_LENGTH = 1.0 / 30.0
DIM = 64


# ---------------------------------------------------------------------------
# librosa-compatible STFT / mel
# ---------------------------------------------------------------------------


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def stft_power(y: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """|STFT|² with librosa defaults: centered, reflect-padded, periodic
    hann of win_length=n_fft. Returns (1+n_fft/2, n_frames)."""
    y = np.asarray(y, np.float32)
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    # strided view, no index-matrix materialization (an (n_frames, n_fft)
    # int64 gather would cost ~2x the frames themselves on long clips)
    view = np.lib.stride_tricks.sliding_window_view(y, n_fft)[::hop_length]
    frames = view[:n_frames] * _hann_periodic(n_fft)[None, :]
    spec = np.fft.rfft(frames, axis=1)
    return (spec.real**2 + spec.imag**2).T.astype(np.float32)


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-20) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax=None) -> np.ndarray:
    """Slaney-normalized triangular mel bank, librosa layout (n_mels, 1+n_fft/2)."""
    if fmax is None:
        fmax = sr / 2
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz_slaney(
        np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def melspectrogram(y: np.ndarray, sr: int, n_fft: int = NFFT,
                   hop_length=None, n_mels: int = DIM) -> np.ndarray:
    """(n_mels, T) power mel spectrogram (librosa.feature.melspectrogram)."""
    if hop_length is None:
        hop_length = int(HOP_LENGTH * sr)
    S = stft_power(y, n_fft, hop_length)
    return mel_filterbank(sr, n_fft, n_mels) @ S


def power_to_db(S: np.ndarray, amin: float = 1e-10, top_db: float = 80.0) -> np.ndarray:
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def mfcc(y: np.ndarray, sr: int, n_mfcc: int = MFCC_INPUTS, n_fft: int = NFFT,
         hop_length=None, n_mels: int = DIM) -> np.ndarray:
    """(T, n_mfcc) — `calculate_mfcc` (`tool.py:130-148`), pre-transposed.

    librosa.feature.mfcc == ortho DCT-II over power_to_db(melspec)."""
    from scipy.fftpack import dct as scipy_dct

    S = power_to_db(melspectrogram(y, sr, n_fft, hop_length, n_mels))
    return scipy_dct(S, axis=0, type=2, norm="ortho")[:n_mfcc].T.astype(np.float32)


def log_melspectrogram(y: np.ndarray, sr: int, n_fft: int = NFFT,
                       hop_length=None, n_mels: int = DIM) -> np.ndarray:
    """(T, n_mels) — `calculate_spectrogram` (`tool.py:106-127`)."""
    S = melspectrogram(y, sr, n_fft, hop_length, n_mels)
    return np.log(np.abs(S) + 1e-10).T.astype(np.float32)


# ---------------------------------------------------------------------------
# prosody
# ---------------------------------------------------------------------------


def derivative(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """FDM derivative with the reference's exact conventions (`tool.py:24-45`)."""
    x = 1000 * np.asarray(x, np.float64)
    dx = x[1] - x[0]
    cf = np.convolve(f, [1, -1]) / dx
    der = cf[:-1].copy()
    der[0] = 0
    return der


def average(arr: np.ndarray, n: int) -> np.ndarray:
    """Block-mean downsample (`tool.py:93-104`)."""
    end = n * (len(arr) // n)
    return np.mean(arr[:end].reshape(-1, n), 1)


def compute_prosody(y: np.ndarray, sr: int, time_step: float):
    """Chiu-normalized (pitch, energy) tracks (`tool.py:194-217`).

    Pitch/intensity come from the Boersma-1993/praat port in
    `praat_pitch.py` (the algorithms parselmouth wraps natively); sampling
    follows the reference exactly: `get_value_at_time` on an
    `arange(0, duration - time_step, time_step)` grid, NaN→0, then the
    Chiu '11 log normalizations.
    """
    from .praat_pitch import (
        intensity_value_at_time,
        pitch_value_at_time,
        sound_to_intensity,
        sound_to_pitch_ac,
    )

    duration = len(y) / sr
    times = np.arange(0, duration - time_step, time_step)
    ptimes, pfreqs = sound_to_pitch_ac(y, sr, time_step)
    itimes, ivals = sound_to_intensity(y, sr, time_step)
    pitch = np.nan_to_num(pitch_value_at_time(ptimes, pfreqs, times))
    intensity = np.nan_to_num(intensity_value_at_time(itimes, ivals, times))
    intensity = np.clip(intensity, np.finfo(np.float64).eps, None)
    pitch_norm = np.clip(np.log(pitch + 1) - 4, 0, None)
    intensity_norm = np.clip(np.log(intensity) - 3, 0, None)
    return pitch_norm, intensity_norm


def prosodic_features(y: np.ndarray, sr: int) -> np.ndarray:
    """(T, 4): energy, energy', pitch, pitch' at 30 fps (`tool.py:151-191`)."""
    time_step = HOP_LENGTH / 10
    pitch, energy = compute_prosody(y, sr, time_step)
    duration = len(y) / sr
    t = np.arange(0, duration, time_step)[: len(pitch)]
    energy_der = derivative(t, energy)
    pitch_der = derivative(t, pitch)
    energy = average(energy, 10)
    energy_der = average(energy_der, 10)
    pitch = average(pitch, 10)
    pitch_der = average(pitch_der, 10)
    min_size = min(len(energy), len(energy_der), len(pitch), len(pitch_der))
    return np.stack(
        [energy[:min_size], energy_der[:min_size], pitch[:min_size], pitch_der[:min_size]]
    ).T.astype(np.float32)


# ---------------------------------------------------------------------------
# onsets
# ---------------------------------------------------------------------------


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


def onset_flags(y: np.ndarray, sr: int, n_frames: int) -> np.ndarray:
    """Per-motion-frame binary onset flags (`process_TWH_bvh.py:124-131`)."""
    onsets = detect_onsets(y, sr)
    silence = np.zeros(len(y))
    if len(onsets):
        silence[np.clip(onsets * sr, 0, len(y) - 1).astype(np.int64)] = 1
    xp = np.linspace(0, len(y) - 1, num=n_frames + 1)
    flags = np.zeros(n_frames)
    for i in range(1, n_frames + 1):
        seg = silence[int(xp[i - 1]): int(xp[i])]
        flags[i - 1] = float(len(seg) and seg.max() == 1)
    return flags
