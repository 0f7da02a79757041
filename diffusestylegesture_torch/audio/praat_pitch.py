"""Praat-faithful pitch (Boersma 1993 AC method) and intensity tracks, numpy.

The port's own copy of `diffusestylegesture_tpu/audio/praat_pitch.py` (the
port imports nothing of the JAX package). The reference extracts its 4
prosody channels through praat-parselmouth (`BEAT-TWH-main/process/
tool.py:194-217`): `Sound.to_pitch(time_step)` / `Sound.to_intensity(time_step)`
followed by `get_value_at_time`. parselmouth wraps praat's native C++; this
module is a from-the-paper port of the same algorithms (P. Boersma, "Accurate
short-term analysis of the fundamental frequency and the
harmonics-to-noise ratio of a sampled sound", IFA Proceedings 17, 1993):

  * per-frame local-mean subtraction, Hanning window,
  * FFT autocorrelation normalized by the window's own autocorrelation
    (the paper's key step: r_x(tau) ~= r_xw(tau) / r_w(tau)),
  * candidate maxima with parabolic lag refinement + sinc-interpolated
    strength,
  * unvoiced-candidate strength from local/global peak ratio,
  * Viterbi path over candidates with praat's default octave,
    octave-jump, and voiced/unvoiced costs,
  * praat's centered frame timing (Sampled_shortTermAnalysis).

Intensity follows praat's Sound_to_Intensity: Kaiser window (beta ~ 20.24,
praat's "Kaiser-20": -190 dB sidelobes) of physical duration
6.4/minimum_pitch, window-weighted mean-pressure subtraction, and
10*log10(p2/4e-10) with praat's auditory reference 2e-5 Pa.

Praat defaults used (Sound_to_Pitch_ac): floor 75 Hz, ceiling 600 Hz,
periods_per_window 3, silence_threshold 0.03, voicing_threshold 0.45,
octave_cost 0.01, octave_jump_cost 0.35, voiced_unvoiced_cost 0.14,
max_candidates 15.

Known residual deviations from parselmouth (documented, not testable
in-env — parselmouth is not installed): praat upsamples the sinc
interpolation of candidate strengths to depth 30 while this port sinc-
interpolates on a 16x-refined local grid, and praat's Gaussian window
variant (very accurate mode) is not used by the reference call. Both
affect the 4 prosody dims at the ~1e-3 level after the Chiu log
normalization and 10x block averaging.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PitchConfig:
    floor: float = 75.0
    ceiling: float = 600.0
    periods_per_window: float = 3.0
    max_candidates: int = 15
    silence_threshold: float = 0.03
    voicing_threshold: float = 0.45
    octave_cost: float = 0.01
    octave_jump_cost: float = 0.35
    voiced_unvoiced_cost: float = 0.14


def _frame_times(duration: float, window_dur: float, time_step: float):
    """Praat's Sampled_shortTermAnalysis: centered frame sequence."""
    n = int(np.floor((duration - window_dur) / time_step)) + 1
    if n < 1:
        return np.zeros(0)
    mid = duration / 2.0
    t1 = mid - 0.5 * (n - 1) * time_step
    return t1 + time_step * np.arange(n)


def _sinc_interp_max(r: np.ndarray, k: int, refine: int = 16, half_width: int = 8):
    """Refine the local maximum of r around integer lag k by windowed-sinc
    interpolation on a refine x denser grid; returns (lag, value)."""
    lo = max(1, k - 1)
    hi = min(len(r) - 2, k + 1)
    grid = np.linspace(lo, hi, (hi - lo) * refine + 1)
    i0 = np.maximum(0, k - half_width)
    i1 = np.minimum(len(r), k + half_width + 1)
    idx = np.arange(i0, i1)
    # windowed sinc (Hann taper over the support)
    x = grid[:, None] - idx[None, :]
    w = np.sinc(x) * (0.5 + 0.5 * np.cos(np.pi * x / half_width))
    vals = w @ r[i0:i1]
    j = int(np.argmax(vals))
    return float(grid[j]), float(vals[j])


def sound_to_pitch_ac(
    y: np.ndarray, sr: int, time_step: float, cfg: PitchConfig = PitchConfig()
):
    """→ (frame_times, frequencies) with 0 Hz for unvoiced frames.

    Boersma 1993 §3 (candidate generation) + §4 (Viterbi path finding).
    """
    y = np.asarray(y, np.float64)
    duration = len(y) / sr
    window_dur = cfg.periods_per_window / cfg.floor
    win = int(round(window_dur * sr))
    if win % 2 == 1:
        win += 1  # praat uses an even number of samples per window
    half = win // 2

    times = _frame_times(duration, window_dur, time_step)
    nf = len(times)
    freqs = np.zeros(nf)
    if nf == 0:
        return times, freqs

    global_peak = np.abs(y - y.mean()).max() + 1e-300

    lag_min = int(np.floor(sr / cfg.ceiling))
    lag_max = int(np.ceil(sr / cfg.floor))
    lag_max = min(lag_max, win - 1)

    # window autocorrelation (normalized), shared across frames
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(win) + 0.5) / win)
    nfft = 1
    while nfft < win * 2:
        nfft *= 2
    fw = np.fft.rfft(hann, nfft)
    rw = np.fft.irfft(fw * np.conj(fw))[: lag_max + 2]
    rw = rw / rw[0]

    # --- candidate generation per frame ---
    cand_freq = np.zeros((nf, cfg.max_candidates))  # [i,0] = unvoiced
    cand_str = np.full((nf, cfg.max_candidates), -1e30)

    for i, t in enumerate(times):
        mid = int(round(t * sr))
        lo = mid - half
        seg = np.zeros(win)
        s0, s1 = max(0, lo), min(len(y), lo + win)
        seg[s0 - lo : s1 - lo] = y[s0:s1]
        local_mean = seg.mean()
        seg = (seg - local_mean) * hann
        local_peak = np.abs(seg).max()

        # unvoiced candidate strength (Boersma eq. 23)
        cand_freq[i, 0] = 0.0
        cand_str[i, 0] = cfg.voicing_threshold + max(
            0.0,
            2.0
            - (local_peak / global_peak)
            / (cfg.silence_threshold / (1.0 + cfg.voicing_threshold)),
        )

        if local_peak == 0.0:
            continue
        fx = np.fft.rfft(seg, nfft)
        r = np.fft.irfft(fx * np.conj(fx))[: lag_max + 2]
        if r[0] <= 0:
            continue
        r = r / r[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(np.abs(rw) > 1e-12, r / rw, 0.0)

        # local maxima in [lag_min, lag_max]
        ncand = 1
        order = []
        for k in range(max(2, lag_min), lag_max):
            if r[k] > r[k - 1] and r[k] >= r[k + 1] and r[k] > 0.0:
                order.append(k)
        # strongest maxima first, praat keeps max_candidates-1 voiced ones
        order.sort(key=lambda k: -r[k])
        for k in order[: cfg.max_candidates - 1]:
            lag, val = _sinc_interp_max(r, k)
            f = sr / lag
            if f >= cfg.ceiling or f < cfg.floor / 2:
                continue
            if val > 1.0:
                # praat Sound_to_Pitch.cpp: strengths above 1 (short-window
                # artifacts) are REFLECTED around 1, not clamped
                val = 1.0 / val
            # Boersma eq. 24: R = r - OctaveCost * log2(MinimumPitch * tau)
            strength = val - cfg.octave_cost * np.log2(cfg.floor * lag / sr)
            cand_freq[i, ncand] = f
            cand_str[i, ncand] = strength
            ncand += 1
            if ncand == cfg.max_candidates:
                break

    # --- Viterbi path (Boersma eq. 25) ---
    # praat Pitch.cpp Pitch_pathFinder: transition costs are defined per
    # 0.01 s and scaled by timeStepCorrection = 0.01/dx for the actual
    # frame step (3x at our 1/300 s hop)
    tsc = 0.01 / time_step
    octave_jump_cost = cfg.octave_jump_cost * tsc
    voiced_unvoiced_cost = cfg.voiced_unvoiced_cost * tsc
    ncand = cfg.max_candidates
    delta = cand_str[0].copy()
    psi = np.zeros((nf, ncand), np.int32)
    for i in range(1, nf):
        prev_f = cand_freq[i - 1]
        cur_f = cand_freq[i]
        trans = np.zeros((ncand, ncand))
        prev_uv = prev_f == 0.0
        cur_uv = cur_f == 0.0
        both_voiced = (~prev_uv)[:, None] & (~cur_uv)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            jump = np.abs(
                np.log2(np.where(prev_f[:, None] == 0, 1, prev_f[:, None]))
                - np.log2(np.where(cur_f[None, :] == 0, 1, cur_f[None, :]))
            )
        trans = np.where(
            both_voiced,
            octave_jump_cost * jump,
            np.where(
                prev_uv[:, None] == cur_uv[None, :],  # uv→uv
                0.0,
                voiced_unvoiced_cost,
            ),
        )
        scores = delta[:, None] - trans + cand_str[i][None, :]
        psi[i] = np.argmax(scores, axis=0)
        delta = scores[psi[i], np.arange(ncand)]

    path = np.zeros(nf, np.int32)
    path[-1] = int(np.argmax(delta))
    for i in range(nf - 2, -1, -1):
        path[i] = psi[i + 1][path[i + 1]]
    freqs = cand_freq[np.arange(nf), path]
    return times, freqs


def pitch_value_at_time(times: np.ndarray, freqs: np.ndarray, t) -> np.ndarray:
    """Praat Pitch get_value_at_time (linear interpolation, NaN when either
    bracketing frame is unvoiced or t is outside the analysis span)."""
    t = np.atleast_1d(np.asarray(t, np.float64))
    out = np.full(t.shape, np.nan)
    if len(times) == 0:
        return out
    idx = np.searchsorted(times, t)
    for j, (tt, i) in enumerate(zip(t, idx)):
        if i == 0:
            # praat extrapolates the edge frame's value within half a step
            out[j] = freqs[0] if freqs[0] > 0 else np.nan
        elif i >= len(times):
            out[j] = freqs[-1] if freqs[-1] > 0 else np.nan
        else:
            f0, f1 = freqs[i - 1], freqs[i]
            if f0 > 0 and f1 > 0:
                w = (tt - times[i - 1]) / (times[i] - times[i - 1])
                out[j] = f0 + w * (f1 - f0)
            elif f0 > 0 or f1 > 0:
                # praat returns the voiced neighbor when t rounds to it
                near = f0 if (tt - times[i - 1]) <= (times[i] - tt) else f1
                out[j] = near if near > 0 else np.nan
    return out


# ---------------------------------------------------------------------------
# intensity
# ---------------------------------------------------------------------------

KAISER20_BETA = 20.24  # praat's "Kaiser-20": first sidelobe at -190 dB


def sound_to_intensity(
    y: np.ndarray, sr: int, time_step: float, minimum_pitch: float = 100.0
):
    """Praat Sound_to_Intensity → (frame_times, dB values).

    Physical window = 6.4/minimum_pitch (effective 3.2/min_pitch), Kaiser
    window, window-weighted DC removal, ref 4e-10 Pa^2 (2e-5 Pa)^2.
    """
    from scipy.signal.windows import kaiser

    y = np.asarray(y, np.float64)
    duration = len(y) / sr
    window_dur = 6.4 / minimum_pitch
    win = int(round(window_dur * sr))
    if win % 2 == 1:
        win += 1
    half = win // 2
    w = kaiser(win, KAISER20_BETA)
    wsum = w.sum()

    times = _frame_times(duration, window_dur, time_step)
    out = np.zeros(len(times))
    for i, t in enumerate(times):
        mid = int(round(t * sr))
        lo = mid - half
        seg = np.zeros(win)
        s0, s1 = max(0, lo), min(len(y), lo + win)
        seg[s0 - lo : s1 - lo] = y[s0:s1]
        mean_p = (seg * w).sum() / wsum
        p2 = ((seg - mean_p) ** 2 * w).sum() / wsum
        out[i] = 10.0 * np.log10(max(p2, 1e-300) / 4e-10)
    return times, out


def intensity_value_at_time(times: np.ndarray, vals: np.ndarray, t) -> np.ndarray:
    """Praat Intensity get_value (cubic interpolation between frames)."""
    t = np.atleast_1d(np.asarray(t, np.float64))
    out = np.full(t.shape, np.nan)
    n = len(times)
    if n == 0:
        return out
    if n == 1:
        out[:] = vals[0]
        return out
    dt = times[1] - times[0]
    x = (t - times[0]) / dt  # fractional frame index
    for j, xx in enumerate(x):
        i = int(np.floor(xx))
        if i < 0:
            out[j] = vals[0]
            continue
        if i >= n - 1:
            out[j] = vals[-1]
            continue
        frac = xx - i
        # praat's NUM_interpolate cubic (Catmull-Rom style on 4 points);
        # virtual edge points are linearly extrapolated so the scheme stays
        # exact on linear data at the boundaries
        p1, p2 = vals[i], vals[i + 1]
        p0 = vals[i - 1] if i > 0 else 2 * p1 - p2
        p3 = vals[i + 2] if i + 2 < n else 2 * p2 - p1
        out[j] = p1 + 0.5 * frac * (
            p2
            - p0
            + frac * (2 * p0 - 5 * p1 + 4 * p2 - p3 + frac * (3 * (p1 - p2) + p3 - p0))
        )
    return out
