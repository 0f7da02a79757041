"""CMU Sphinx-III MFCC with log energy, in numpy float64.

Port of `diffusestylegesture_tpu/audio/sphinx_mfcc.py` (reference
`main/mydiffusion_zeggs/mfcc.py:24-237`): 40-filter mel bank on rounded
DFT-bin edges, Hamming window, pre-emphasis 0.97 with the prior sample
carried across frames, the legacy s2dct cepstral transform, log-energy and
frame-midpoint-time channels. The reference's quirks stay: a short tail
frame is extended with `numpy.resize` (a cyclic repeat, `mfcc.py:112-115`),
and the pre-emphasis prior of frame i is the last sample of frame i-1.
"""
from __future__ import annotations

import numpy as np


def mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def melinv(m):
    return 700.0 * (np.power(10.0, m / 2595.0) - 1.0)


def sphinx_filterbank(nfilt: int = 40, nfft: int = 512, samprate: float = 16000,
                      lowerf: float = 133.3333, upperf: float = 6855.4976) -> np.ndarray:
    """(nfft//2+1, nfilt) triangular filters (`mfcc.py:55-92`)."""
    filters = np.zeros((nfft // 2 + 1, nfilt), "d")
    dfreq = samprate / nfft
    melmax, melmin = mel(upperf), mel(lowerf)
    dmelbw = (melmax - melmin) / (nfilt + 1)
    filt_edge = melinv(melmin + dmelbw * np.arange(nfilt + 2, dtype="d"))
    for which in range(nfilt):
        leftfr = round(filt_edge[which] / dfreq)
        centerfr = round(filt_edge[which + 1] / dfreq)
        rightfr = round(filt_edge[which + 2] / dfreq)
        fwidth = (rightfr - leftfr) * dfreq
        height = 2.0 / fwidth
        leftslope = height / (centerfr - leftfr) if centerfr != leftfr else 0
        freq = int(leftfr) + 1
        while freq < centerfr:
            filters[freq, which] = (freq - leftfr) * leftslope
            freq += 1
        if freq == centerfr:
            filters[freq, which] = height
            freq += 1
        if centerfr != rightfr:
            rightslope = height / (centerfr - rightfr)
            while freq < rightfr:
                filters[freq, which] = (freq - rightfr) * rightslope
                freq += 1
    return filters


def s2dctmat(nfilt: int, ncep: int) -> np.ndarray:
    """The legacy Sphinx not-quite-DCT (`mfcc.py:176-183`)."""
    melcos = np.empty((ncep, nfilt), "double")
    for i in range(ncep):
        freq = np.pi * float(i) / nfilt
        melcos[i] = np.cos(freq * np.arange(0.5, float(nfilt) + 0.5, 1.0, "double"))
    melcos[:, 0] *= 0.5
    return melcos


def _frames(sig: np.ndarray, wlen: int, fshift: float):
    """Frame matrix with the reference's cyclic tail resize."""
    nfr = int(len(sig) / fshift + 1)
    frames = np.zeros((nfr, wlen), "d")
    starts = np.empty(nfr, np.int64)
    ends = np.empty(nfr, np.int64)
    for fr in range(nfr):
        start = int(round(fr * fshift))
        end = min(len(sig), start + wlen)
        frame = sig[start:end]
        if len(frame) < wlen:
            frame = np.resize(frame, wlen)
        frames[fr] = frame
        starts[fr], ends[fr] = start, end
    return frames, starts, ends


def sphinx_mfcc_energy(sig: np.ndarray, *, nfilt: int = 40, ncep: int = 13,
                       lowerf: float = 133.3333, upperf: float = 6855.4976,
                       alpha: float = 0.97, samprate: float = 16000, frate: float = 100,
                       wlen_sec: float = 0.0256, nfft: int = 512) -> np.ndarray:
    """(n_frames, ncep+2): [cepstra | log-energy | mid-time]
    (`MFCC.sig2s2mfc_energy`, `mfcc.py:155-174`)."""
    fshift = float(samprate) / frate
    wlen = int(wlen_sec * samprate)
    win = np.hamming(wlen)
    filters = sphinx_filterbank(nfilt, nfft, samprate, lowerf, upperf)
    s2dct = s2dctmat(nfilt, ncep)

    frames, starts, ends = _frames(np.asarray(sig, "d"), wlen, fshift)
    nfr = frames.shape[0]

    # pre-emphasis with the chained prior: prior[i] = frames[i-1][-1], prior[0] = 0
    priors = np.concatenate([[0.0], frames[:-1, -1]])
    emph = frames - alpha * np.concatenate([priors[:, None], frames[:, :-1]], axis=1)

    spec = np.fft.rfft(emph * win, nfft, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    logspec = np.log(np.clip(power @ filters, 1e-5, np.inf))
    ceps = (logspec @ s2dct.T) / nfilt

    out = np.zeros((nfr, ncep + 2), "d")
    out[:, :-2] = ceps
    out[:, -2] = np.log(1 + np.mean(frames ** 2, axis=1))
    out[:, -1] = 0.5 * (starts + ends - 1) / samprate
    return out
