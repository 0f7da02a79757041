"""Windowed long-form ZEGGS gesture generation.

Port of `diffusestylegesture_tpu/sample/engine.py::ZeggsSampler` (reference
`main/mydiffusion_zeggs/sample.py:210-338`): the audio is cut into
⌊T/(n_poses−n_seed)⌋ windows, each with an n_seed-frame audio prefix (zeros
for window 0, the previous window's tail otherwise); WavLM runs ONCE over
all windows; each window then runs the reverse-diffusion loop with the
carried seed, the root-translation delta correction (`:269-282`) and the
crossfade over the n_seed overlap (`:284-288`); the result is trimmed and
un-normalized. The window loop is a Python loop here (a `lax.scan` in the
JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import (
    SamplerConfig,
    Schedule,
    ddim_sample_loop,
    dpmpp2m_sample_loop,
    make_cfg_model_fn,
    p_sample_loop,
    plms_sample_loop,
)

SAMPLE_LOOPS = {
    "ddpm": p_sample_loop,
    "ddim": ddim_sample_loop,
    "plms": plms_sample_loop,
    "dpmpp": dpmpp2m_sample_loop,
}


def unnormalize_poses(seq, mean, std):
    """std clipped at 0.01 (ref `sample.py:320-326`), then mean added.
    `seq` is a numpy array or a tensor; mean/std are numpy."""
    def like(a):
        a = np.asarray(a, np.float32).squeeze()
        return torch.as_tensor(a, device=seq.device) if torch.is_tensor(seq) else a

    if std is not None:
        seq = seq * like(np.clip(np.asarray(std).squeeze(), 0.01, None))
    if mean is not None:
        seq = seq + like(mean)
    return seq


def crossfade_weights(n_seed: int, batch: int, crossfade_n):
    """Linear crossfade weights over the n_seed overlap frames, numpy (n_seed,).

    `crossfade_n=None` keeps the reference quirk: its blend loop runs over
    the BATCH axis (`sample.py:284-288`), so n = batch.
    """
    n = batch if crossfade_n is None else int(crossfade_n)
    j = np.arange(n_seed, dtype=np.float32)
    wa = np.where(j < n, (n - j) / (n + 1), 0.0).astype(np.float32)
    wb = np.where(j < n, (j + 1) / (n + 1), 1.0).astype(np.float32)
    return wa, wb


@dataclasses.dataclass(frozen=True)
class ZeggsEngineConfig:
    n_poses: int = 88
    n_seed: int = 8
    njoints: int = 1141
    fps: int = 20
    sr: int = 16000
    guidance_scale: float = 0.0  # 0 → plain conditional (reference default)
    # None replicates the reference's batch-axis crossfade quirk; an int
    # crossfades linearly over that many overlap frames
    crossfade_n: Optional[int] = None
    root_delta_correction: bool = True
    sampler: str = "ddpm"  # ddpm | ddim | plms | dpmpp
    skip_timesteps: int = 0

    @property
    def stride(self) -> int:
        return self.n_poses - self.n_seed

    @property
    def samples_per_stride(self) -> int:
        return int(self.stride * self.sr / self.fps)

    @property
    def samples_per_seed(self) -> int:
        return int(self.n_seed * self.sr / self.fps)


def slice_audio_windows(audio: np.ndarray, cfg: ZeggsEngineConfig) -> np.ndarray:
    """Raw 16 kHz audio → (num_windows, seed_pad + stride) samples; window i =
    [tail of window i−1 (zeros for i = 0) | own stride] (`sample.py:233-248`)."""
    sps, spd = cfg.samples_per_stride, cfg.samples_per_seed
    num = len(audio) // sps
    main = audio[: num * sps].reshape(num, sps)
    prev_tails = np.zeros((num, spd), dtype=audio.dtype)
    prev_tails[1:] = main[:-1, -spd:]
    return np.concatenate([prev_tails, main], axis=1)


class ZeggsSampler:
    """Long-form ZEGGS sampler.

    model_apply: (params, x, t, cond, uncond=None) → x0 prediction, where
      `params` is what `generate` receives (the `MDM` module).
    wavlm_apply: (wavlm_params, windows (W, S)) → (W, n_poses, 1024)
      features at the motion rate (`make_zeggs_wavlm_fn`).
    schedule: diffusion `Schedule`, on `device`.
    """

    def __init__(self, model_apply: Callable, wavlm_apply: Callable, schedule: Schedule,
                 cfg: ZeggsEngineConfig = ZeggsEngineConfig(),
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if schedule.device != self.device:
            raise ValueError(f"schedule lives on {schedule.device}, engine on {self.device}")
        if cfg.sampler not in SAMPLE_LOOPS:
            raise ValueError(f"unknown sampler {cfg.sampler!r} ({sorted(SAMPLE_LOOPS)})")
        self.model_apply = model_apply
        self.wavlm_apply = wavlm_apply
        self.schedule = schedule
        self.cfg = cfg
        self.sampler_cfg = sampler_cfg

    def _window_sample(self, params, generator, feats, seed, style, noise=None):
        """One n_poses window: the reverse-diffusion loop under seed/style/audio."""
        cfg = self.cfg
        B = style.shape[0]
        cond = {
            "style": style,
            "seed": seed,
            "audio": feats[None].expand((B,) + tuple(feats.shape)),
            "mask_local": torch.ones((B, cfg.n_poses), dtype=torch.bool, device=self.device),
        }
        if cfg.guidance_scale and cfg.guidance_scale != 1.0:
            model_fn = make_cfg_model_fn(self.model_apply, cfg.guidance_scale, B,
                                         params=params, cond=cond)
        else:
            def model_fn(x, t):
                return self.model_apply(params, x, t, cond)

        shape = (B, cfg.njoints, 1, cfg.n_poses)
        return SAMPLE_LOOPS[cfg.sampler](self.schedule, model_fn, shape, generator,
                                         cfg=self.sampler_cfg, noise=noise,
                                         skip_timesteps=cfg.skip_timesteps)

    @torch.inference_mode()
    def generate(self, params, wavlm_params, audio: np.ndarray, style: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 noise_windows: Optional[np.ndarray] = None,
                 window_buckets: Optional[tuple] = None, device_out: bool = False):
        """audio (1-D 16 kHz, or already-sliced (W, S) windows) →
        (B, T_frames, njoints) un-normalized poses, numpy (a tensor on the
        device with `device_out=True`).

        `noise_windows` (W, B, njoints, 1, n_poses) injects each window's x_T.
        `window_buckets` pads the window count up to the next bucket with
        zero audio for the encoder batch; padded windows are causally
        downstream of the real ones, so they are not sampled and the output
        is that of the unpadded run.
        """
        cfg = self.cfg
        dev = self.device
        audio = np.asarray(audio, np.float32)
        windows = audio if audio.ndim == 2 else slice_audio_windows(audio, cfg)
        real_windows = windows.shape[0]
        if real_windows == 0:
            raise ValueError(
                f"audio too short: {len(audio)} samples < one {cfg.samples_per_stride}-sample "
                f"window ({cfg.stride / cfg.fps:.0f} s at {cfg.sr} Hz)")
        if window_buckets:
            fits = [b for b in sorted(window_buckets) if b >= real_windows]
            if fits and fits[0] > real_windows:
                pad = np.zeros((fits[0] - real_windows,) + windows.shape[1:], windows.dtype)
                windows = np.concatenate([windows, pad])

        style_t = torch.as_tensor(np.atleast_2d(np.asarray(style, np.float32)), device=dev)
        B = style_t.shape[0]
        feats = self.wavlm_apply(wavlm_params, torch.as_tensor(windows, device=dev))
        wa, wb = (torch.as_tensor(w, device=dev)
                  for w in crossfade_weights(cfg.n_seed, B, cfg.crossfade_n))

        seed = torch.zeros((B, cfg.njoints, 1, cfg.n_seed), device=dev)
        chunks = []
        for i in range(real_windows):
            noise = None
            if noise_windows is not None:
                noise = torch.as_tensor(np.asarray(noise_windows[i], np.float32), device=dev)
            sample = self._window_sample(params, generator, feats[i], seed, style_t, noise)
            if i > 0:
                if cfg.root_delta_correction:
                    # root-translation delta removal (ref `:269-282`)
                    delta = (sample[:, 0:3, :, 0] - seed[:, 0:3, :, 0])[..., None]
                    sample = torch.cat([sample[:, 0:3] - delta, sample[:, 3:]], dim=1)
                head = seed * wa + sample[..., : cfg.n_seed] * wb
                sample = torch.cat([head, sample[..., cfg.n_seed:]], dim=-1)
            seed = sample[..., -cfg.n_seed:]
            chunks.append(sample[..., : cfg.stride])
        out = torch.cat(chunks, dim=-1)[..., cfg.n_seed:]  # drop the warm-up seed frames
        seq = out[:, :, 0].transpose(1, 2)  # (B, T, C)
        if not device_out:
            seq = seq.cpu().numpy()
        return unnormalize_poses(seq, mean, std)
