"""BEAT/TWH (DiffuseStyleGesture / + / ++) long-form sampling engine.

Port of `diffusestylegesture_tpu/sample/engine_beat.py` (reference
`BEAT-TWH-main/mydiffusion_beat_twh/sample.py:44-201`):

* ⌈T/(n_poses − n_seed)⌉ windows over the zero-padded text+audio features
  (`:57-73`);
* per-variant window slicing (`:100-138`): attention3 prepends the previous
  window's n_seed feature tail (zeros for window 0); attention4 feeds the
  plain stride; attention5 drops its last n_seed frames;
* window 0 is seeded from a real reference clip, z-normalized, with velocity
  and acceleration channels (`prepare_seed_gesture`, `:112-129`); later
  windows from the previous sample's tail; attention5 also takes `seed_last`;
* the crossfade quirk (`crossfade_weights`), and no root-delta correction
  (commented out in the reference, `:158-165`);
* assembly: every window but the last real one trimmed to its stride, the last
  kept whole (`:180-188`), the first n_seed frames dropped, a crop to the real
  frame count, the first njoints / motion_feature_division channels (the
  position block) kept, then un-normalized as seq · std + mean.

On a CUDA device the loop's step functions are captured into CUDA graphs at
first use and replayed, as in `ZeggsSampler` (`sample/engine.py`): one graph
set per (batch, model), whatever the window count. The conditioning (style,
seed, the window's features, the local mask and attention5's `seed_last`)
lies in buffers of the graph set that each window or each call refills.
`graphs=False` runs the same step functions eagerly (the comparison path,
bitwise equal). The JAX engine's `aot_dir=` has no counterpart (a CUDA graph
lives in its process) and its `mesh=` belongs to the port's multi-GPU slice.
Traced (`utils/profiling.py`) as `beat.generate` around `beat.prepare`, the
window loop's spans (`sample/engine.py`) and `beat.output`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..diffusion import SamplerConfig, Schedule
from ..utils import profiling
from .engine import _WindowSampler

VARIANTS = ("attention3", "attention4", "attention5")


def prepare_seed_gesture(raw: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """(n_seed+2, motion_dim) raw clip → (n_seed, 3·motion_dim) seed with
    velocity and acceleration channels (reference `sample.py:115-129`)."""
    g = (raw - mean) / std
    vel = g[1:] - g[:-1]
    acc = vel[1:] - vel[:-1]
    return np.concatenate([g[2:], vel[1:], acc], axis=1).astype(np.float32)


def unnormalize(seq: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """The position block un-normalized as seq · std + mean (std is not clipped, as
    it is for ZEGGS)."""
    return seq * np.asarray(std) + np.asarray(mean)


@dataclasses.dataclass(frozen=True)
class BeatEngineConfig:
    n_poses: int = 150
    n_seed: int = 30
    njoints: int = 2232  # motion_dim · 3
    audio_dim: int = 1435
    variant: str = "attention4"  # attention3 | attention4 | attention5
    motion_feature_division: int = 3  # v0 and TWH; 1 for BEAT v2
    guidance_scale: float = 0.0
    crossfade_n: Optional[int] = None  # None = the reference's batch-axis quirk
    sampler: str = "ddpm"  # ddpm | ddim | plms | dpmpp (a respaced Schedule for ddimN)

    @property
    def stride(self) -> int:
        return self.n_poses - self.n_seed


class BeatTwhSampler(_WindowSampler):
    """Long-form BEAT/TWH sampler.

    model_apply: (params, x, t, cond, uncond=None) → x0 prediction, where
      `params` is what `generate` receives (the `MDMPlus` module).
    schedule: diffusion `Schedule`, on `device`.
    graphs: when to capture (`utils.graphs.use_graphs`).
    """

    def __init__(self, model_apply: Callable, schedule: Schedule,
                 cfg: BeatEngineConfig = BeatEngineConfig(),
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 device: Union[str, torch.device] = "cuda", graphs: Optional[bool] = None):
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown variant {cfg.variant!r} ({VARIANTS})")
        super().__init__(model_apply, schedule, cfg, sampler_cfg, device, graphs)

    def slice_windows(self, textaudio: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """(T, A) fused features → (per-window model audio inputs, window count, T)."""
        cfg = self.cfg
        stride = cfg.stride
        real_n = textaudio.shape[0]
        num = max(1, -(-real_n // stride))
        pad = np.zeros((num * stride - real_n, cfg.audio_dim), textaudio.dtype)
        main = np.concatenate([textaudio, pad], axis=0).reshape(num, stride, cfg.audio_dim)
        if cfg.variant == "attention3":
            prev = np.zeros((num, cfg.n_seed, cfg.audio_dim), main.dtype)
            prev[1:] = main[:-1, -cfg.n_seed:]
            return np.concatenate([prev, main], axis=1), num, real_n
        if cfg.variant == "attention4":
            return main, num, real_n
        return main[:, : stride - cfg.n_seed], num, real_n

    @torch.inference_mode()
    def generate(self, params, textaudio: np.ndarray, seed_gesture: np.ndarray,
                 style: np.ndarray, generator: Optional[torch.Generator], mean: np.ndarray,
                 std: np.ndarray, seed_last: Optional[np.ndarray] = None, max_len: int = 0,
                 noise_windows: Optional[np.ndarray] = None, mesh=None) -> np.ndarray:
        """→ (B, real_n, motion_dim) un-normalized position block, numpy.

        `seed_gesture` (n_seed, njoints) from `prepare_seed_gesture`; `style`
        (B, speakers) or (speakers,), one-hot; `seed_last` (n_seed, njoints), needed by
        attention5 (the CLI passes the seed itself). `noise_windows`
        (W, B, njoints, 1, n_poses) injects each window's x_T. `generator`
        advances as if every draw had been made from it (the default generator
        of the device when None). `mesh` (`parallel.make_mesh`): the batch's
        rows spread over the cards of its data axis, as in
        `ZeggsSampler.generate` (`engine.py`'s module docstring).
        """
        with profiling.span("beat.generate") as sp:
            cfg, dev = self.cfg, self.device
            if cfg.variant == "attention5" and seed_last is None:
                raise ValueError("attention5 needs seed_last")
            # the windows sliced, the buffers filled, the features copied to the card
            with profiling.span("beat.prepare"):
                if max_len:
                    textaudio = textaudio[:max_len]
                windows, num, real_n = self.slice_windows(np.asarray(textaudio, np.float32))
                sp.set(windows=num, frames=real_n)
                style_t = torch.as_tensor(np.atleast_2d(np.asarray(style, np.float32)),
                                          device=dev)
                B = style_t.shape[0]
                lanes = self._lanes(params, style_t, mesh)
                if cfg.variant == "attention5":
                    for lane in lanes:
                        with lane.on_card():
                            lane.run.fill(seed_last=lane.sampler.seed_tensor(
                                seed_last, lane.hi - lane.lo))
                feats = torch.as_tensor(windows, device=dev)
            pieces = self._run_lanes(
                lanes, num, self._generator(generator), noise_windows,
                lambda lane: lane.sampler.seed_tensor(seed_gesture, lane.hi - lane.lo),
                lambda i: {"audio": feats[i][None].expand((B,) + feats.shape[1:])},
                lambda sample, i: sample)
            # the windows joined, copied to the host and un-normalized
            with profiling.span("beat.output"):
                samples = [torch.cat([p[i].to(dev) for p in pieces]) for i in range(num)]
                keep = cfg.njoints // cfg.motion_feature_division
                parts = ([s[:, :keep, 0, : cfg.stride] for s in samples[:-1]]
                         + [samples[-1][:, :keep, 0]])
                seq = torch.cat(parts, dim=-1).transpose(1, 2)[:, cfg.n_seed:].cpu().numpy()
                return unnormalize(seq, mean, std)[:, :real_n]

    def seed_tensor(self, a: np.ndarray, batch: int) -> torch.Tensor:
        """(n_seed, njoints) seed frames → (batch, njoints, 1, n_seed) on the device."""
        t = torch.as_tensor(np.asarray(a, np.float32).T[None, :, None, :], device=self.device)
        return t.expand(batch, -1, -1, -1)
