"""Streaming long-form generation: push audio as it arrives, pull motion
window by window.

Port of `diffusestylegesture_tpu/sample/streaming.py` (the reference only
generates whole clips, `main/mydiffusion_zeggs/sample.py:210-338`). A live
client feeds 16 kHz audio (ZEGGS) or fused feature rows (BEAT/TWH) in chunks
of any size; as soon as a window's worth of new input is buffered, one window
runs: the reverse-diffusion loop under the carried seed, the root-delta
correction and the crossfade. That window goes through the batch engine's
own pieces at the stream's batch: the sampler's `_WindowRun` (its graph set
on the card, shared by every session over the same sampler and model, as
the JAX sessions share one jitted step), `_WindowSampler.window` for the
carry, and the engines' un-normalization. So push(...) (+ `flush()` for
BEAT/TWH) gives what `ZeggsSampler.generate` / `BeatTwhSampler.generate`
give on the whole clip for the same generator state, up to the encoder: the
stream runs WavLM one window at a time, the batch engine over all windows
at once, and a library may choose other algorithms for the two shapes.

A host-side window function (the Sphinx-MFCC mode, `make_mfcc_window_fn`,
with an `audio_feat='mfcc'` MDM; JAX `streaming.py:104-106`) runs on the host
over each window's audio, through the sampler's own `encode`, before the
window's graphs replay; its features are copied into the run's static audio
buffer like the batch engine's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .engine import ZeggsSampler, unnormalize_poses
from .engine_beat import BeatTwhSampler, unnormalize


class ZeggsStreamSampler:
    """Stateful incremental wrapper around a :class:`ZeggsSampler`::

        stream = ZeggsStreamSampler(sampler, model, wavlm, style, generator,
                                    mean=mean, std=std)
        for audio_chunk in microphone():       # any chunk sizes
            for motion in stream.push(audio_chunk):
                play(motion)                   # (B, frames, njoints)

    The first emitted window is `stride − n_seed` frames (the engine drops the
    warm-up seed frames, ref `sample.py:296`); every later one is `stride`
    frames. Audio short of a full window stays buffered: as in the batch
    engine, an incomplete tail window is never generated. `generator` (on the
    sampler's device; its default generator when None) advances as the batch
    engine's does.
    """

    def __init__(self, sampler: ZeggsSampler, params, wavlm_params, style: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None):
        self.sampler, self.params, self.wavlm_params = sampler, params, wavlm_params
        self.cfg = cfg = sampler.cfg
        dev = sampler.device
        self.style = torch.as_tensor(np.atleast_2d(np.asarray(style, np.float32)), device=dev)
        self.mean, self.std = mean, std
        B = self.style.shape[0]
        self._generator = sampler._generator(generator)
        self._seed = torch.zeros((B, cfg.njoints, 1, cfg.n_seed), device=dev)
        self._window_index = 0
        self._buffer = np.zeros(0, np.float32)
        self._prev_tail = np.zeros(cfg.samples_per_seed, np.float32)

    @torch.inference_mode()
    def push(self, audio_chunk: np.ndarray) -> List[np.ndarray]:
        """Feed new audio samples; returns 0+ ready motion chunks, each
        (B, frames, njoints) un-normalized like `ZeggsSampler.generate`."""
        self._buffer = np.concatenate([self._buffer, np.asarray(audio_chunk, np.float32)])
        cfg, out = self.cfg, []
        while len(self._buffer) >= cfg.samples_per_stride:
            main = self._buffer[: cfg.samples_per_stride]
            self._buffer = self._buffer[cfg.samples_per_stride:]
            window_audio = np.concatenate([self._prev_tail, main])
            self._prev_tail = main[-cfg.samples_per_seed:]
            out.append(self._run_window(window_audio))
        return out

    def _run_window(self, window_audio: np.ndarray) -> np.ndarray:
        sampler, cfg = self.sampler, self.cfg
        B = self.style.shape[0]
        feats = sampler.encode(self.wavlm_params, window_audio[None])
        run = sampler._run(self.params, B)
        run.fill(style=self.style)  # sessions share the run: refill per window
        run.generator.set_state(self._generator.get_state())
        first = self._window_index == 0
        sample, self._seed = sampler.window(run, None, first, self._seed,
                                            audio=feats.expand((B,) + tuple(feats.shape[1:])))
        self._generator.set_state(run.generator.get_state())
        seq = sample[..., : cfg.stride][:, :, 0].transpose(1, 2).cpu().numpy()
        if first:
            seq = seq[:, cfg.n_seed:]  # ref `sample.py:296`
        self._window_index += 1
        return unnormalize_poses(seq, self.mean, self.std)

    @property
    def frames_emitted(self) -> int:
        if self._window_index == 0:
            return 0
        return self._window_index * self.cfg.stride - self.cfg.n_seed


class BeatTwhStreamSampler:
    """Streaming BEAT/TWH generation: push fused text + audio feature rows
    (30 fps rows of `data.beat_twh` features) as they arrive; each complete
    stride (120 frames = 4 s) yields motion. `flush()` runs the zero-padded
    last partial window as the batch engine does (ref `sample.py:57-73`), so
    push(...) + flush() gives `BeatTwhSampler.generate` on the whole clip.
    """

    def __init__(self, sampler: BeatTwhSampler, params, seed_gesture: np.ndarray,
                 style: np.ndarray, generator: Optional[torch.Generator], mean: np.ndarray,
                 std: np.ndarray, seed_last: Optional[np.ndarray] = None):
        self.sampler, self.params = sampler, params
        self.cfg = cfg = sampler.cfg
        if cfg.variant == "attention5" and seed_last is None:
            raise ValueError("attention5 needs seed_last")
        dev = sampler.device
        self.style = torch.as_tensor(np.atleast_2d(np.asarray(style, np.float32)), device=dev)
        self.mean, self.std = np.asarray(mean), np.asarray(std)
        B = self.style.shape[0]
        self._seed = sampler.seed_tensor(seed_gesture, B)
        self._seed_last = None if seed_last is None else sampler.seed_tensor(seed_last, B)
        self._generator = sampler._generator(generator)
        self._window_index = 0
        self._frames_in = 0
        self._emitted = 0
        self._buffer = np.zeros((0, cfg.audio_dim), np.float32)
        self._prev_tail = np.zeros((cfg.n_seed, cfg.audio_dim), np.float32)
        self._last_tail = None

    def _model_window(self, main: np.ndarray) -> np.ndarray:
        """The variant's audio window (`BeatTwhSampler.slice_windows`)."""
        cfg = self.cfg
        if cfg.variant == "attention3":
            win = np.concatenate([self._prev_tail, main], axis=0)
        elif cfg.variant == "attention4":
            win = main
        else:  # attention5
            win = main[: cfg.stride - cfg.n_seed]
        self._prev_tail = main[-cfg.n_seed:]
        return win

    def _run_window(self, main: np.ndarray, final: bool) -> np.ndarray:
        """One window; emits its [0, stride) frames (the trailing n_seed are the
        next window's crossfaded head: the batch assembly trims every window
        but the last, ref `:180-188`). The whole window's tail is kept so that
        `flush` can emit it when this was the last window of an exact-stride
        clip."""
        sampler, cfg = self.sampler, self.cfg
        B = self.style.shape[0]
        run = sampler._run(self.params, B)
        run.fill(style=self.style)  # sessions share the run: refill per window
        if self._seed_last is not None:
            run.fill(seed_last=self._seed_last)
        win = torch.as_tensor(self._model_window(main), device=sampler.device)
        run.generator.set_state(self._generator.get_state())
        first = self._window_index == 0
        sample, self._seed = sampler.window(run, None, first, self._seed,
                                            audio=win[None].expand((B,) + tuple(win.shape)))
        self._generator.set_state(run.generator.get_state())
        keep = cfg.njoints // cfg.motion_feature_division
        seq = sample[:, :keep, 0].transpose(1, 2).cpu().numpy()  # (B, n_poses, keep)
        self._last_tail = seq[:, cfg.stride:]
        if not final:
            seq = seq[:, : cfg.stride]
        if first:
            seq = seq[:, cfg.n_seed:]
        self._window_index += 1
        if final:
            seq = seq[:, : max(0, self._frames_in - self._emitted)]
        self._emitted += seq.shape[1]
        return unnormalize(seq, self.mean, self.std)

    @torch.inference_mode()
    def push(self, features: np.ndarray) -> List[np.ndarray]:
        """Feed (t, audio_dim) fused feature rows; returns ready
        (B, frames, motion_dim) un-normalized motion chunks."""
        features = np.asarray(features, np.float32).reshape(-1, self.cfg.audio_dim)
        self._frames_in += features.shape[0]
        self._buffer = np.concatenate([self._buffer, features])
        out, stride = [], self.cfg.stride
        while len(self._buffer) >= stride:
            main, self._buffer = self._buffer[:stride], self._buffer[stride:]
            out.append(self._run_window(main, final=False))
        return out

    @torch.inference_mode()
    def flush(self) -> List[np.ndarray]:
        """Finish the clip as the batch engine does (ref `:57-73,180-188`): a
        buffered partial stride becomes the zero-padded last window; an
        exact-stride clip emits the kept tail of its last window instead (the
        batch engine keeps the last window whole). Nothing pushed: nothing out."""
        cfg, out = self.cfg, []
        if self._frames_in == 0 and self._window_index == 0:
            return out
        if len(self._buffer) > 0 or self._window_index == 0:
            pad = np.zeros((cfg.stride - len(self._buffer), cfg.audio_dim), np.float32)
            main = np.concatenate([self._buffer, pad])
            self._buffer = self._buffer[:0]
            out.append(self._run_window(main, final=True))
        elif self._emitted < self._frames_in:
            tail = self._last_tail[:, : self._frames_in - self._emitted]
            self._emitted += tail.shape[1]
            out.append(unnormalize(tail, self.mean, self.std))
        return out
