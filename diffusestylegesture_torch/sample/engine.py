"""Windowed long-form ZEGGS gesture generation.

Port of `diffusestylegesture_tpu/sample/engine.py` (`ZeggsSampler`,
`generate_multi_clip`; reference `main/mydiffusion_zeggs/sample.py:210-338`):
the audio is cut into ⌊T/(n_poses−n_seed)⌋ windows, each with an
n_seed-frame audio prefix (zeros for window 0, the previous window's tail
otherwise); WavLM runs ONCE over all windows; each window then runs the
reverse-diffusion loop with the carried seed, the root-translation delta
correction (`:269-282`) and the crossfade over the n_seed overlap
(`:284-288`); the result is trimmed and un-normalized.

The JAX engine jits the whole clip into one XLA program (two nested
`lax.scan`s) and the encoder into another. On a CUDA device this engine
captures the loop's step functions and the encoder into CUDA graphs at
first use and replays them (`utils/graphs.py`): one `replay()` a denoiser
step, one for WavLM. One graph set is kept per (batch, model, CFG on or
off) of a sampler, which fixes the sampler kind, the step count and the
model's dtype, as the JAX AOT key with its `program_tag` does. The
conditioning (style, seed, the window's features, the local mask) lies in
buffers of the graph set that each window refills. Between windows only the
seed carry, the root-delta correction and the crossfade run as eager ops.
`graphs=False` runs the same step functions eagerly on the card: the
comparison path, which gives the same numbers; on the CPU that is the only
path. The window runner and the graph bookkeeping (`_WindowRun`,
`_WindowSampler`) serve the BEAT/TWH engine (`engine_beat.py`) too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import SamplerConfig, Schedule, make_cfg_model_fn
from ..diffusion.sampling import PROGRAMS, SampleProgram
from ..utils.graphs import GraphSet


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


class _WindowRun:
    """What one (batch, model) needs to sample windows: the conditioning
    buffers `cond` (a tensor, or None for one sized at the first fill), the
    loop's program over them, its generator and, on the graph path, one graph
    per phase of the program."""

    def __init__(self, sampler: "_WindowSampler", params, cond: Dict[str, Optional[torch.Tensor]],
                 shape: tuple, skip_timesteps: int = 0):
        cfg, dev = sampler.cfg, sampler.device
        batch = shape[0]
        self.params = params  # the graphs read these weights where they lie
        self.generator = torch.Generator(device=dev)
        self.cond = cond
        if cfg.guidance_scale and cfg.guidance_scale != 1.0:
            model_fn = make_cfg_model_fn(sampler.model_apply, cfg.guidance_scale, batch,
                                         params=params, cond=self.cond)
        else:
            def model_fn(x, t):
                return sampler.model_apply(params, x, t, self.cond)
        self.program: SampleProgram = PROGRAMS[cfg.sampler](
            sampler.schedule, model_fn, shape, self.generator,
            cfg=sampler.sampler_cfg, skip_timesteps=skip_timesteps)
        self.graph_set = GraphSet(dev, [self.generator]) if sampler.graphs else None
        self.graphs: Optional[list] = None

    def capture(self) -> None:
        """One graph per phase, each warmed up from the step index it starts at.
        The warm-up calls' draws are given back to the generator."""
        prog, self.graphs, step = self.program, [], self.program.t0
        state = self.generator.get_state()
        for phase in prog.phases:
            start = step
            graph, _ = self.graph_set.capture(phase.fn, prepare=lambda s=start: prog.idx.fill_(s))
            self.graphs.append(graph)
            step -= phase.count
        self.generator.set_state(state)

    def fill(self, **tensors: torch.Tensor) -> None:
        """Copy each tensor into its conditioning buffer (a float32 one is
        allocated at the first fill where the buffer is None)."""
        for name, value in tensors.items():
            if self.cond[name] is None:
                self.cond[name] = torch.zeros(value.shape, device=value.device)
            self.cond[name].copy_(value)

    def sample(self, noise: Optional[torch.Tensor], **tensors: torch.Tensor) -> torch.Tensor:
        """One window: refill the buffers, run the loop, return a copy of x_0."""
        self.fill(**tensors)
        if self.graph_set is not None and self.graphs is None:
            self.capture()
        self.program.init(noise)
        if self.graphs is None:
            self.program.run()
        else:
            for phase, graph in zip(self.program.phases, self.graphs):
                graph.replay(phase.count)
        return self.program.img.clone()


class _WindowSampler:
    """What the ZEGGS and the BEAT/TWH samplers share: the device, the graph
    switch, the schedule and one `_WindowRun` per (batch, model)."""

    def __init__(self, model_apply: Callable, schedule: Schedule, cfg, sampler_cfg: SamplerConfig,
                 device: Union[str, torch.device], graphs: Optional[bool]):
        self.device = resolve_device(device)
        if schedule.device != self.device:
            raise ValueError(f"schedule lives on {schedule.device}, engine on {self.device}")
        if cfg.sampler not in PROGRAMS:
            raise ValueError(f"unknown sampler {cfg.sampler!r} ({sorted(PROGRAMS)})")
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.model_apply = model_apply
        self.schedule = schedule
        self.cfg = cfg
        self.sampler_cfg = sampler_cfg
        self._runs: Dict[tuple, _WindowRun] = {}

    @property
    def capture_seconds(self) -> float:
        """Seconds spent warming up and capturing graphs so far."""
        return sum(r.graph_set.capture_seconds for r in self._runs.values()
                   if r.graph_set is not None)

    def _new_run(self, params, batch: int) -> _WindowRun:
        raise NotImplementedError

    def _run(self, params, batch: int) -> _WindowRun:
        key = (batch, id(params))
        run = self._runs.get(key)
        if run is None or run.params is not params:
            run = self._runs[key] = self._new_run(params, batch)
        return run

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        dev = self.device
        if generator is not None:
            return generator
        return torch.cuda.default_generators[dev.index] if dev.type == "cuda" else \
            torch.default_generator


class ZeggsSampler(_WindowSampler):
    """Long-form ZEGGS sampler.

    model_apply: (params, x, t, cond, uncond=None) → x0 prediction, where
      `params` is what `generate` receives (the `MDM` module).
    wavlm_apply: (wavlm_params, windows (W, S)) → (W, n_poses, D) features
      at the motion rate (`make_zeggs_wavlm_fn`).
    schedule: diffusion `Schedule`, on `device`.
    graphs: None (default) captures CUDA graphs on a CUDA device and runs
      eagerly on the CPU; False runs eagerly on the card too (the comparison
      path); True on the CPU raises.
    """

    def __init__(self, model_apply: Callable, wavlm_apply: Callable, schedule: Schedule,
                 cfg: ZeggsEngineConfig = ZeggsEngineConfig(),
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 device: Union[str, torch.device] = "cuda", graphs: Optional[bool] = None):
        super().__init__(model_apply, schedule, cfg, sampler_cfg, device, graphs)
        self.wavlm_apply = wavlm_apply
        self._encoders: Dict[tuple, tuple] = {}

    @property
    def capture_seconds(self) -> float:
        """Seconds spent warming up and capturing graphs so far."""
        return super().capture_seconds + sum(rec[1].capture_seconds
                                             for rec in self._encoders.values())

    def encode(self, wavlm_params, windows: torch.Tensor) -> torch.Tensor:
        """WavLM over (W, S) windows → (W, n_poses, D) features; on the graph
        path one replay of the encoder captured for W windows (the result is
        the graph's output buffer, overwritten by the next call)."""
        if not self.graphs:
            return self.wavlm_apply(wavlm_params, windows)
        key = (tuple(windows.shape), id(wavlm_params))
        rec = self._encoders.get(key)
        if rec is None or rec[0] is not wavlm_params:
            graph_set = GraphSet(self.device)
            static_in = windows.clone()
            graph, out = graph_set.capture(lambda: self.wavlm_apply(wavlm_params, static_in))
            rec = self._encoders[key] = (wavlm_params, graph_set, graph, static_in, out)
        _, _, graph, static_in, out = rec
        static_in.copy_(windows)
        graph.replay()
        return out

    def _new_run(self, params, batch: int) -> _WindowRun:
        cfg, dev = self.cfg, self.device
        cond = {"style": torch.zeros((batch, 6), device=dev),
                "seed": torch.zeros((batch, cfg.njoints, 1, cfg.n_seed), device=dev),
                "audio": None,  # sized at the first window, from the features' width
                "mask_local": torch.ones((batch, cfg.n_poses), dtype=torch.bool, device=dev)}
        return _WindowRun(self, params, cond, (batch, cfg.njoints, 1, cfg.n_poses),
                          cfg.skip_timesteps)

    def sample_windows(self, params, window_feats: Callable[[int], torch.Tensor],
                       num_windows: int, style: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise_windows: Optional[np.ndarray] = None) -> torch.Tensor:
        """The autoregressive window loop: window i's features (B, n_poses, D)
        come from `window_feats(i)`. Returns (B, njoints, 1, T) on the device,
        the warm-up seed frames dropped. `generator` advances as if every
        draw had been made from it."""
        cfg, dev = self.cfg, self.device
        B = style.shape[0]
        run = self._run(params, B)
        generator = self._generator(generator)
        run.generator.set_state(generator.get_state())
        run.cond["style"].copy_(style)
        wa, wb = (torch.as_tensor(w, device=dev)
                  for w in crossfade_weights(cfg.n_seed, B, cfg.crossfade_n))
        seed = torch.zeros((B, cfg.njoints, 1, cfg.n_seed), device=dev)
        chunks = []
        for i in range(num_windows):
            noise = None
            if noise_windows is not None:
                noise = torch.as_tensor(np.asarray(noise_windows[i], np.float32), device=dev)
            sample = run.sample(noise, audio=window_feats(i), seed=seed)
            if i > 0:
                if cfg.root_delta_correction:
                    # root-translation delta removal (ref `:269-282`)
                    delta = (sample[:, 0:3, :, 0] - seed[:, 0:3, :, 0])[..., None]
                    sample = torch.cat([sample[:, 0:3] - delta, sample[:, 3:]], dim=1)
                head = seed * wa + sample[..., : cfg.n_seed] * wb
                sample = torch.cat([head, sample[..., cfg.n_seed:]], dim=-1)
            seed = sample[..., -cfg.n_seed:]
            chunks.append(sample[..., : cfg.stride])
        generator.set_state(run.generator.get_state())
        return torch.cat(chunks, dim=-1)[..., cfg.n_seed:]  # drop the warm-up seed frames

    @torch.inference_mode()
    def generate(self, params, wavlm_params, audio: np.ndarray, style: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 noise_windows: Optional[np.ndarray] = None,
                 window_buckets: Optional[tuple] = None, device_out: bool = False,
                 transfer_dtype: Optional[torch.dtype] = None):
        """audio (1-D 16 kHz, or already-sliced (W, S) windows) →
        (B, T_frames, njoints) un-normalized poses, numpy (a tensor on the
        device with `device_out=True`).

        `noise_windows` (W, B, njoints, 1, n_poses) injects each window's x_T.
        `window_buckets` pads the window count up to the next bucket with
        zero audio for the encoder batch; padded windows are causally
        downstream of the real ones, so they are not sampled and the output
        is that of the unpadded run. `transfer_dtype` (e.g. torch.float16)
        casts the un-normalized result on the device before it is copied to
        the host, halving the bytes moved; the returned array is float32.
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
        feats = self.encode(wavlm_params, torch.as_tensor(windows, device=dev))
        out = self.sample_windows(
            params, lambda i: feats[i][None].expand((B,) + tuple(feats.shape[1:])),
            real_windows, style_t, generator, noise_windows)
        return _poses_out(out[:, :, 0].transpose(1, 2), mean, std, device_out, transfer_dtype)


def _poses_out(seq: torch.Tensor, mean, std, device_out: bool, transfer_dtype):
    """(B, T, C) device poses → un-normalized: a device tensor, or numpy
    (cast to `transfer_dtype` on the device first, when given)."""
    if device_out:
        return unnormalize_poses(seq, mean, std)
    if transfer_dtype is not None:
        small = unnormalize_poses(seq, mean, std).to(transfer_dtype)
        return small.cpu().numpy().astype(np.float32)
    return unnormalize_poses(seq.cpu().numpy(), mean, std)


@torch.inference_mode()
def generate_multi_clip(sampler: ZeggsSampler, params, wavlm_params, audios: Sequence[np.ndarray],
                        styles: np.ndarray, generator: Optional[torch.Generator] = None,
                        mean=None, std=None, noise_windows: Optional[np.ndarray] = None,
                        transfer_dtype: Optional[torch.dtype] = None):
    """Several clips as one batch (JAX `generate_multi_clip`, `engine.py:425-474`):
    the clips are padded to the largest window count, WavLM runs once over
    clips × windows, and window w of every clip runs in one denoiser call
    with per-clip features, through the sampler's engine at batch = number of
    clips. `noise_windows` is (w_max, n_clips, njoints, 1, n_poses). Returns
    a list of (T_i, njoints) float32 arrays; a clip shorter than one stride
    gives an empty one."""
    cfg = sampler.cfg
    sliced = [slice_audio_windows(np.asarray(a, np.float32), cfg) for a in audios]
    counts = [s.shape[0] for s in sliced]
    w_max, B = max(counts), len(audios)
    if w_max == 0:
        raise ValueError("every clip is shorter than one window")
    padded = np.zeros((B, w_max, sliced[0].shape[1]), np.float32)
    for i, s in enumerate(sliced):
        padded[i, : s.shape[0]] = s
    dev = sampler.device
    flat = torch.as_tensor(padded.reshape(B * w_max, -1), device=dev)
    feats = sampler.encode(wavlm_params, flat)
    feats = feats.reshape((B, w_max) + tuple(feats.shape[1:]))
    styles_t = torch.as_tensor(np.asarray(styles, np.float32), device=dev)
    out = sampler.sample_windows(params, lambda w: feats[:, w], w_max, styles_t, generator,
                                 noise_windows)
    seq = _poses_out(out[:, :, 0].transpose(1, 2), mean, std, False, transfer_dtype)
    return [seq[i, : max(0, c * cfg.stride - cfg.n_seed)] for i, c in enumerate(counts)]
