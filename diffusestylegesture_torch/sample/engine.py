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
path.

A window function marked `host_side` (`make_mfcc_window_fn`: the Sphinx MFCC
of an `audio_feat='mfcc'` MDM, reference `inference_mfcc`) runs on the host
over numpy windows, outside every graph (JAX `engine.py:155-164,244-256,
366-372`); its features go to the card once, and each window copies its row
into the run's static audio buffer, which the captured steps read. The window runner, the graph bookkeeping and the per-window carry
(`_WindowRun`, `_WindowSampler.window`) serve the BEAT/TWH engine
(`engine_beat.py`), the streams (`streaming.py`) and the server
(`server.py`) too.

`generate(..., mesh=)` (a `parallel.make_mesh` mesh with a `data` axis) is
the JAX engine's multi-chip serving, single-process as JAX's is: each card of
the axis holds a replica of the model (and of the schedule) and its own
window runs and graphs, and samples its rows of the batch (the first cards one
row more when the batch does not divide); the loop issues one denoising step
of every card in turn, so the cards run concurrently, and the rows are
gathered on the sampler's device at the end. The encoder runs once, on the
sampler's device, and each card copies its rows of the features. What the
unsharded run decides from the whole batch stays whole: every card draws the
noise of the whole batch from the same generator state and keeps its rows
(`parallel.draws.GlobalDraws`), and the crossfade takes its n from the whole batch
(the reference quirk), so the output is the unsharded run's up to the cards'
rounding. `lane_launches` holds each card's kernel launches of the last
meshed call.

Tracing (`utils/profiling.py`, off by default): `ZeggsSampler.encode` is an
`engine.encode` span, and each window of the loop an `engine.window` span
holding `engine.begin` (buffers refilled, graphs captured at first use),
`engine.steps` (the step loop; `steps` replayed) and `engine.finish` (root
delta and crossfade).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import SamplerConfig, Schedule, make_cfg_model_fn
from ..diffusion.sampling import PROGRAMS, SampleProgram
from ..parallel.draws import GlobalDraws
from ..parallel.mesh import row_bounds
from ..utils import profiling
from ..utils.graphs import GraphSet, capture_program, launch_counts


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
                 shape: tuple, skip_timesteps: int = 0, rows: Optional[tuple] = None):
        cfg, dev = sampler.cfg, sampler.device
        batch = shape[0]
        # rows (start, stop, total): this run samples those rows of a batch of
        # `total` (a card of a serving mesh); draws and crossfade use `total`
        self.crossfade_batch = batch if rows is None else rows[2]
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
            sampler.schedule, model_fn, shape,
            self.generator if rows is None else GlobalDraws(self.generator, *rows),
            cfg=sampler.sampler_cfg, skip_timesteps=skip_timesteps)
        self.graph_set = GraphSet(dev, [self.generator]) if sampler.graphs else None
        self.graphs: Optional[list] = None

    def fill(self, **tensors: torch.Tensor) -> None:
        """Copy each tensor into its conditioning buffer (a float32 one is
        allocated at the first fill where the buffer is None)."""
        for name, value in tensors.items():
            if self.cond[name] is None:
                self.cond[name] = torch.zeros(value.shape, device=value.device)
            self.cond[name].copy_(value)

    def begin(self, noise: Optional[torch.Tensor], **tensors: torch.Tensor) -> None:
        """Refill the buffers (capturing the graphs at first use) and set x_T."""
        self.fill(**tensors)
        if self.graph_set is not None and self.graphs is None:
            self.graphs = capture_program(self.graph_set, self.program, self.generator)
        self.program.init(noise)

    def steps(self):
        """The loop's steps, one at each `next` (a replay on the graph path)."""
        for i, phase in enumerate(self.program.phases):
            for _ in range(phase.count):
                if self.graphs is None:
                    phase.fn()
                else:
                    self.graphs[i].replay(1)
                yield

    def sample(self, noise: Optional[torch.Tensor], **tensors: torch.Tensor) -> torch.Tensor:
        """One window: refill the buffers, run the loop, return a copy of x_0."""
        self.begin(noise, **tensors)
        for _ in self.steps():
            pass
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
        self._crossfades: Dict[int, tuple] = {}
        self._replicas: Dict[tuple, "_WindowSampler"] = {}
        self._params: Dict[tuple, tuple] = {}
        self.lane_launches: List[List[int]] = []

    @property
    def capture_seconds(self) -> float:
        """Seconds spent warming up and capturing graphs so far."""
        return sum(r.graph_set.capture_seconds for r in self._runs.values()
                   if r.graph_set is not None)

    def _new_run(self, params, batch: int, rows: Optional[tuple] = None) -> _WindowRun:
        raise NotImplementedError

    def _run(self, params, batch: int, rows: Optional[tuple] = None) -> _WindowRun:
        key = (batch, id(params), rows)
        run = self._runs.get(key)
        if run is None or run.params is not params:
            run = self._runs[key] = self._new_run(params, batch, rows)
        return run

    def _replica(self, index: int, dev: torch.device) -> "_WindowSampler":
        """This sampler on card `dev` of a serving mesh (itself for the first
        card when it lives there): a copy with the schedule there and runs,
        graphs and caches of its own, made once."""
        if index == 0 and dev == self.device:
            return self
        key = (index, str(dev))
        if key not in self._replicas:
            rep = copy.copy(self)
            rep.device = dev
            rep.schedule = dataclasses.replace(self.schedule, **{
                f.name: getattr(self.schedule, f.name).to(dev)
                for f in dataclasses.fields(self.schedule)})
            rep._runs, rep._crossfades, rep._replicas, rep._params = {}, {}, {}, {}
            if hasattr(rep, "_encoders"):
                rep._encoders = {}
            self._replicas[key] = rep
        return self._replicas[key]

    def _params_on(self, params, dev: torch.device):
        """`params` (a module) on `dev`: itself where it lies there, else a copy
        made once per (params, card)."""
        first = next(params.parameters(), None) if isinstance(params, torch.nn.Module) else None
        if first is None or first.device == dev:
            return params
        key = (id(params), str(dev))
        if key not in self._params or self._params[key][0] is not params:
            self._params[key] = (params, copy.deepcopy(params).to(dev))
        return self._params[key][1]

    def _lanes(self, params, batch: int, mesh) -> List["_Lane"]:
        """One lane a card of `mesh`'s data axis that gets rows (one lane on
        this sampler's device without a mesh)."""
        if mesh is None:
            return [_Lane(self, params, 0, batch, None)]
        if "data" not in mesh.axis_names:
            raise ValueError(f"a serving mesh needs a 'data' axis (axes {mesh.axis_names})")
        lanes = []
        for i, (dev, (lo, hi)) in enumerate(zip(mesh.axis_devices("data"),
                                                row_bounds(batch, mesh.shape["data"]))):
            if hi > lo:
                rep = self._replica(i, torch.device(dev))
                lanes.append(_Lane(rep, self._params_on(params, rep.device), lo, hi,
                                   (lo, hi, batch)))
        return lanes

    def _run_lanes(self, lanes: List["_Lane"], num_windows: int, generator,
                   noise_windows, seed0: Callable, window_cond: Callable[[int], dict],
                   keep: Callable[[torch.Tensor, int], torch.Tensor]) -> List[torch.Tensor]:
        """The autoregressive window loop over every lane: per window, each
        lane's window issued in turn (the cards run concurrently). `seed0(lane)`
        → the lane's first seed on its card; `window_cond(i)` → window i's
        conditioning {name: (B, …) tensor}, of which each lane copies its rows;
        `keep(sample, i)` → what window i contributes. Returns per lane the
        list of kept pieces, on its card. `generator` advances as if every
        draw had been made from it. The lanes' loops advance a step each in
        turn: issued a whole loop at a time, one card's replays would fill the
        launch queue and hold the host until that card had nearly finished."""
        state = generator.get_state()
        for lane in lanes:
            lane.run.generator.set_state(state)
        seeds = [seed0(lane) for lane in lanes]
        pieces: List[List[torch.Tensor]] = [[] for _ in lanes]
        meshed = len(lanes) > 1 or lanes[0].rows is not None
        launches = [[0] * len(launch_counts()) for _ in lanes]

        def on_lane(j, fn):
            """fn() on lane j's card, its launches added to the lane's count."""
            before = launch_counts()
            with lanes[j].on_card():
                out = fn()
            launches[j] = [a + b - c for a, b, c in zip(launches[j], launch_counts(), before)]
            return out

        rows = sum(lane.hi - lane.lo for lane in lanes)
        for i in range(num_windows):
            with profiling.span("engine.window", window=i, rows=rows):
                with profiling.span("engine.begin"):
                    cond = window_cond(i)
                    for j, lane in enumerate(lanes):
                        noise = None
                        if noise_windows is not None:
                            noise = torch.as_tensor(
                                np.asarray(noise_windows[i][lane.lo:lane.hi], np.float32),
                                device=lane.device)
                        cond_l = ({k: v[lane.lo:lane.hi].to(lane.device) for k, v in cond.items()}
                                  if meshed else cond)
                        on_lane(j, lambda: lane.run.begin(noise, seed=seeds[j], **cond_l))
                # one step of every card's loop in turn: each card's queue stays short
                # and the cards run at once
                with profiling.span("engine.steps") as sp:
                    loops = [lane.run.steps() for lane in lanes]
                    live = list(range(len(lanes)))
                    while live:
                        for j in list(live):
                            if on_lane(j, lambda: next(loops[j], StopIteration)) is StopIteration:
                                live.remove(j)
                    if sp:
                        sp.set(steps=sum(ph.count for lane in lanes
                                         for ph in lane.run.program.phases))
                with profiling.span("engine.finish"):
                    for j, lane in enumerate(lanes):
                        sample, seeds[j] = on_lane(j, lambda: lane.sampler.finish_window(
                            lane.run, lane.run.program.img.clone(), i == 0, seeds[j]))
                        pieces[j].append(keep(sample, i))
        generator.set_state(lanes[0].run.generator.get_state())
        if meshed:
            self.lane_launches = launches
        return pieces

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        dev = self.device
        if generator is not None:
            return generator
        return torch.cuda.default_generators[dev.index] if dev.type == "cuda" else \
            torch.default_generator

    def _crossfade(self, batch: int) -> tuple:
        """`crossfade_weights` as device tensors, made once per batch size (a
        copy from the host waits for the card, so none is made per call)."""
        if batch not in self._crossfades:
            self._crossfades[batch] = tuple(
                torch.as_tensor(w, device=self.device)
                for w in crossfade_weights(self.cfg.n_seed, batch, self.cfg.crossfade_n))
        return self._crossfades[batch]

    def window(self, run: _WindowRun, noise: Optional[torch.Tensor], first: bool,
               seed: torch.Tensor, **cond: torch.Tensor) -> tuple:
        """One window of the autoregressive loop: sample it under the carried
        seed, then (after window 0) remove the root-translation delta (ref
        `sample.py:269-282`, where the config asks for it) and crossfade its
        first n_seed frames with the seed (`:284-288`). Returns (sample, the
        next window's seed). The batch engines and the streams share it."""
        return self.finish_window(run, run.sample(noise, seed=seed, **cond), first, seed)

    def finish_window(self, run: _WindowRun, sample: torch.Tensor, first: bool,
                      seed: torch.Tensor) -> tuple:
        """`window`'s step after the loop: root delta and crossfade."""
        cfg = self.cfg
        if not first:
            if getattr(cfg, "root_delta_correction", False):
                delta = (sample[:, 0:3, :, 0] - seed[:, 0:3, :, 0])[..., None]
                sample = torch.cat([sample[:, 0:3] - delta, sample[:, 3:]], dim=1)
            wa, wb = self._crossfade(run.crossfade_batch)
            head = seed * wa + sample[..., : cfg.n_seed] * wb
            sample = torch.cat([head, sample[..., cfg.n_seed:]], dim=-1)
        return sample, sample[..., -cfg.n_seed:]


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

    def encode(self, wavlm_params, windows) -> torch.Tensor:
        """The window function over (W, S) windows (numpy or a tensor) →
        (W, n_poses, D) features on the device. WavLM: on the graph path one
        replay of the encoder captured for W windows (the result is the
        graph's output buffer, overwritten by the next call). A host-side
        function: its numpy result copied to the device. Traced as an
        `engine.encode` span: the windows and how they ran (`host`, `eager`,
        `capture` or `replay`)."""
        with profiling.span("engine.encode", windows=int(windows.shape[0])) as sp:
            if getattr(self.wavlm_apply, "host_side", False):
                sp.set(path="host")
                host = windows.cpu().numpy() if torch.is_tensor(windows) else windows
                feats = self.wavlm_apply(wavlm_params, np.asarray(host, np.float32))
                return torch.as_tensor(np.asarray(feats, np.float32), device=self.device)
            if not torch.is_tensor(windows):
                windows = torch.as_tensor(np.asarray(windows, np.float32), device=self.device)
            if not self.graphs:
                sp.set(path="eager")
                return self.wavlm_apply(wavlm_params, windows)
            key = (tuple(windows.shape), id(wavlm_params))
            rec = self._encoders.get(key)
            fresh = rec is None or rec[0] is not wavlm_params
            sp.set(path="capture" if fresh else "replay")
            if fresh:
                graph_set = GraphSet(self.device)
                static_in = windows.clone()
                graph, out = graph_set.capture(lambda: self.wavlm_apply(wavlm_params, static_in),
                                               what="encoder", shape=tuple(windows.shape))
                rec = self._encoders[key] = (wavlm_params, graph_set, graph, static_in, out)
            _, _, graph, static_in, out = rec
            static_in.copy_(windows)
            graph.replay()
            return out

    def _new_run(self, params, batch: int, rows: Optional[tuple] = None) -> _WindowRun:
        cfg, dev = self.cfg, self.device
        cond = {"style": torch.zeros((batch, 6), device=dev),
                "seed": torch.zeros((batch, cfg.njoints, 1, cfg.n_seed), device=dev),
                "audio": None,  # sized at the first window, from the features' width
                "mask_local": torch.ones((batch, cfg.n_poses), dtype=torch.bool, device=dev)}
        return _WindowRun(self, params, cond, (batch, cfg.njoints, 1, cfg.n_poses),
                          cfg.skip_timesteps, rows)

    def sample_windows(self, params, window_feats: Callable[[int], torch.Tensor],
                       num_windows: int, style: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise_windows: Optional[np.ndarray] = None, mesh=None) -> torch.Tensor:
        """The autoregressive window loop: window i's features (B, n_poses, D)
        come from `window_feats(i)`. Returns (B, njoints, 1, T) on the device,
        the warm-up seed frames dropped. `generator` advances as if every
        draw had been made from it. `mesh`: the rows spread over its cards
        (module docstring)."""
        cfg = self.cfg
        B = style.shape[0]
        lanes = self._lanes(params, B, mesh)
        for lane in lanes:
            with lane.on_card():
                lane.run = lane.sampler._run(lane.params, lane.hi - lane.lo, lane.rows)
                lane.run.cond["style"].copy_(style[lane.lo:lane.hi])
        pieces = self._run_lanes(
            lanes, num_windows, self._generator(generator), noise_windows,
            lambda lane: torch.zeros((lane.hi - lane.lo, cfg.njoints, 1, cfg.n_seed),
                                     device=lane.device),
            lambda i: {"audio": window_feats(i)}, lambda sample, i: sample[..., : cfg.stride])
        out = [torch.cat(p, dim=-1).to(self.device) for p in pieces]
        out = out[0] if len(out) == 1 else torch.cat(out)
        return out[..., cfg.n_seed:]  # drop the warm-up seed frames

    @torch.inference_mode()
    def generate(self, params, wavlm_params, audio: np.ndarray, style: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 mean: Optional[np.ndarray] = None, std: Optional[np.ndarray] = None,
                 noise_windows: Optional[np.ndarray] = None,
                 window_buckets: Optional[tuple] = None, device_out: bool = False,
                 transfer_dtype: Optional[torch.dtype] = None, mesh=None):
        """audio (1-D 16 kHz, or already-sliced (W, S) windows) →
        (B, T_frames, njoints) un-normalized poses, numpy (a tensor on the
        device with `device_out=True`). `mesh` (`parallel.make_mesh`): the
        batch's rows spread over its data axis's cards (module docstring);
        `noise_windows` are then cut by rows too.

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
        feats = self.encode(wavlm_params, windows)
        out = self.sample_windows(
            params, lambda i: feats[i][None].expand((B,) + tuple(feats.shape[1:])),
            real_windows, style_t, generator, noise_windows, mesh)
        return _poses_out(out[:, :, 0].transpose(1, 2), mean, std, device_out, transfer_dtype)


class _Lane:
    """A card's share of a call: its sampler, params and rows [lo, hi) of the
    batch (`rows` = (lo, hi, B) on a mesh, None otherwise), and its run."""

    def __init__(self, sampler: _WindowSampler, params, lo: int, hi: int,
                 rows: Optional[tuple]):
        self.sampler, self.params, self.lo, self.hi, self.rows = sampler, params, lo, hi, rows
        self.device = sampler.device
        self.run: Optional[_WindowRun] = None

    def on_card(self):
        """The lane's card as the current device (graph captures and the
        kernels' launches go to it)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else \
            contextlib.nullcontext()


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
    feats = sampler.encode(wavlm_params, padded.reshape(B * w_max, -1))
    feats = feats.reshape((B, w_max) + tuple(feats.shape[1:]))
    styles_t = torch.as_tensor(np.asarray(styles, np.float32), device=dev)
    out = sampler.sample_windows(params, lambda w: feats[:, w], w_max, styles_t, generator,
                                 noise_windows)
    seq = _poses_out(out[:, :, 0].transpose(1, 2), mean, std, False, transfer_dtype)
    return [seq[i, : max(0, c * cfg.stride - cfg.n_seed)] for i, c in enumerate(counts)]


def make_mfcc_window_fn(n_poses: int = 88, fps: int = 20) -> Callable:
    """The window function of the MFCC conditioning mode (JAX
    `engine.py:550-572`; reference `inference_mfcc`,
    `main/mydiffusion_zeggs/sample.py:59-207`): per window, the 13 Sphinx
    cepstra at the motion frame rate, zero-padded or cut to `n_poses` rows.
    Host-side numpy (`host_side = True`): the engines run it outside their
    graphs and copy its (W, n_poses, 13) result to the card."""
    from ..audio import sphinx_mfcc_energy

    def fn(_unused_params, windows: np.ndarray) -> np.ndarray:
        feats = []
        for w in np.asarray(windows):
            m = sphinx_mfcc_energy(w, frate=fps)[:, :-2]  # (T', 13)
            if len(m) < n_poses:
                m = np.pad(m, ((0, n_poses - len(m)), (0, 0)))
            feats.append(m[:n_poses])
        return np.stack(feats).astype(np.float32)

    fn.host_side = True
    return fn
