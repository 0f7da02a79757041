"""The training loop.

Port of `diffusestylegesture_tpu/train/loop.py` (reference `TrainLoop`,
`main/train/training_loop.py:26-356`): steps bounded by `num_steps`,
loss-quartile logging, periodic and final checkpoints labelled with the
number of completed steps, resume, a relaunch of a finished run that only
returns, the `DIFFUSION_TRAINING_TEST` smoke exit after the first periodic
save, and a SIGTERM guard that saves and stops cleanly.

The step's metrics stay on the device and are copied to the host only at
log and save boundaries: no host sync per step. At each log boundary the
loop synchronizes the device, records (step, time) in `boundaries` (so the
steady-state time a step is the difference of two boundaries) and keeps
what it logged in `logged`. Batches
come from an iterable of numpy dicts (copied to the device from pinned
memory), or, with a `DeviceWindowCache`, are gathered on the device; on a
card that step (gather, forward, backward, update) is captured once as a CUDA
graph and replayed (`utils/graphs.py::CapturedStep`), the counterpart of the
JAX trainer's jitted step. The host-fed step stays eager: it pins and copies
each batch on the host.
The multi-card fields of `LoopConfig` (mesh, tensor parallel, FSDP) wait for
the port's slice 9 and raise when set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .logger import KVLogger
from .state import CondBuilder, TrainConfig, TrainState, make_train_step


@dataclasses.dataclass
class LoopConfig:
    num_steps: int = 100_000
    log_interval: int = 50
    save_interval: int = 50_000
    checkpoint_dir: Optional[str] = None
    log_dir: Optional[str] = None
    log_formats: tuple = ("stdout",)
    # SIGTERM during run(): flush, save and return instead of dying mid-step
    # (ignored without a checkpoint_dir: nothing to save)
    save_on_preemption: bool = True
    use_mesh: bool = False
    tensor_parallel: int = 0
    fsdp: bool = False
    mesh: object = None

    def __post_init__(self):
        if self.use_mesh or self.tensor_parallel > 1 or self.fsdp or self.mesh is not None:
            raise NotImplementedError(
                "mesh, tensor-parallel and FSDP training come with slice 9 of the port "
                "(multi-card); use diffusestylegesture_tpu until then")


class _PreemptionGuard:
    """SIGTERM → a flag the step loop checks. Installed for the duration of
    `TrainLoop.run()` from the main thread (elsewhere it is a flag that stays
    unset); the previous handler is restored on exit, and called after the
    clean stop if it is a Python callable."""

    def __init__(self, signals=(None,)):
        import signal as _signal

        self._signal = _signal
        self._signals = [s for s in signals if s is not None] or [_signal.SIGTERM]
        self._prev: dict = {}
        self.requested: Optional[int] = None

    def _handler(self, signum, frame):
        self.requested = signum

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = self._signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            self._signal.signal(s, prev)
        if self.requested is not None:
            prev = self._prev.get(self.requested)
            if callable(prev):
                prev(self.requested, None)
        return False


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch → device tensors; from pinned memory on CUDA, so the copy
    does not wait for the device."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def train_seed(seed: int, step: int) -> int:
    """The train generator's seed for a run (re)started at `step`: a resumed run
    draws fresh randomness instead of replaying the stream from step 0."""
    return seed if step == 0 else int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class TrainLoop:
    def __init__(self, model: torch.nn.Module, schedule, data: Optional[Iterable],
                 train_cfg: TrainConfig = TrainConfig(), loop_cfg: LoopConfig = LoopConfig(),
                 cond_builder: Optional[CondBuilder] = None, seed: int = 0,
                 device_cache=None, batch_size: int = 0):
        self.loop_cfg = loop_cfg
        self.schedule = schedule
        self.data = data
        self.device = schedule.device
        self.logger = KVLogger(loop_cfg.log_dir, loop_cfg.log_formats)
        self.device_cache = device_cache
        if device_cache is not None:
            from ..data.device_cache import make_device_data_train_step

            if batch_size <= 0:
                raise ValueError("batch_size is required with a device_cache")
            self.cached_step = make_device_data_train_step(schedule, train_cfg, cond_builder,
                                                           batch_size, device_cache.sample_fn)
            self.train_step = None
        else:
            self.cached_step = None
            self.train_step = make_train_step(schedule, train_cfg, cond_builder)

        self.state = TrainState(model, train_cfg, schedule.num_timesteps)
        self.ckpt = CheckpointManager(loop_cfg.checkpoint_dir) if loop_cfg.checkpoint_dir else None
        self.seed = seed
        self.resume_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state)
            self.resume_step = self.state.step
            self.logger.log(f"resumed from step {self.resume_step}")
        self.generator = torch.Generator(device=self.device).manual_seed(
            train_seed(seed, self.resume_step))
        self.captured = None
        if self.cached_step is not None:
            from ..utils.graphs import CapturedStep

            self.captured = CapturedStep(
                lambda: self.cached_step.device_step(self.state, self.generator,
                                                     self.device_cache.arrays),
                self.device, [self.generator])
        self.boundaries: List[Tuple[int, float]] = []
        self.logged: List[Dict] = []  # what each log boundary dumped

    def _batches(self):
        if self.cached_step is not None:
            while True:
                yield None  # gathered on the device inside the step
        for batch in self.data:
            yield batch_to_device(batch, self.device)

    def _flush_metrics(self, pending: List[Dict[str, torch.Tensor]]) -> None:
        """Copy the buffered metrics to the host in one transfer a key and feed
        the logger."""
        if not pending:
            return
        host = {k: torch.stack([m[k] for m in pending]).cpu().numpy() for k in pending[0]}
        for i in range(len(pending)):
            ts = host["t"][i]
            vectors = {k: v[i] for k, v in host.items() if v.ndim == 2 and k != "t"}
            self.logger.log_loss_dict(ts, self.schedule.num_timesteps, vectors)
            for k, v in host.items():
                if v.ndim == 1:
                    self.logger.logkv_mean(k, float(v[i]))
        pending.clear()

    def _mark(self, step: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.boundaries.append((step, time.perf_counter()))

    def run(self) -> TrainState:
        cfg = self.loop_cfg
        step = self.resume_step
        pending: List[Dict[str, torch.Tensor]] = []
        guard = _PreemptionGuard()
        self._mark(step)
        with guard if cfg.save_on_preemption and self.ckpt is not None else contextlib.nullcontext():
            for batch in self._batches():
                if step >= cfg.num_steps:
                    break
                if guard.requested is not None:
                    self._flush_metrics(pending)
                    self.save(step)
                    self.logger.log(f"preemption (signal {guard.requested}): checkpoint "
                                    f"written at step {step}, stopping cleanly")
                    return self.state
                if self.captured is not None:
                    # a replay overwrites the graph's metrics: keep a copy of each step's
                    metrics = {k: v.clone() for k, v in self.captured().items()}
                    self.state.step += 1
                else:
                    metrics = self.train_step(self.state, batch, self.generator)
                pending.append(metrics)
                step += 1  # completed steps: equals state.step, so save labels match contents

                if step % cfg.log_interval == 0:
                    self._flush_metrics(pending)
                    t_prev = self.boundaries[-1]
                    self._mark(step)
                    self.logger.logkv("step", step)
                    self.logger.logkv("ms_per_step", (self.boundaries[-1][1] - t_prev[1])
                                      / (step - t_prev[0]) * 1e3)
                    self.logged.append(self.logger.dumpkvs())

                if cfg.save_interval and step % cfg.save_interval == 0:
                    self._flush_metrics(pending)
                    self.save(step)
                    if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                        return self.state
            self._flush_metrics(pending)
            if self.ckpt is not None:
                self.save(step)
        return self.state

    def save(self, step: int) -> None:
        if self.ckpt is None:
            return
        if self.ckpt.latest_step() == step:
            # a relaunch of a finished run, or a SIGTERM right after a periodic save
            self.logger.log(f"checkpoint for step {step} already exists")
            return
        path = self.ckpt.save(step, self.state, self.generator)
        self.logger.log(f"saved checkpoint at step {step}: {path}")
