"""Training data resident on the card, batches gathered there.

Port of `diffusestylegesture_tpu/data/device_cache.py`: the dataset is copied
to the device once, and each step draws its batch from the train generator and
gathers it there, so a step moves no data from the host. Each cache carries
its own sampler (`sample_fn`):

* ZEGGS (`from_zeggs`): the window set (poses, styles, WavLM features), rows
  drawn with replacement (`sample_batch`);
* BEAT/TWH (`from_beat_twh`): whole clips (normalized gesture with its
  velocity and acceleration channels, fused text+audio features), padded to
  the longest; each batch element is a uniform clip and a uniform
  `n_poses`-frame crop of it (`sample_clip_batch`), the host loader's
  `SpeechGestureDataset.sample` with the reference's exclusive-high start.

Epochs become uniform sampling with replacement, the BEAT loader's own
`RandomSampler` behaviour (`h5_data_loader.py:71-77`). Under a mesh every
rank keeps the whole cache on its own card and gathers its rows of the
global batch there: the draws are made at the global batch
(`parallel/draws.py`), so the ranks' rows together are the unsharded run's
batch. Every sampler is
device-side tensor work with no host sync, so the step that calls it stays
one capturable CUDA graph.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import draws


Sampler = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator], int],
                   Dict[str, torch.Tensor]]


class DeviceWindowCache:
    """{name: (N, ...) array} on the device; `sample_fn(arrays, generator,
    batch_size)` draws a batch from them (default: `sample_batch`)."""

    def __init__(self, arrays: Dict[str, np.ndarray], device: Union[str, torch.device] = "cuda",
                 sample_fn: Optional[Sampler] = None):
        dev = resolve_device(device)
        self.arrays: Dict[str, torch.Tensor] = {}
        n = None
        for k, v in arrays.items():
            if v is None:
                continue
            t = torch.as_tensor(np.asarray(v)).to(dev)
            if n is not None and t.shape[0] != n:
                raise ValueError(f"{k}: {t.shape[0]} rows, the others have {n}")
            n = t.shape[0]
            self.arrays[k] = t
        self.n = n or 0
        self.sample_fn = sample_fn or DeviceWindowCache.sample_batch

    @staticmethod
    def sample_batch(arrays: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                     batch_size: int) -> Dict[str, torch.Tensor]:
        """Uniform with-replacement row gather."""
        first = next(iter(arrays.values()))
        idx = draws.randint(first.shape[0], (batch_size,), generator, first.device)
        return {k: v.index_select(0, idx) for k, v in arrays.items()}

    @classmethod
    def from_zeggs(cls, dataset, device: Union[str, torch.device] = "cuda") -> "DeviceWindowCache":
        return cls({"motion": dataset.poses, "style": dataset.styles, "wavlm": dataset.wavlm},
                   device)

    @staticmethod
    def crop_clips(arrays: Dict[str, torch.Tensor], idx: torch.Tensor, start: torch.Tensor,
                   n_poses: int) -> Dict[str, torch.Tensor]:
        """Frames start[b] … start[b] + n_poses − 1 of clip idx[b], by index
        arithmetic (one gather a tensor), and the clips' speakers."""
        rows = start[:, None] + torch.arange(n_poses, device=start.device)
        return {"motion": arrays["motion_clips"][idx[:, None], rows],
                "audio": arrays["audio_clips"][idx[:, None], rows],
                "style": arrays["style"].index_select(0, idx)}

    @staticmethod
    def sample_clip_batch(arrays: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                          batch_size: int, n_poses: int) -> Dict[str, torch.Tensor]:
        """BEAT/TWH batch: clip indices uniform with replacement, then per
        element a start uniform in [0, max(clip_len − n_poses, 1)) (the
        reference's exclusive high: the last crop is never drawn), cropped by
        `crop_clips`."""
        clip_len = arrays["clip_len"]
        idx = draws.randint(clip_len.shape[0], (batch_size,), generator, clip_len.device)
        hi = torch.clamp(clip_len.index_select(0, idx) - n_poses, min=1)
        # torch.randint takes no tensor high: floor(u · hi), u uniform in [0, 1)
        u = draws.rand((batch_size,), generator, clip_len.device, torch.float64)
        start = torch.minimum((u * hi).floor().long(), hi - 1)
        return DeviceWindowCache.crop_clips(arrays, idx, start, n_poses)

    @classmethod
    def from_beat_twh(cls, dataset, device: Union[str, torch.device] = "cuda"
                      ) -> "DeviceWindowCache":
        """The clips of a `SpeechGestureDataset`, zero-padded to the longest,
        with their lengths; batches are `sample_clip_batch` crops. Every clip
        must hold `n_poses` frames (the host loader tile-pads short clips)."""
        lens = np.array([len(g) for g in dataset.gesture], np.int64)
        if (lens < dataset.n_poses).any():
            raise ValueError(
                f"the device cache needs every clip to hold n_poses = {dataset.n_poses} frames "
                f"(the shortest holds {lens.min()}; the host loader tile-pads short clips): "
                "drop --device_cache or the short clips")
        t_max = int(lens.max())

        def pad(xs):
            return np.stack([np.pad(x, ((0, t_max - len(x)), (0, 0))) for x in xs])

        return cls({"motion_clips": pad(dataset.gesture), "audio_clips": pad(dataset.textaudio),
                    "style": np.stack(dataset.speaker), "clip_len": lens}, device,
                   sample_fn=functools.partial(cls.sample_clip_batch, n_poses=dataset.n_poses))


def make_device_data_train_step(sched, train_cfg, cond_builder, batch_size: int,
                                sample_fn: Optional[Sampler] = None) -> Callable:
    """step(state, generator, arrays) → metrics: the batch is drawn first from
    `generator` by `sample_fn` (default `DeviceWindowCache.sample_batch`; pass
    the cache's `sample_fn`), then the train step's own draws follow. Under a
    mesh (`state.plan`) `batch_size` is the global batch and this rank draws
    and gathers its rows.
    `step.device_step` leaves out the host's step count, as the train step's
    does: it is what `cli/train.py --device_cache` captures into a CUDA graph."""
    from ..train.state import make_train_step

    inner = make_train_step(sched, train_cfg, cond_builder)
    sample_fn = sample_fn or DeviceWindowCache.sample_batch

    def device_step(state, generator, arrays):
        rows = batch_size if state.plan is None else batch_size // state.plan.data_size
        gen = generator if state.plan is None else state.plan.draws(generator, rows)
        return inner.device_step(state, sample_fn(arrays, gen, rows), generator)

    def step(state, generator, arrays):
        metrics = device_step(state, generator, arrays)
        state.step += 1
        return metrics

    step.device_step = device_step
    return step
