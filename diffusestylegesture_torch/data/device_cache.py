"""Training windows resident on the card, batches gathered there.

Port of `diffusestylegesture_tpu/data/device_cache.py`: the ZEGGS window set
(poses, styles, WavLM features) is copied to the device once, and each step
draws its batch indices with replacement from the train generator
(`torch.randint`) and gathers the rows there, so a step moves no data from
the host. Epochs become uniform sampling with replacement, the BEAT loader's
own `RandomSampler` behaviour (`h5_data_loader.py:71-77`). The BEAT/TWH
clip cache comes with the port's slice 4.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device


class DeviceWindowCache:
    """{name: (N, ...) array} on the device, rows gathered by `sample_batch`."""

    def __init__(self, arrays: Dict[str, np.ndarray], device: Union[str, torch.device] = "cuda"):
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

    @staticmethod
    def sample_batch(arrays: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                     batch_size: int) -> Dict[str, torch.Tensor]:
        """Uniform with-replacement row gather."""
        first = next(iter(arrays.values()))
        idx = torch.randint(0, first.shape[0], (batch_size,), generator=generator,
                            device=first.device)
        return {k: v.index_select(0, idx) for k, v in arrays.items()}

    @classmethod
    def from_zeggs(cls, dataset, device: Union[str, torch.device] = "cuda") -> "DeviceWindowCache":
        return cls({"motion": dataset.poses, "style": dataset.styles, "wavlm": dataset.wavlm},
                   device)


def make_device_data_train_step(sched, train_cfg, cond_builder, batch_size: int) -> Callable:
    """step(state, generator, arrays) → metrics: the batch indices are drawn
    first from `generator`, then the train step's own draws follow.
    `step.device_step` leaves out the host's step count, as the train step's
    does: it is what `cli/train.py --device_cache` captures into a CUDA graph."""
    from ..train.state import make_train_step

    inner = make_train_step(sched, train_cfg, cond_builder)

    def device_step(state, generator, arrays):
        return inner.device_step(state, DeviceWindowCache.sample_batch(arrays, generator,
                                                                       batch_size), generator)

    def step(state, generator, arrays):
        metrics = device_step(state, generator, arrays)
        state.step += 1
        return metrics

    step.device_step = device_step
    return step
