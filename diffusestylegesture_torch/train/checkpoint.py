"""Checkpoints of a training run, with true resume.

Port of `diffusestylegesture_tpu/train/checkpoint.py` (orbax there; torch
files here). `<directory>/<step>/` holds

* `model.pt`: the model's state_dict in the reference layout, which
  `cli/sample.py --model_path <directory>/<step>` serves;
* `model_ema.pt`: the EMA weights, when the run keeps them;
* `train_state.pt`: step, optimizer (moments by parameter name, count), the
  loss-aware sampler's history and the train generator's state.

A step is written to a temporary directory and renamed into place, so a
crash leaves either the whole step or none of it; the oldest steps beyond
`max_to_keep` are removed. Loads use `weights_only=True`.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from .state import TrainState


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d,
                                                                     "train_state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             generator: Optional[torch.Generator] = None) -> str:
        final = os.path.join(self.directory, str(step))
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        try:
            torch.save(state.params.to_dict(state.params.data), os.path.join(tmp, "model.pt"))
            ema = state.ema_state_dict()
            if ema is not None:
                torch.save(ema, os.path.join(tmp, "model_ema.pt"))
            ts = state.state_dict()
            ts["generator"] = None if generator is None else generator.get_state()
            torch.save(ts, os.path.join(tmp, "train_state.pt"))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return final

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[Dict]:
        """Load `step` (the latest by default) into `state`; returns the saved
        train-state dict (its 'generator' entry included), or None if there is
        no step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.directory, str(step))
        load = lambda name: torch.load(os.path.join(d, name), map_location="cpu",  # noqa: E731
                                       weights_only=True)
        ts = load("train_state.pt")
        ema = load("model_ema.pt") if os.path.exists(os.path.join(d, "model_ema.pt")) else None
        state.load_state_dict(ts, load("model.pt"), ema)
        return ts


def save_params_npz(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Flat npz of a state_dict, keyed by parameter name (the reference's bare
    weight dumps, in an interchange format)."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state_dict.items()})


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}
