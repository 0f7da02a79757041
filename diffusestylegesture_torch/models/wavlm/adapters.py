"""WavLM → ZEGGS adapter.

Port of `diffusestylegesture_tpu/models/wavlm/adapters.py::make_zeggs_wavlm_fn`
(reference `main/mydiffusion_zeggs/sample.py:44-48`): raw windows →
`extract_features` → linear interpolation (align_corners) to n_poses
frames. The reference does NOT apply the checkpoint's `cfg.normalize` wav
layer-norm here; that quirk is kept.
"""
from __future__ import annotations

from typing import Callable

import torch

from .model import WavLM, interpolate_linear


def make_zeggs_wavlm_fn(n_poses: int = 88) -> Callable[[WavLM, torch.Tensor], torch.Tensor]:
    """Returns wavlm_apply(wavlm, windows (W, S)) → (W, n_poses, D)."""

    def apply(wavlm: WavLM, windows: torch.Tensor) -> torch.Tensor:
        return interpolate_linear(wavlm(windows), n_poses)

    return apply
