"""Motion editing by diffusion inpainting.

Port of `diffusestylegesture_tpu/sample/edit.py` (the MDM editing modes of
`main/sample/edit.py`, `edit_mode in_between/upper_body`) on the port's
DDPM loop and its inpainting hook (`diffusion/sampling.py`, the
`inpaint=(mask, motion)` argument: the model's x0 prediction is replaced by
the reference motion where the mask is set, START_X only, ref
`gaussian_diffusion.py:317-324`).

Masks are (B, C, 1, T) booleans in the gesture models' layout:
  * `in_between_mask`: keep prefix / suffix frames, synthesize the middle;
  * `feature_mask`: keep a channel subset at every frame (the gesture analog
    of upper-body editing, e.g. the root slice of the 1141-d ZEGGS vector).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import SamplerConfig, Schedule, p_sample_loop

ZEGGS_ROOT_CHANNELS = tuple(range(13))  # root pos/rot/vel/vrt of the 1141-d layout


def in_between_mask(shape, prefix_frames: int, suffix_frames: int = 0,
                    device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """(B, C, 1, T) boolean on `device`: True = keep the reference motion."""
    T = shape[3]
    t = np.arange(T)
    keep = (t < prefix_frames) | (t >= T - suffix_frames)  # suffix 0 → an all-False term
    mask = np.broadcast_to(keep[None, None, None, :], shape)
    return torch.as_tensor(np.ascontiguousarray(mask), device=resolve_device(device))


def feature_mask(shape, keep_channels: Sequence[int],
                 device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """(B, C, 1, T) boolean on `device`: True on the given channel rows."""
    keep = np.zeros(shape[1], bool)
    keep[np.asarray(keep_channels, dtype=int)] = True  # () defaults to float64: invalid index
    mask = np.broadcast_to(keep[None, :, None, None], shape)
    return torch.as_tensor(np.ascontiguousarray(mask), device=resolve_device(device))


@torch.inference_mode()
def edit_motion(sched: Schedule, model_fn, reference_motion: torch.Tensor,
                inpainting_mask: torch.Tensor, generator: Optional[torch.Generator] = None,
                cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Resample the unmasked region conditioned on the kept one: the DDPM loop
    over `sched` with the reference motion (B, C, 1, T, normalized) in place of
    the x0 prediction where the mask is True. Runs where the schedule and the
    tensors lie (the card, unless the caller built them on the CPU)."""
    return p_sample_loop(sched, model_fn, tuple(reference_motion.shape), generator, cfg=cfg,
                         inpaint=(inpainting_mask, reference_motion))
