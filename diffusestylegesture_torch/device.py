"""Device resolution: CUDA unless the caller explicitly asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return the requested device, raising if it is a missing CUDA card.

    There is no silent fallback: a run that asked for the card and got the
    CPU would report CPU numbers under a device's name. On CUDA, TF32 is
    switched off for matmuls and cuDNN convolutions (cuDNN defaults to it),
    so f32 runs stay comparable with the JAX reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # "cuda" → "cuda:<current>", so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
