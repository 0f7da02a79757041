"""Precision helpers for serving (port of `diffusestylegesture_tpu/utils/precision.py`)."""
from __future__ import annotations

import torch


def bf16_cast(tree):
    """Cast every float32 tensor of a state dict or nested dict / list / tuple
    to bfloat16; other dtypes and non-tensors pass through."""
    if torch.is_tensor(tree):
        return tree.to(torch.bfloat16) if tree.dtype == torch.float32 else tree
    if isinstance(tree, dict):
        return type(tree)((k, bf16_cast(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(bf16_cast(v) for v in tree)
    return tree
