"""Seeded weights made on the device in one draw.

A layout is a list of (name, shape, fan_in, offset): every weight of every
layout given comes from ONE `torch.randn` over their total size on a device
generator seeded from the run's seed, then each leaf is scaled in place:
N(0, 1/fan_in) where there is a fan-in, else offset + N(0, 0.1²) (gains sit
at 1). The same seed gives the same weights on the same device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def make(layouts: Sequence[List[tuple]], seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """One dict of name → tensor (views of one flat buffer) per layout."""
    total = sum(math.prod(shape) for lay in layouts for _, shape, _, _ in lay)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = [], 0
    for lay in layouts:
        d = {}
        for name, shape, fan_in, offset in lay:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            leaf.mul_(fan_in ** -0.5 if fan_in else 0.1).add_(offset)
            d[name] = leaf
            at += n
        out.append(d)
    return out
