"""Rotary position embeddings, GPT-NeoX-style half rotation.

Port of `diffusestylegesture_tpu/models/rotary.py` (reference
`main/model/local_attention/rotary.py:6-25`). The denoiser rotates the
token embeddings themselves, in the packed (B·H, T, head_dim) layout,
before the local attention and before the transformer trunk. Angles,
cos and sin are computed in float32, once per (length, head dim, device):
`rotary_tables` caches them, so a denoiser call launches no kernel to
rebuild them, and a CUDA graph captured after the first call reads the
cached tables rather than recomputing them on every replay.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_tables: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def sinusoidal_freqs(n: int, dim: int, device=None) -> torch.Tensor:
    """(n, dim) angle table, frequencies duplicated across halves."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(n, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_tables(n: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of `sinusoidal_freqs(n, dim)`, computed at the first call for
    (n, dim, device) and kept. Built outside inference mode, so that a table
    made under `torch.inference_mode()` can still enter an autograd graph."""
    key = (n, dim, torch.device(device))
    tables = _tables.get(key)
    if tables is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            # a table made inside a capture would live in the graph's memory pool
            raise RuntimeError("rotary_tables: build the tables before a CUDA graph "
                               "capture (run the call once first)")
        with torch.inference_mode(False):
            freqs = sinusoidal_freqs(n, dim, device=device)
            tables = _tables[key] = (torch.cos(freqs), torch.sin(freqs))
    return tables


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    out = x.float() * cos + rotate_half(x).float() * sin
    return out.to(x.dtype)


def heads_split(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, D) → (B·heads, T, D/heads)."""
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2).reshape(B * heads, T, D // heads)


def heads_merge(x: torch.Tensor, B: int, heads: int) -> torch.Tensor:
    """(B·heads, T, hd) → (B, T, heads·hd)."""
    BH, T, hd = x.shape
    return x.reshape(B, heads, T, hd).transpose(1, 2).reshape(B, T, heads * hd)


def rope_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, D) → (B, T, heads, D/heads), each head rotated with the table for
    T: what `rope(heads_split(x, heads))` computes, element for element, left
    in the layout x has (no transposing copy)."""
    B, T, D = x.shape
    cos, sin = rotary_tables(T, D // heads, x.device)
    return apply_rotary(x.reshape(B, T, heads, D // heads), cos[:, None, :], sin[:, None, :])


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotate (•, T, d) with the table for x's length."""
    return apply_rotary(x, *rotary_tables(x.shape[1], x.shape[2], x.device))
