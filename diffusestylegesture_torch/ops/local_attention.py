"""Wrapper of the windowed causal local-attention CUDA kernel
(`csrc/local_attention.cu`, the port of `ops/local_attention_pallas.py`).

A CPU tensor goes to the plain PyTorch version
(`models/local_attention.py::local_attention_plain`); a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.local_attention import local_attention_plain
from . import build

MAX_WINDOW = 32
MAX_DIM = 128

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("local_attention").dsg_local_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
                    mask: Optional[torch.Tensor] = None, *, heads: int = 1) -> torch.Tensor:
    """q, k, v: (B·H, N, D) float32; mask: optional (B, N) bool (True = attend)."""
    if q.device.type == "cpu":
        return local_attention_plain(q, k, v, window_size, mask, heads=heads)
    if q.device.type != "cuda":
        raise ValueError(f"local_attention: unsupported device {q.device}")
    bh, n, d = q.shape
    w = int(window_size)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32 or t.shape != q.shape:
            raise ValueError(f"local_attention: {name} must be float32 {tuple(q.shape)} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"local_attention: {name} must be contiguous")
    if not (1 <= w <= MAX_WINDOW and n % w == 0):
        raise ValueError(f"local_attention: window {w} must be in [1, {MAX_WINDOW}] and divide N={n}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"local_attention: head dim {d} must be in [1, {MAX_DIM}]")
    mask_u8 = None
    if mask is not None:
        if mask.shape != (bh // heads, n) or bh % heads or mask.device != q.device:
            raise ValueError(f"local_attention: mask must be ({bh // heads}, {n}) on {q.device}")
        mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask_u8 is None else mask_u8.data_ptr(), out.data_ptr(),
                    bh, n, w, d, heads, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"local_attention kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
