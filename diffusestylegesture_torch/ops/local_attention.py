"""Wrapper of the windowed causal local-attention CUDA kernel
(`csrc/local_attention.cu`, the port of `ops/local_attention_pallas.py`).

A CPU tensor goes to the plain PyTorch version
(`models/local_attention.py::local_attention_plain`); a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches. The
kernel has no backward: on a CUDA tensor the wrapper raises when autograd is
on and q, k, v or `out` requires grad (training runs `impl="plain"`).

q, k and v may be packed `(B·H, N, D)` or unpacked `(B, H, N, D)`, with any
strides on the batch, head and position axes (the feature axis is
unit-stride): the kernel reads them where they lie, so the `(B, H, N, D)`
view of a `(B, N, H·D)` activation needs no copy, and `out=` may be such a
view too, which leaves the result merged. When q, k and v are one tensor the
kernel loads it once. The wrapper launches nothing but the kernel, does not
synchronise, and allocates only `out` when none is given.

`launch_empty`, and the library's `dsg_local_attention_smem_bytes` and
`dsg_local_attention_phases`, serve `chip_smoke.py` and
`scripts/local_attention_timing.py` only: nothing in the package calls them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..models.local_attention import local_attention_plain
from . import build

MAX_WINDOW = 32
MAX_DIM = 128
MAX_GRID = 65535  # batch and heads are grid axes

# dsg_local_attention(q, k, v, mask, out, batch, heads, n, w, d,
#                     3 strides each of q, k, v, out, alias, scale, stream)
KERNEL_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

launches = 0
_fn = None
_empty_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("local_attention").dsg_local_attention
        fn.argtypes = KERNEL_ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch_empty(batch: int, heads: int, n: int, window_size: int, d: int,
                 device: torch.device) -> None:
    """Launches an empty kernel with the kernel's grid, block, shared memory and
    launch attributes at these shapes: the launch alone, for the timing scripts.
    Not counted in `launches`."""
    global _empty_fn
    if _empty_fn is None:
        fn = build.load("local_attention").dsg_local_attention_empty
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _empty_fn = fn
    with torch.cuda.device(device):
        err = _empty_fn(batch, heads, n, window_size, d,
                        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"local_attention empty launch failed: CUDA error {err}")


def _geometry(name: str, t: torch.Tensor, heads: int) -> Tuple[Tuple[int, int, int, int],
                                                               Tuple[int, int, int]]:
    """((B, H, N, D), element strides of the batch, head and position axes)."""
    if t.dim() == 4:
        shape, (sb, sh, sn, sd) = tuple(t.shape), t.stride()
        if shape[1] != heads:
            raise ValueError(f"local_attention: {name} has {shape[1]} heads, heads={heads}")
    elif t.dim() == 3:
        bh, n, d = t.shape
        if bh % heads:
            raise ValueError(f"local_attention: {name}'s {bh} rows do not divide into {heads} heads")
        s0, sn, sd = t.stride()
        shape, sb, sh = (bh // heads, heads, n, d), heads * s0, s0
    else:
        raise ValueError(f"local_attention: {name} must be (B·H, N, D) or (B, H, N, D)")
    if t.dtype != torch.float32:
        raise ValueError(f"local_attention: {name} must be float32")
    if shape[3] > 1 and sd != 1:
        raise ValueError(f"local_attention: {name}'s feature axis must be unit-stride")
    return shape, (sb, sh, sn)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
                    mask: Optional[torch.Tensor] = None, *, heads: int = 1,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B·H, N, D) or (B, H, N, D) float32, strided as they come;
    mask: optional contiguous (B, N) bool (True = attend); out: optional
    tensor of q's logical shape to write into. Returns `out`, or a new
    contiguous tensor of q's shape."""
    shape, sq = _geometry("q", q, heads)
    B, H, n, d = shape
    w = int(window_size)
    strides = [sq]
    for name, t in (("k", k), ("v", v)) + ((("out", out),) if out is not None else ()):
        t_shape, t_strides = _geometry(name, t, heads)
        if t_shape != shape or t.device != q.device:
            raise ValueError(f"local_attention: {name} must be {shape} on {q.device}, "
                             f"got {t_shape} on {t.device}")
        strides.append(t_strides)
    if mask is not None:
        if mask.dtype != torch.bool or not mask.is_contiguous():
            raise ValueError("local_attention: mask must be a contiguous bool tensor "
                             f"(got {mask.dtype}, strides {mask.stride()})")
        if mask.shape != (B, n) or mask.device != q.device:
            raise ValueError(f"local_attention: mask must be ({B}, {n}) on {q.device}")

    if q.device.type == "cpu":
        res = local_attention_plain(q.reshape(B * H, n, d), k.reshape(B * H, n, d),
                                    v.reshape(B * H, n, d), w, mask, heads=H)
        if out is None:
            return res.reshape(q.shape)
        out.copy_(res.reshape(out.shape))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"local_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, out)):
        raise RuntimeError(
            "local_attention: the CUDA kernel has no backward, and q, k, v or out require "
            "grad; training uses impl='plain' (or call under torch.no_grad())")
    if not (1 <= w <= MAX_WINDOW and n % w == 0):
        raise ValueError(f"local_attention: window {w} must be in [1, {MAX_WINDOW}] and divide N={n}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"local_attention: head dim {d} must be in [1, {MAX_DIM}]")
    if B > MAX_GRID or H > MAX_GRID:
        raise ValueError(f"local_attention: batch {B} and heads {H} must be at most {MAX_GRID}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        strides.append(_geometry("out", out, heads)[1])
    alias = (q.data_ptr() == k.data_ptr() == v.data_ptr()) and strides[0] == strides[1] == strides[2]
    with torch.cuda.device(q.device):  # the kernel opts in and launches on q's card
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        None if mask is None else mask.data_ptr(), out.data_ptr(),
                        B, H, n, w, d, *strides[0], *strides[1], *strides[2], *strides[3],
                        int(alias), d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"local_attention kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
