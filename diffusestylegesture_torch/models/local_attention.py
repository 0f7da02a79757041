"""Causal sliding-window (local) attention: the plain PyTorch version of the
CUDA kernel in `csrc/local_attention.cu`, and the dispatch between them.

Port of `diffusestylegesture_tpu/models/local_attention.py` (XLA path;
reference lucidrains `LocalAttention`, `local_attention.py:52-199`, with
``causal=True, look_backward=1, look_forward=0``): each w-token query
window attends to [previous window | own window]; window 0's previous keys
and values are -1.0 pads at position -1, so causal masking never removes
them and only the user mask (padded with False) does; scale D^-0.5,
-maxfloat masking, softmax in float32.

`exact_windowsize=True` also masks keys more than `window_size` positions
behind the query, and `autopad=True` zero-pads the sequence to a multiple of
the window (the mask, if any, with False) and cuts the output back: the
configuration of the `LocalTransformer` wrapper (`models/local_transformer.py`).
Kernel A computes only the denoisers' configuration (as the Pallas kernel,
which asserts `not exact_windowsize`), so these options are plain-only.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -torch.finfo(torch.float32).max


def _look_around(x: torch.Tensor, pad_value) -> torch.Tensor:
    """(B, W, w, ...) → (B, W, 2w, ...): previous window's tokens ++ own tokens."""
    pad = torch.full_like(x[:, :1], pad_value)
    prev = torch.cat([pad, x[:, :-1]], dim=1)
    return torch.cat([prev, x], dim=2)


def local_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
                          mask: Optional[torch.Tensor] = None, *, heads: int = 1,
                          exact_windowsize: bool = False, autopad: bool = False) -> torch.Tensor:
    """q, k, v: (B·H, N, D); mask: optional (B, N) bool key validity."""
    bh, n, d = q.shape
    w = window_size
    pad = (-n) % w if autopad else 0
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        if mask is not None:
            mask = torch.nn.functional.pad(mask.bool(), (0, pad), value=False)
        out = local_attention_plain(q, k, v, w, mask, heads=heads,
                                    exact_windowsize=exact_windowsize)
        return out[:, :n]
    if n % w:
        raise ValueError(f"sequence length {n} not divisible by window {w}")
    W = n // w
    scale = d ** -0.5

    bq = q.reshape(bh, W, w, d)
    bk = _look_around(k.reshape(bh, W, w, d), -1.0)
    bv = _look_around(v.reshape(bh, W, w, d), -1.0)

    pos = torch.arange(n, device=q.device).reshape(1, W, w)
    q_pos = pos[..., :, None]                          # (1, W, w, 1)
    k_pos = _look_around(pos, -1)[..., None, :]        # (1, W, 1, 2w)

    # float32 scores and softmax also under autocast (as the JAX path's f32
    # accumulation): -maxfloat has no bf16 value
    with torch.autocast(q.device.type, enabled=False):
        sim = torch.einsum("bwie,bwje->bwij", bq.float(), bk.float()) * scale
        causal = q_pos < k_pos
        if exact_windowsize:
            causal = causal | (q_pos > k_pos + w)
        sim = sim.masked_fill(causal, NEG_INF)
        if mask is not None:
            b = mask.shape[0]
            mw = _look_around(mask.reshape(b, W, w).bool(), False)      # (b, W, 2w)
            mw = mw[:, None, :, None, :].expand(b, heads, W, 1, 2 * w).reshape(bh, W, 1, 2 * w)
            sim = sim.masked_fill(~mw, NEG_INF)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bwij,bwje->bwie", attn, bv.float())
    return out.reshape(bh, n, d).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window_size: int,
                    mask: Optional[torch.Tensor] = None, *, heads: int = 1,
                    impl: str = "kernel", out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """impl="kernel": the CUDA kernel on a CUDA tensor (its plain version on
    a CPU tensor), which also takes strided or (B, H, N, D) q, k, v and writes
    into `out` when given (`ops/local_attention.py`); impl="plain": the plain
    version on any device, packed (B·H, N, D) tensors only."""
    if impl == "plain":
        if out is not None:
            raise ValueError("out= needs impl='kernel'")
        return local_attention_plain(q, k, v, window_size, mask, heads=heads)
    if impl != "kernel":
        raise ValueError(f"unknown local attention impl {impl!r}")
    from ..ops import local_attention as ops_local_attention

    return ops_local_attention.local_attention(q, k, v, window_size, mask, heads=heads, out=out)
