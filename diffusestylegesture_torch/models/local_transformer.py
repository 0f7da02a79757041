"""Autoregressive token transformer with windowed local attention.

Port of `diffusestylegesture_tpu/models/local_transformer.py` (the vendored
lucidrains `LocalTransformer`, `main/model/local_attention/transformer.py:
34-180`, with the JAX package's repairs: heads packed before the attention
call, as upstream does, and autopad): prenorm `LocalMHA` blocks (packed QKV
without biases, causal local attention with `exact_windowsize`), a GEGLU
feed-forward, learned absolute position embeddings, an output head,
cross-entropy with `ignore_index`, and top-k autoregressive `generate`.
LayerNorms use flax's epsilon, 1e-6, and the GEGLU gate the exact GELU, as
the JAX module.

The attention runs `models/local_attention.py::local_attention_plain` with
`exact_windowsize=True, autopad=True` on every device: kernel A computes only
the denoisers' configuration (the Pallas kernel it ports asserts
`not exact_windowsize`, JAX `models/local_attention.py:76`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .local_attention import local_attention_plain

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class LocalMHA(nn.Module):
    """`transformer.py:34-77`: prenorm packed-QKV causal local attention."""

    def __init__(self, dim: int, window_size: int, dim_head: int = 64, heads: int = 8,
                 prenorm: bool = False, exact_windowsize: bool = True):
        super().__init__()
        self.window_size, self.dim_head, self.heads = window_size, dim_head, heads
        self.exact_windowsize = exact_windowsize
        inner = dim_head * heads
        self.norm = nn.LayerNorm(dim, eps=LN_EPS) if prenorm else None
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        H, d = self.heads, self.dim_head
        if self.norm is not None:
            x = self.norm(x)

        def heads_first(t):  # 'b n (h d) -> (b h) n d'
            return t.reshape(B, N, H, d).transpose(1, 2).reshape(B * H, N, d)

        q, k, v = map(heads_first, self.to_qkv(x).chunk(3, dim=-1))
        out = local_attention_plain(q, k, v, self.window_size, mask, heads=H,
                                    exact_windowsize=self.exact_windowsize, autopad=True)
        return self.to_out(out.reshape(B, H, N, d).transpose(1, 2).reshape(B, N, H * d))


class GEGLUFeedForward(nn.Module):
    """`transformer.py:80-94`: LayerNorm → Linear(2·inner) → x·gelu(gate) → Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, inner * 2, bias=False)
        self.linear2 = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.linear1(self.norm(x)).chunk(2, dim=-1)
        return self.linear2(h * F.gelu(gate))


class LocalTransformer(nn.Module):
    """`transformer.py:98-180`: forward(tokens, mask=None, return_loss=False)
    → logits (B, N, num_tokens), or the next-token cross-entropy."""

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int, depth: int,
                 local_attn_window_size: int = 512, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, ignore_index: int = -1):
        super().__init__()
        self.max_seq_len, self.ignore_index = max_seq_len, ignore_index
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.attn = nn.ModuleList(
            LocalMHA(dim, local_attn_window_size, dim_head, heads, prenorm=True)
            for _ in range(depth))
        self.ff = nn.ModuleList(GEGLUFeedForward(dim, ff_mult) for _ in range(depth))
        self.to_logits_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_logits = nn.Linear(dim, num_tokens, bias=False)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_loss: bool = False) -> torch.Tensor:
        if return_loss:
            tokens, labels = tokens[:, :-1], tokens[:, 1:]
            if mask is not None:
                mask = mask[:, :-1]  # aligned with the sliced input
        n = tokens.shape[1]
        if n > self.max_seq_len:
            raise ValueError(f"sequence of {n} tokens longer than max_seq_len {self.max_seq_len}")
        x = self.token_emb(tokens) + self.pos_emb(torch.arange(n, device=tokens.device))
        for attn, ff in zip(self.attn, self.ff):
            x = attn(x, mask) + x
            x = ff(x) + x
        logits = self.to_logits(self.to_logits_norm(x))
        if not return_loss:
            return logits
        return cross_entropy_ignore(logits, labels, self.ignore_index)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """`F.cross_entropy(..., ignore_index=)`: the mean NLL over kept targets
    (0 when every target is ignored, as the JAX function)."""
    logp = torch.log_softmax(logits, dim=-1)
    keep = labels != ignore_index
    nll = -logp.gather(-1, torch.where(keep, labels, 0)[..., None])[..., 0]
    return (nll * keep).sum() / keep.sum().clamp(min=1)


def top_k_filter(logits: torch.Tensor, thres: float = 0.9) -> torch.Tensor:
    """`transformer.py:25-30`: keep the top max(1, (1 − thres)·vocab) logits,
    −inf elsewhere (k ≥ 1, as the JAX function)."""
    k = max(1, int((1 - thres) * logits.shape[-1]))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def generate(model: LocalTransformer, prime: torch.Tensor, seq_len: int,
             generator: Optional[torch.Generator] = None, temperature: float = 1.0,
             filter_thres: float = 0.9,
             categorical: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """Autoregressive top-k sampling (`transformer.py:133-157`): crop the
    context to `max_seq_len`, filter the last position's logits, draw,
    append; returns the generated suffix (B, seq_len). `categorical(logits)`
    → (B,) tokens replaces the draw (a test replays another sampler's);
    by default one `torch.multinomial` from `generator`."""
    if categorical is None:
        def categorical(logits):
            return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]

    n = prime.shape[1]
    out = prime
    with torch.no_grad():
        for _ in range(seq_len):
            logits = model(out[:, -model.max_seq_len:])
            filtered = top_k_filter(logits[:, -1], thres=filter_thres)
            out = torch.cat([out, categorical(filtered / temperature)[:, None].to(out.dtype)],
                            dim=-1)
    return out[:, n:]
