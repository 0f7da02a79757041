"""Plain float32 building blocks of the references, over dicts of weights.

Nothing here imports the measured program: every forward is written out from
the published model description (reference repository `main/model/mdm.py`,
`BEAT-TWH-main/model/mdm.py`, WavLM's `modules.py`) and reads the weights
the benchmark made (`perfbench/harness/weights.py`), by the reference
module's parameter names.

`Precision` is how matmul and convolution operands are rounded. "float32"
leaves them alone (run with TF32 switched off); "tf32" rounds every operand
to TF32's 10-bit mantissa before the float32 product, which is what a TF32
tensor core computes. The second is the control of the benchmark's
correctness check: the nearest precision below the float32 the
configurations state.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties to even), as float32."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)


class Precision:
    """The rounding applied to every matmul / convolution operand."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown reference precision {name!r} (float32 or tf32)")
        self.name = name
        self._weights: Dict[int, tuple] = {}

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self.name == "tf32" else t

    def weight(self, t: torch.Tensor) -> torch.Tensor:
        """A weight's rounding, made once per weight tensor."""
        if self.name == "float32":
            return t
        got = self._weights.get(id(t))
        if got is None or got[0] is not t:
            got = self._weights[id(t)] = (t, round_tf32(t))
        return got[1]


def no_tf32() -> None:
    """The references' products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(x: torch.Tensor, w: Weights, name: str, p: Precision) -> torch.Tensor:
    return F.linear(p(x), p.weight(w[name + ".weight"]), w.get(name + ".bias"))


def layer_norm(x: torch.Tensor, w: Weights, name: str, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"], eps)


def sinusoidal_table(n: int, d: int, device) -> torch.Tensor:
    """The interleaved sin/cos table of MDM's PositionalEncoding, (n, d), in
    float32 on the host as the upstream module builds it."""
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2).float() * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(device)


def timestep_embedding(t: torch.Tensor, table: torch.Tensor, w: Weights,
                       p: Precision) -> torch.Tensor:
    """PositionalEncoding lookup → Linear → SiLU → Linear (`TimestepEmbedder`);
    `table` from `sinusoidal_table`."""
    h = F.silu(linear(table[t], w, "embed_timestep.time_embed.0", p))
    return linear(h, w, "embed_timestep.time_embed.2", p)


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half rotation, over (…, T, d) with positions 0..T-1."""
    T, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.outer(torch.arange(T, dtype=torch.float32, device=x.device), inv)
    ang = torch.cat([ang, ang], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * torch.cos(ang) + torch.cat([-x2, x1], dim=-1) * torch.sin(ang)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)          # (B, H, T, hd)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def local_attention(x: torch.Tensor, window: int, p: Precision) -> torch.Tensor:
    """lucidrains LocalAttention(causal, look_backward=1, look_forward=0) with
    q = k = v = x (B, H, T, hd) under an all-True `mask_local` (what the
    samplers pass): window i's queries see window i-1 and their own window
    causally; window 0's previous window is padding, which the key mask
    (padded with False by `look_around`) removes."""
    B, H, T, d = x.shape
    W = T // window
    if W * window != T:
        raise ValueError(f"length {T} is not a multiple of the window {window}")
    q = x.reshape(B, H, W, window, d)
    prev = torch.cat([torch.full_like(q[:, :, :1], -1.0), q[:, :, :-1]], dim=2)
    kv = torch.cat([prev, q], dim=3)                                   # (B, H, W, 2w, d)
    sim = torch.matmul(p(q), p(kv).transpose(-1, -2)) * d ** -0.5
    qpos = torch.arange(window, device=x.device)[:, None] + window     # own window: w..2w-1
    kpos = torch.arange(2 * window, device=x.device)[None, :]
    pad = torch.zeros(W, 1, 2 * window, dtype=torch.bool, device=x.device)
    pad[0, 0, :window] = True                                          # window 0's pads
    hidden = (kpos > qpos)[None] | pad
    sim = sim.masked_fill(hidden, -torch.finfo(torch.float32).max)
    out = torch.matmul(p(torch.softmax(sim, dim=-1)), p(kv))
    return out.reshape(B, H, T, d)


def encoder_layer(x: torch.Tensor, w: Weights, name: str, heads: int, p: Precision) -> torch.Tensor:
    """torch's post-norm `nn.TransformerEncoderLayer` (GELU, LayerNorm eps 1e-5),
    batch-first, no dropout."""
    B, T, D = x.shape
    hd = D // heads
    qkv = F.linear(p(x), p.weight(w[name + ".self_attn.in_proj_weight"]),
                   w[name + ".self_attn.in_proj_bias"])
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    att = torch.softmax(torch.matmul(p(q), p(k).transpose(-1, -2)) * hd ** -0.5, dim=-1)
    a = merge_heads(torch.matmul(p(att), p(v)))
    x = layer_norm(x + linear(a, w, name + ".self_attn.out_proj", p), w, name + ".norm1")
    h = F.gelu(linear(x, w, name + ".linear1", p))
    return layer_norm(x + linear(h, w, name + ".linear2", p), w, name + ".norm2")


def local_then_trunk(token: torch.Tensor, cat: torch.Tensor, w: Weights, cfg: dict,
                     p: Precision) -> torch.Tensor:
    """The denoisers' shared body: Linear(cat) → RoPE over the `local_heads`
    rotary heads → local attention → [token ; frames] → RoPE over the same
    rotary heads (upstream's `num_head`, 8: `xseq.view(bs, nframes + 1,
    self.num_head, -1)`) → the encoder layers (`num_heads` attention heads)
    → frames → pose features (B, T, njoints)."""
    h = linear(cat, w, "input_process2", p)
    hh = rope(split_heads(h, cfg["local_heads"]))
    h = merge_heads(local_attention(hh, cfg["window_size"], p))
    seq = torch.cat([token[:, None, :], h], dim=1)
    seq = merge_heads(rope(split_heads(seq, cfg["local_heads"])))
    for i in range(cfg["num_layers"]):
        seq = encoder_layer(seq, w, f"seqTransEncoder.layers.{i}", cfg["num_heads"], p)
    return linear(seq[:, 1:], w, "output_process.poseFinal", p)


def interpolate_frames(x: torch.Tensor, size: int) -> torch.Tensor:
    """Linear interpolation with aligned corners along time: (B, T, C) → (B, size, C)."""
    return F.interpolate(x.transpose(1, 2), size=size, mode="linear",
                         align_corners=True).transpose(1, 2)


def linear_layout(name: str, n_out: int, n_in: int) -> list:
    return [(name + ".weight", (n_out, n_in), n_in, 0.0), (name + ".bias", (n_out,), 0, 0.0)]


def norm_layout(name: str, d: int) -> list:
    return [(name + ".weight", (d,), 0, 1.0), (name + ".bias", (d,), 0, 0.0)]


def trunk_layout(cfg: dict) -> list:
    """The encoder layers' weights, by `nn.TransformerEncoderLayer`'s names."""
    D, F = cfg["latent_dim"], cfg["ff_size"]
    out = []
    for i in range(cfg["num_layers"]):
        n = f"seqTransEncoder.layers.{i}"
        out += ([(n + ".self_attn.in_proj_weight", (3 * D, D), D, 0.0),
                 (n + ".self_attn.in_proj_bias", (3 * D,), 0, 0.0)]
                + linear_layout(n + ".self_attn.out_proj", D, D)
                + linear_layout(n + ".linear1", F, D) + linear_layout(n + ".linear2", D, F)
                + norm_layout(n + ".norm1", D) + norm_layout(n + ".norm2", D))
    return out
