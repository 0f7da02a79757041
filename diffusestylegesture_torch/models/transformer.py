"""Post-norm transformer encoder with torch-1.9 semantics: the plain PyTorch
version of the CUDA kernel in `csrc/encoder_layer.cu`.

Port of `diffusestylegesture_tpu/models/transformer.py::TorchEncoderLayer`
(reference ``nn.TransformerEncoder(nn.TransformerEncoderLayer(...))``,
`main/model/mdm.py:77-86`): packed-QKV multi-head attention, residual +
LayerNorm (eps 1e-5), MLP with the configured activation, residual +
LayerNorm. Parameter names are nn.TransformerEncoderLayer's, so a
reference state_dict (and `nn.TransformerEncoderLayer` itself) loads as
it is. Batch-first (B, T, D).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = ("gelu", "gelu_tanh", "relu")


def activation_fn(name: str):
    """torch's F.gelu is the exact (erf) form; 'gelu_tanh' is the tanh approximation."""
    if name == "gelu":
        return F.gelu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r} (one of {ACTIVATIONS})")


class TorchMultiheadAttention(nn.Module):
    """`nn.MultiheadAttention` self-attention: packed (3D, D) in-projection, out-projection."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in (q, k, v))
        sim = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        out = torch.matmul(torch.softmax(sim, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class TorchEncoderLayer(nn.Module):
    """torch-1.9 `nn.TransformerEncoderLayer` (post-norm), inference."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu"):
        super().__init__()
        activation_fn(activation)  # validate early
        self.activation = activation
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        h = self.linear2(activation_fn(self.activation)(self.linear1(x)))
        return self.norm2(x + h)


class TorchTransformerEncoder(nn.Module):
    """Stack of `TorchEncoderLayer`s, no final norm (as the reference)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead, dim_feedforward, activation)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
        """impl="kernel": each layer through the CUDA kernel on a CUDA tensor
        (its plain version on a CPU tensor); impl="plain": plain everywhere."""
        if impl == "plain":
            for layer in self.layers:
                x = layer(x)
            return x
        if impl != "kernel":
            raise ValueError(f"unknown trunk impl {impl!r}")
        from ..ops.encoder_layer import encoder_layer

        for layer in self.layers:
            x = encoder_layer(x, layer)
        return x
