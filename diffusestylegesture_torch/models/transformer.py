"""Post-norm transformer encoder with torch-1.9 semantics: the plain PyTorch
version of the CUDA kernel in `csrc/encoder_layer.cu`.

Port of `diffusestylegesture_tpu/models/transformer.py::TorchEncoderLayer`
(reference ``nn.TransformerEncoder(nn.TransformerEncoderLayer(...))``,
`main/model/mdm.py:77-86`): packed-QKV multi-head attention, residual +
LayerNorm (eps 1e-5), MLP with the configured activation, residual +
LayerNorm. Parameter names are nn.TransformerEncoderLayer's, so a
reference state_dict (and `nn.TransformerEncoderLayer` itself) loads as
it is. Batch-first (B, T, D).

`mxu_bf16=True` is the port of the Pallas kernel's mode of that name: each
matmul operand (x, W_in, q, k, the softmax probabilities, v, the attention
output, W_out, y, W1, the activated hidden rows, W2) is rounded to bf16 and
the product is taken in float32. The default is float32 throughout.

`train=True` is the training forward (plain PyTorch ops with autograd): dropout
at the JAX layer's four places, the attention weights, after attention,
after the FFN activation and after the FFN (`transformer.py:88,136,149,151`),
its masks drawn from the `generator` passed in. The CUDA kernel has no
backward, in this package as in the JAX one, so training never takes it.
"""
from __future__ import annotations

from typing import Optional

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


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: each entry kept with probability 1 − p and scaled by
    1/(1 − p). The mask is drawn from `generator` (F.dropout would read the
    global generator) and autograd keeps only the boolean mask."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def _operand(mxu_bf16: bool):
    """The rounding of a matmul operand: to bf16 and back, or none."""
    return (lambda t: t.to(torch.bfloat16).float()) if mxu_bf16 else (lambda t: t)


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

    def forward(self, x: torch.Tensor, mxu_bf16: bool = False, p_drop: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        r = _operand(mxu_bf16)
        q, k, v = F.linear(r(x), r(self.in_proj_weight), self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in (q, k, v))
        sim = torch.matmul(r(q), r(k).transpose(-1, -2)) * hd ** -0.5
        attn = dropout(torch.softmax(sim, dim=-1), p_drop, generator)
        out = torch.matmul(r(attn), r(v))
        return F.linear(r(out.transpose(1, 2).reshape(B, T, D)), r(self.out_proj.weight),
                        self.out_proj.bias)


class TorchEncoderLayer(nn.Module):
    """torch-1.9 `nn.TransformerEncoderLayer` (post-norm); `dropout` is the rate
    of its train-mode forward."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        activation_fn(activation)  # validate early
        self.activation = activation
        self.dropout = dropout
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, mxu_bf16: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        r = _operand(mxu_bf16)
        p = self.dropout if train else 0.0
        x = self.norm1(x + dropout(self.self_attn(x, mxu_bf16, p, generator), p, generator))
        h = F.linear(r(x), r(self.linear1.weight), self.linear1.bias)
        h = dropout(activation_fn(self.activation)(h), p, generator)
        h = F.linear(r(h), r(self.linear2.weight), self.linear2.bias)
        return self.norm2(x + dropout(h, p, generator))


class TorchTransformerEncoder(nn.Module):
    """Stack of `TorchEncoderLayer`s, no final norm (as the reference)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, impl: str = "kernel", mxu_bf16: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """impl="kernel": each layer through the CUDA kernel on a CUDA tensor
        (its plain version on a CPU tensor); impl="plain": plain everywhere.
        mxu_bf16: the bf16-operand mode of every layer (module docstring).
        train: the training forward, plain only (module docstring)."""
        if impl == "plain":
            for layer in self.layers:
                x = layer(x, mxu_bf16, train, generator)
            return x
        if impl != "kernel":
            raise ValueError(f"unknown trunk impl {impl!r}")
        if train:
            raise ValueError("train=True needs impl='plain': the encoder-layer kernel has no "
                             "backward (nor has the Pallas kernel it ports)")
        from ..ops.encoder_layer import encoder_layer

        for layer in self.layers:
            x = encoder_layer(x, layer, mxu_bf16)
        return x
