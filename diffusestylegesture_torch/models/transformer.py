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

`moe_experts > 0` swaps a layer's dense FFN for the Switch-routed
`models/moe.py::MoEFeedForward` (JAX `transformer.py:111-143`): attention and
both LayerNorms stay, and the layer runs these plain ops on every device,
since kernel B computes a dense FFN. The layer's load-balance loss goes into
the `aux` list the encoder is given (the JAX layer `sow`s it).

`TorchTransformerDecoder` is the torch-1.9 post-norm decoder of the
`trans_dec` MDM trunk (JAX `transformer.py:156-214`): self-attention,
cross-attention to the memory (one packed in-projection whose query rows
act on the frames and key/value rows on the memory), the FFN, each followed
by residual + LayerNorm, no final norm. No kernel computes it: it runs these
plain ops on every device.
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
                generator: Optional[torch.Generator] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-attention over x (B, T, D), or cross-attention to kv (B, S, D)
        when given: the q rows of the packed projection act on x, the k and v
        rows on kv."""
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        r = _operand(mxu_bf16)
        if kv is None:
            q, k, v = F.linear(r(x), r(self.in_proj_weight), self.in_proj_bias).chunk(3, dim=-1)
        else:
            q = F.linear(r(x), r(self.in_proj_weight[:D]), self.in_proj_bias[:D])
            k, v = F.linear(r(kv), r(self.in_proj_weight[D:]), self.in_proj_bias[D:]).chunk(2, -1)
        q = q.reshape(B, T, H, hd).transpose(1, 2)
        k, v = (t.reshape(B, t.shape[1], H, hd).transpose(1, 2) for t in (k, v))
        sim = torch.matmul(r(q), r(k).transpose(-1, -2)) * hd ** -0.5
        attn = dropout(torch.softmax(sim, dim=-1), p_drop, generator)
        out = torch.matmul(r(attn), r(v))
        return F.linear(r(out.transpose(1, 2).reshape(B, T, D)), r(self.out_proj.weight),
                        self.out_proj.bias)


def _ffn(layer: nn.Module, x: torch.Tensor, r, p: float,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    """linear1 → activation → dropout → linear2 of a dense post-norm layer."""
    h = F.linear(r(x), r(layer.linear1.weight), layer.linear1.bias)
    h = dropout(activation_fn(layer.activation)(h), p, generator)
    return F.linear(r(h), r(layer.linear2.weight), layer.linear2.bias)


class TorchEncoderLayer(nn.Module):
    """torch-1.9 `nn.TransformerEncoderLayer` (post-norm); `dropout` is the rate
    of its train-mode forward. `moe_experts > 0`: the FFN is a
    `MoEFeedForward` named `moe` (no `linear1` / `linear2`)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0):
        super().__init__()
        activation_fn(activation)  # validate early
        self.activation = activation
        self.dropout = dropout
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        if moe_experts > 0:
            from .moe import MoEFeedForward

            self.moe = MoEFeedForward(d_model, dim_feedforward, moe_experts, moe_capacity_factor,
                                      activation, dropout)
        else:
            self.moe = None
            self.linear1 = nn.Linear(d_model, dim_feedforward)
            self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, mxu_bf16: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """`aux`: a list the MoE layer appends its load-balance loss to."""
        p = self.dropout if train else 0.0
        x = self.norm1(x + dropout(self.self_attn(x, mxu_bf16, p, generator), p, generator))
        if self.moe is None:
            h = _ffn(self, x, _operand(mxu_bf16), p, generator)
        else:
            h, layer_aux = self.moe(x, mxu_bf16, train, generator)
            if aux is not None:
                aux.append(layer_aux)
        return self.norm2(x + dropout(h, p, generator))


class TorchTransformerEncoder(nn.Module):
    """Stack of `TorchEncoderLayer`s, no final norm (as the reference)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout, moe_experts,
                              moe_capacity_factor)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, impl: str = "kernel", mxu_bf16: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None,
                aux: Optional[list] = None) -> torch.Tensor:
        """impl="kernel": each dense layer through the CUDA kernel on a CUDA
        tensor (its plain version on a CPU tensor), each MoE layer through its
        plain ops (kernel B computes a dense FFN); impl="plain": plain
        everywhere. mxu_bf16: the bf16-operand mode of every layer (module
        docstring). train: the training forward, plain only (module
        docstring). aux: a list that collects each MoE layer's load-balance
        loss."""
        if impl == "plain":
            for layer in self.layers:
                x = layer(x, mxu_bf16, train, generator, aux)
            return x
        if impl != "kernel":
            raise ValueError(f"unknown trunk impl {impl!r}")
        if train:
            raise ValueError("train=True needs impl='plain': the encoder-layer kernel has no "
                             "backward (nor has the Pallas kernel it ports)")
        from ..ops.encoder_layer import encoder_layer

        for layer in self.layers:
            x = encoder_layer(x, layer, mxu_bf16) if layer.moe is None else \
                layer(x, mxu_bf16, aux=aux)
        return x


class TorchDecoderLayer(nn.Module):
    """torch-1.9 `nn.TransformerDecoderLayer` (post-norm): self-attention,
    cross-attention to the memory, FFN, each with residual + LayerNorm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        activation_fn(activation)  # validate early
        self.activation = activation
        self.dropout = dropout
        self.self_attn = TorchMultiheadAttention(d_model, nhead)
        self.multihead_attn = TorchMultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, mxu_bf16: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.dropout if train else 0.0
        x = self.norm1(x + dropout(self.self_attn(x, mxu_bf16, p, generator), p, generator))
        ca = self.multihead_attn(x, mxu_bf16, p, generator, kv=memory)
        x = self.norm2(x + dropout(ca, p, generator))
        return self.norm3(x + dropout(_ffn(self, x, _operand(mxu_bf16), p, generator), p,
                                      generator))


class TorchTransformerDecoder(nn.Module):
    """Stack of `TorchDecoderLayer`s, no final norm (torch's default)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchDecoderLayer(d_model, nhead, dim_feedforward, activation, dropout)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, memory: torch.Tensor, mxu_bf16: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, memory, mxu_bf16, train, generator)
        return x
