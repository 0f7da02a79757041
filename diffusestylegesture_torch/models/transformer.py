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

The parallel slice (`parallel/`): `split_qkv=True` stores the in-projection
as q / k / v Linears (kernel B reads their concatenation, made once); a
`parallel.tp.TPGroup` on the encoder runs each layer Megatron-style (this
rank's heads and hidden units, an all-reduce after out_proj and after
linear2); a `Pipe` runs the layers GPipe-pipelined over a `pipe` group, or
recomputed in the backward (`remat`). Every draw goes through
`parallel/draws.py`, so a rank holding part of the batch, of the heads or of
the hidden units draws what the unsharded layer draws for them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm, draws

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


def dropout(x: torch.Tensor, p: float, generator: draws.Draws,
            shard: Optional[Tuple[int, int, slice]] = None) -> torch.Tensor:
    """flax `nn.Dropout`: each entry kept with probability 1 − p and scaled by
    1/(1 − p). The mask is drawn from `generator` (F.dropout would read the
    global generator; a `parallel.draws.GlobalDraws` draws at the global
    batch) and autograd keeps only the boolean mask. `shard` = (dim, full
    size, slice): x holds that slice of dimension `dim` (a tensor-parallel
    rank's heads or hidden units); the mask is drawn at the full size and cut,
    so every rank draws what the unsharded layer draws."""
    if p == 0.0:
        return x
    if shard is None:
        u = draws.rand(x.shape, generator, x.device)
    else:
        dim, full, sl = shard
        shape = list(x.shape)
        shape[dim] = full
        u = draws.rand(shape, generator, x.device).narrow(dim, sl.start, sl.stop - sl.start)
    return torch.where(u >= p, x / (1.0 - p), 0.0)


def _operand(mxu_bf16: bool):
    """The rounding of a matmul operand: to bf16 and back, or none."""
    return (lambda t: t.to(torch.bfloat16).float()) if mxu_bf16 else (lambda t: t)


class TorchMultiheadAttention(nn.Module):
    """`nn.MultiheadAttention` self-attention: packed (3D, D) in-projection,
    out-projection. `split_qkv=True` keeps the in-projection as three (D, D)
    Linears `q_proj`, `k_proj`, `v_proj` (the JAX `split_qkv` layout; the same
    function, converted both ways by `parallel.tp.split_qkv_params` /
    `merge_qkv_params`)."""

    def __init__(self, embed_dim: int, num_heads: int, split_qkv: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.split_qkv = embed_dim, num_heads, split_qkv
        packed = torch.empty(3 * embed_dim, embed_dim)
        nn.init.xavier_uniform_(packed)
        if split_qkv:
            # the packed init's draws only: a split model built from a seed holds
            # the weights of the packed one built from it
            for name, w in zip(("q_proj", "k_proj", "v_proj"), packed.chunk(3)):
                with torch.random.fork_rng(devices=[]):
                    lin = nn.Linear(embed_dim, embed_dim)
                with torch.no_grad():
                    lin.weight.copy_(w)
                    lin.bias.zero_()
                setattr(self, name, lin)
        else:
            self.in_proj_weight = nn.Parameter(packed)
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.zeros_(self.out_proj.bias)
        self._packed = None

    def qkv_parts(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """((W_q, b_q), (W_k, b_k), (W_v, b_v)), each weight (D, D): views of the
        packed projection, or the split Linears' parameters."""
        if self.split_qkv:
            return tuple((m.weight, m.bias) for m in (self.q_proj, self.k_proj, self.v_proj))
        return tuple(zip(self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)))

    def packed_in_proj(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The packed (3D, D) weight and (3D,) bias: the parameters themselves,
        or for the split layout their concatenation, made once and again only
        after a parameter changes (kernel B reads it at every call)."""
        if not self.split_qkv:
            return self.in_proj_weight, self.in_proj_bias
        params = [t for pair in self.qkv_parts() for t in pair]
        key = tuple((t.data_ptr(), t._version) for t in params)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                w = torch.cat([params[0], params[2], params[4]]).contiguous()
                b = torch.cat([params[1], params[3], params[5]]).contiguous()
            self._packed = (key, w, b)
        return self._packed[1], self._packed[2]

    def forward(self, x: torch.Tensor, mxu_bf16: bool = False, p_drop: float = 0.0,
                generator: draws.Draws = None, kv: Optional[torch.Tensor] = None,
                tp=None) -> torch.Tensor:
        """Self-attention over x (B, T, D), or cross-attention to kv (B, S, D)
        when given: the q rows of the packed projection act on x, the k and v
        rows on kv. `tp` (a `parallel.tp.TPGroup`): this rank computes its
        heads only and the out-projection's partial sums are all-reduced."""
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        r = _operand(mxu_bf16)
        if tp is not None:
            return self._tensor_parallel(x, r, p_drop, generator, tp)
        if kv is None and not self.split_qkv:
            q, k, v = F.linear(r(x), r(self.in_proj_weight), self.in_proj_bias).chunk(3, dim=-1)
        elif kv is None:
            q, k, v = (F.linear(r(x), r(w), b) for w, b in self.qkv_parts())
        else:
            (wq, bq), (wk, bk), (wv, bv) = self.qkv_parts()
            q = F.linear(r(x), r(wq), bq)
            if self.split_qkv:
                k, v = F.linear(r(kv), r(wk), bk), F.linear(r(kv), r(wv), bv)
            else:
                k, v = F.linear(r(kv), r(self.in_proj_weight[D:]),
                                self.in_proj_bias[D:]).chunk(2, -1)
        q = q.reshape(B, T, H, hd).transpose(1, 2)
        k, v = (t.reshape(B, t.shape[1], H, hd).transpose(1, 2) for t in (k, v))
        sim = torch.matmul(r(q), r(k).transpose(-1, -2)) * hd ** -0.5
        attn = dropout(torch.softmax(sim, dim=-1), p_drop, generator)
        out = torch.matmul(r(attn), r(v))
        return F.linear(r(out.transpose(1, 2).reshape(B, T, D)), r(self.out_proj.weight),
                        self.out_proj.bias)

    def _tensor_parallel(self, x, r, p_drop, generator, tp) -> torch.Tensor:
        """Megatron self-attention over the `model` group (`parallel/tp.py`)."""
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        heads = tp.slice(H)
        hl = heads.stop - heads.start
        rows = slice(heads.start * hd, heads.stop * hd)
        xin = comm.copy_to(x, tp.group)
        q, k, v = (F.linear(r(xin), r(w[rows]), b[rows]).reshape(B, T, hl, hd).transpose(1, 2)
                   for w, b in self.qkv_parts())
        sim = torch.matmul(r(q), r(k).transpose(-1, -2)) * hd ** -0.5
        attn = dropout(torch.softmax(sim, dim=-1), p_drop, generator, (1, H, heads))
        out = torch.matmul(r(attn), r(v)).transpose(1, 2).reshape(B, T, hl * hd)
        partial = F.linear(r(out), r(self.out_proj.weight[:, rows]))
        return comm.reduce_from(partial, tp.group) + self.out_proj.bias


def _ffn(layer: nn.Module, x: torch.Tensor, r, p: float, generator: draws.Draws,
         tp=None) -> torch.Tensor:
    """linear1 → activation → dropout → linear2 of a dense post-norm layer;
    with `tp`, this rank's hidden units only and one all-reduce after linear2."""
    if tp is None:
        h = F.linear(r(x), r(layer.linear1.weight), layer.linear1.bias)
        h = dropout(activation_fn(layer.activation)(h), p, generator)
        return F.linear(r(h), r(layer.linear2.weight), layer.linear2.bias)
    n = layer.linear1.out_features
    units = tp.slice(n)
    h = F.linear(r(comm.copy_to(x, tp.group)), r(layer.linear1.weight[units]),
                 layer.linear1.bias[units])
    h = dropout(activation_fn(layer.activation)(h), p, generator, (h.dim() - 1, n, units))
    partial = F.linear(r(h), r(layer.linear2.weight[:, units]))
    return comm.reduce_from(partial, tp.group) + layer.linear2.bias


class TorchEncoderLayer(nn.Module):
    """torch-1.9 `nn.TransformerEncoderLayer` (post-norm); `dropout` is the rate
    of its train-mode forward. `moe_experts > 0`: the FFN is a
    `MoEFeedForward` named `moe` (no `linear1` / `linear2`). `split_qkv`: the
    attention's in-projection as q / k / v Linears."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0, split_qkv: bool = False):
        super().__init__()
        activation_fn(activation)  # validate early
        self.activation = activation
        self.dropout = dropout
        self.self_attn = TorchMultiheadAttention(d_model, nhead, split_qkv)
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
                generator: draws.Draws = None, aux: Optional[list] = None,
                tp=None) -> torch.Tensor:
        """`aux`: a list the MoE layer appends its load-balance loss to. `tp`
        (a `parallel.tp.TPGroup`): Megatron attention and dense FFN over its
        group (the MoE FFN runs replicated)."""
        p = self.dropout if train else 0.0
        x = self.norm1(x + dropout(self.self_attn(x, mxu_bf16, p, generator, tp=tp), p,
                                   generator))
        if self.moe is None:
            h = _ffn(self, x, _operand(mxu_bf16), p, generator, tp)
        else:
            h, layer_aux = self.moe(x, mxu_bf16, train, generator)
            if aux is not None:
                aux.append(layer_aux)
        return self.norm2(x + dropout(h, p, generator))


class Pipe:
    """How an encoder runs its layers pipelined (`parallel/pipeline.py`): over
    the `pipe` process group `group` (None: one stage, as `remat` alone
    uses), `microbatches` (0: the group's size), recomputed in the backward
    under `remat`; `data_shards` (the data-parallel degree) appears in the
    batch-size error only."""

    def __init__(self, group=None, microbatches: int = 0, remat: bool = False,
                 data_shards: int = 1):
        self.group, self.microbatches, self.remat = group, microbatches, remat
        self.data_shards = data_shards


class TorchTransformerEncoder(nn.Module):
    """Stack of `TorchEncoderLayer`s, no final norm (as the reference).

    `tp`: a `parallel.tp.TPGroup` set by `parallel.tp.tensor_parallel_trunk`,
    under which the plain route runs every layer Megatron-style."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0, split_qkv: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout, moe_experts,
                              moe_capacity_factor, split_qkv)
            for _ in range(num_layers))
        self.tp = None

    def forward(self, x: torch.Tensor, impl: str = "kernel", mxu_bf16: bool = False,
                train: bool = False, generator: draws.Draws = None,
                aux: Optional[list] = None, pipe: Optional[Pipe] = None) -> torch.Tensor:
        """impl="kernel": each dense layer through the CUDA kernel on a CUDA
        tensor (its plain version on a CPU tensor), each MoE layer through its
        plain ops (kernel B computes a dense FFN); impl="plain": plain
        everywhere. mxu_bf16: the bf16-operand mode of every layer (module
        docstring). train: the training forward, plain only (module
        docstring). aux: a list that collects each MoE layer's load-balance
        loss. pipe: the layers pipelined over its group (GPipe; kernel B per
        stage on the kernel route), each (layer, microbatch) drawing its own
        dropout stream; a pipelined trunk has no MoE layer."""
        if impl not in ("plain", "kernel"):
            raise ValueError(f"unknown trunk impl {impl!r}")
        if train and impl != "plain":
            raise ValueError("train=True needs impl='plain': the encoder-layer kernel has no "
                             "backward (nor has the Pallas kernel it ports)")
        if pipe is not None:
            from ..parallel.pipeline import pipeline_apply

            def layer_fn(layer, h, gen):
                if impl == "kernel":
                    from ..ops.encoder_layer import encoder_layer

                    return encoder_layer(h.contiguous(), layer, mxu_bf16)
                return layer(h, mxu_bf16, train, gen, tp=self.tp)

            drops = train and any(layer.dropout > 0 for layer in self.layers)
            return pipeline_apply(list(self.layers), x, layer_fn, pipe.group,
                                  pipe.microbatches or None, generator if drops else None,
                                  pipe.remat, pipe.data_shards)
        if impl == "plain":
            for layer in self.layers:
                x = layer(x, mxu_bf16, train, generator, aux, tp=self.tp)
            return x
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
