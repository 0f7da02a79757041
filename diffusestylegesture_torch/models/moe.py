"""Mixture-of-experts feed-forward: Switch top-1 routing at a static capacity.

Port of `diffusestylegesture_tpu/models/moe.py::MoEFeedForward` (a trunk
option beyond the reference, whose encoder layers have a dense FFN,
`main/model/mdm.py:77-86`). Per token, in float32: router logits → softmax →
the top-1 expert and its probability (the gate). Each expert holds
`C = ceil(G / E · capacity_factor)` tokens of the G in the batch; a token's
slot is its running count among the tokens routed to its expert (a cumulative
sum), and a token past the capacity is dropped: it contributes zero, so the
layer's residual carries it. The expert FFNs are batched matmuls over the
(E, C, D) dispatch buffer; each token's output is its expert's row scaled by
the gate. The load-balance loss `E · Σ_e f_e · p_e` (f_e the share of tokens
routed to e, p_e the mean router probability of e) is returned beside the
output: torch has no flax `sow`, so the train forward hands it up explicitly
(`make_moe_apply`'s `(prediction, aux)` convention of the JAX package).

Dispatch is a scatter of each kept token to its (expert, slot) row of an
(E, C + 1, D) buffer, every dropped token to row C of its expert, which is
then cut away: each kept row receives exactly one token, so the result is
exact and deterministic, and every shape is static (no `.item()`, `nonzero`
or boolean indexing), so the layer runs inside a CUDA graph. The combine is a
gather at the slot clamped to C − 1, multiplied by the gate times the keep
flag: a dropped token reads some kept row and scales it by zero, as the JAX
layer does. No CUDA kernel of the port computes this function, and neither
does a Pallas kernel in the JAX package (its MoE layers run through XLA):
the layer runs these plain PyTorch ops on every device.

Expert parallelism (`ep`, a process group, e.g. the `data` group; set by
`expert_parallel`): rank r computes experts [r·E/N, (r+1)·E/N) for the
tokens of every rank. The routing is the dense layer's over the ranks' tokens
together: the capacity is that of the global token count, and a token's slot
is its running count among the tokens routed to its expert on the lower
ranks and before it on its own, so the layer keeps and drops what the dense
layer over the concatenated batch keeps and drops (no routing flips). Each
rank scatters its kept tokens into an (E, C, D) buffer at their global slots,
an all-to-all hands each rank the (E/N, C, D) rows of its experts (every slot
filled by exactly one rank: summing the received chunks is exact), the
experts run, and an all-gather brings every rank all experts' rows for its
tokens' combine. `moe_param_specs` is the JAX plan: the expert stacks sharded
on their leading E dimension over `axis`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel import comm, draws
from .transformer import _operand, activation_fn, dropout


def capacity(tokens: int, experts: int, capacity_factor: float) -> int:
    """Static expert capacity C = max(1, ceil(G / E · cf))."""
    return max(1, int(math.ceil(tokens / experts * capacity_factor)))


def route(xf: torch.Tensor, router: nn.Linear, experts: int, cap: int):
    """(G, D) tokens → (probs (G, E), one-hot mask (G, E), expert (G,), gate (G,),
    slot (G,), keep (G,)), all from float32 router logits: `slot` is the
    token's running count among the tokens of its expert, `keep` whether it is
    below the capacity."""
    with torch.autocast(xf.device.type, enabled=False):
        probs = torch.softmax(router(xf.float()), dim=-1)
    gate, expert = probs.max(dim=-1)
    mask = (expert[:, None] == torch.arange(experts, device=xf.device)).float()
    pos = torch.cumsum(mask, dim=0) * mask - mask
    slot = (pos * mask).sum(dim=-1).long()
    return probs, mask, expert, gate, slot, slot < cap


class MoEFeedForward(nn.Module):
    """(B, T, D) → ((B, T, D), load-balance aux) through `num_experts` routed
    experts. Parameter names are the JAX module's: `router`, and the expert
    stacks `w1` (E, D, F), `b1` (E, F), `w2` (E, F, D), `b2` (E, D)."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, capacity_factor: float = 2.0,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.activation, self.dropout = activation, dropout
        self.router = nn.Linear(d_model, num_experts)
        self.w1 = nn.Parameter(torch.randn(num_experts, d_model, d_ff) / math.sqrt(d_model))
        self.b1 = nn.Parameter(torch.zeros(num_experts, d_ff))
        self.w2 = nn.Parameter(torch.randn(num_experts, d_ff, d_model) / math.sqrt(d_ff))
        self.b2 = nn.Parameter(torch.zeros(num_experts, d_model))
        self.ep = None  # expert-parallel process group (`expert_parallel`)

    def forward(self, x: torch.Tensor, mxu_bf16: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, D = x.shape
        if comm.size(self.ep) > 1:
            return self._expert_parallel(x, mxu_bf16, train, generator)
        E, G = self.num_experts, B * T
        C = capacity(G, E, self.capacity_factor)
        r = _operand(mxu_bf16)
        xf = x.reshape(G, D)
        probs, mask, expert, gate, slot, keep = route(xf, self.router, E, C)
        aux = E * torch.sum(mask.mean(dim=0) * probs.mean(dim=0))

        # dispatch: kept tokens to (expert, slot), dropped ones to the spare row C
        row = expert * (C + 1) + torch.where(keep, slot, C)
        xin = xf.new_zeros(E * (C + 1), D).index_copy(0, row, xf)
        xin = xin.view(E, C + 1, D)[:, :C]
        h = torch.matmul(r(xin), r(self.w1)) + self.b1[:, None, :]
        h = dropout(activation_fn(self.activation)(h), self.dropout if train else 0.0,
                    draws.local(generator))
        y = torch.matmul(r(h), r(self.w2)) + self.b2[:, None, :]
        # combine: each token's expert row, scaled by gate · keep
        out = y.reshape(E * C, D)[expert * C + slot.clamp(max=C - 1)]
        out = out * (gate * keep.to(gate.dtype))[:, None].to(out.dtype)
        return out.reshape(B, T, D), aux


    def _expert_parallel(self, x: torch.Tensor, mxu_bf16: bool, train: bool,
                         generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer over the `ep` group's tokens together (module docstring);
        x is this rank's (B, T, D), every rank holding as many tokens; the aux
        loss is the global batch's."""
        B, T, D = x.shape
        group, n, rk = self.ep, comm.size(self.ep), comm.rank(self.ep)
        E = self.num_experts
        if E % n:
            raise ValueError(f"{E} experts do not divide over {n} expert-parallel ranks")
        r = _operand(mxu_bf16)
        xf = x.reshape(B * T, D)
        with torch.autocast(xf.device.type, enabled=False):
            probs = torch.softmax(self.router(xf.float()), dim=-1)
        gate, expert = probs.max(dim=-1)
        mask = (expert[:, None] == torch.arange(E, device=x.device)).float()
        counts = comm.all_gather_cat(mask.sum(dim=0, keepdim=True), group)   # (n, E)
        G = int(B * T * n)
        C = capacity(G, E, self.capacity_factor)
        before = counts[:rk].sum(dim=0)                                      # lower ranks'
        pos = torch.cumsum(mask, dim=0) * mask - mask + before * mask
        slot = (pos * mask).sum(dim=-1).long()
        keep = slot < C
        # the load-balance loss of the global batch (each rank's copy the same)
        p_sum = comm.all_gather_sum(probs.sum(dim=0, keepdim=True), group).sum(dim=0)
        aux = E * torch.sum((counts.sum(dim=0) / G) * (p_sum / G))

        row = expert * (C + 1) + torch.where(keep, slot, C)
        xin = xf.new_zeros(E * (C + 1), D).index_copy(0, row, xf)
        xin = xin.view(E, C + 1, D)[:, :C]
        per = E // n
        mine = comm.all_to_all(xin.contiguous(), group).view(n, per, C, D).sum(dim=0)
        lo, hi = rk * per, (rk + 1) * per
        h = torch.matmul(r(mine), r(self.w1[lo:hi])) + self.b1[lo:hi, None, :]
        h = dropout(activation_fn(self.activation)(h), self.dropout if train else 0.0,
                    draws.local(generator))
        y = torch.matmul(r(h), r(self.w2[lo:hi])) + self.b2[lo:hi, None, :]
        y = comm.all_gather_sum(y.contiguous(), group)                      # (E, C, D)
        out = y.reshape(E * C, D)[expert * C + slot.clamp(max=C - 1)]
        out = out * (gate * keep.to(gate.dtype))[:, None].to(out.dtype)
        return out.reshape(B, T, D), aux


def expert_parallel(model: nn.Module, group) -> int:
    """Run every MoE layer of `model` expert-parallel over `group`; returns how
    many were set."""
    n = 0
    for m in model.modules():
        if isinstance(m, MoEFeedForward):
            m.ep = group
            n += 1
    return n


def moe_param_specs(params, axis: str = "expert") -> dict:
    """{name: spec}: every MoE layer's expert stacks (`….moe.w1|b1|w2|b2` beside
    a `….moe.router`) sharded on their leading E dimension over `axis`; the
    router and every other parameter replicated (the JAX `moe_param_specs`)."""
    names = set(params)
    out = {}
    for name in params:
        parent, _, leaf = name.rpartition(".")
        expertish = leaf in ("w1", "b1", "w2", "b2") and any(
            k.startswith(f"{parent}.router.") for k in names)
        out[name] = (axis,) if expertish else ()
    return out
