"""Fully-sharded data parallelism (ZeRO) over the trainer's flat buffers.

Port of `diffusestylegesture_tpu/parallel/fsdp.py`. There, every large
parameter leaf is annotated as sharded along the `data` axis and XLA derives
the all-gather / reduce-scatter schedule. The port's trainer keeps every
parameter as a view of one flat float32 buffer (`train/state.py::FlatParams`),
and so do its AdamW moments and EMA; ZeRO is then a cut of those buffers:

* the flat gradient is reduce-scattered (mean over the data group): each rank
  gets the mean gradient of its 1/N slice (`FlatShard`);
* AdamW and the EMA run on that slice only: the moments and the EMA are
  1/N the size on each rank;
* the updated slices are all-gathered into the flat parameters, which the
  next forward reads whole.

Wrapping the model with FSDP2 (`fully_shard`) or DTensor would replace the
parameters with DTensors and break the flat views, so the port does not.

`fsdp_param_specs` and `count_sharded` are the JAX package's plan functions
over the port's state dicts (parameter names, torch layout): the same leaves
and the same physical dimensions as the JAX specs of the same tree. A spec
is a tuple with one mesh axis name or None per dimension, trailing Nones
dropped (`()` replicated), as a `PartitionSpec`.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from . import comm

Spec = Tuple[Optional[str], ...]


def transposed(name: str, ndim: int) -> bool:
    """Whether the port stores this parameter with its dimensions reversed
    against the JAX package: a Linear's or a GRU's weight (out, in) against a
    flax kernel (in, out), a Conv1d weight (out, in, k) against (k, in, out).
    Embedding tables (`relative_attention_bias.weight`) and the MoE stacks
    keep the JAX order."""
    return ndim >= 2 and "weight" in name.rsplit(".", 1)[-1] \
        and "relative_attention_bias" not in name


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def fsdp_param_specs(params: Mapping[str, object], axis_size: int, axis: str = "data",
                     min_leaf_size: int = 2 ** 14,
                     base_specs: Optional[Mapping[str, Spec]] = None) -> dict:
    """{name: spec} sharding each large parameter along `axis`: the largest
    dimension that divides by `axis_size` and that `base_specs` (e.g. the
    tensor-parallel plan) leaves free, ties going to the dimension that comes
    last in the JAX layout; parameters under `min_leaf_size` elements, or
    with no such dimension, keep their base spec."""
    out = {}
    for name, leaf in params.items():
        shape = _shape(leaf)
        base = list((base_specs or {}).get(name, ()))
        while base and base[-1] is None:
            base.pop()
        base = tuple(base)
        numel = 1
        for s in shape:
            numel *= s
        if numel < min_leaf_size or axis in base:
            out[name] = base
            continue
        parts = list(base) + [None] * (len(shape) - len(base))
        rev = transposed(name, len(shape))

        def jax_dim(d, n=len(shape), rev=rev):
            return n - 1 - d if rev else d

        cand = [(shape[d], jax_dim(d), d) for d in range(len(shape))
                if parts[d] is None and shape[d] % axis_size == 0 and shape[d] >= axis_size]
        if not cand:
            out[name] = base
            continue
        parts[max(cand)[2]] = axis
        while parts and parts[-1] is None:
            parts.pop()
        out[name] = tuple(parts)
    return out


def count_sharded(specs: Mapping[str, Spec], axis: str = "data") -> int:
    """Number of parameters whose spec carries `axis`."""
    return sum(1 for s in specs.values() if axis in s)


def _reduce_scatter(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, flat, group=group)


def _all_gather(flat: torch.Tensor, shard: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(flat, shard, group=group)


class FlatShard:
    """This rank's slice [lo, hi) of a flat buffer of `padded` elements
    (`numel` rounded up to a multiple of the group's size)."""

    def __init__(self, numel: int, group):
        self.group = group
        n, r = comm.size(group), comm.rank(group)
        self.n = n
        self.padded = -(-numel // n) * n
        self.size = self.padded // n
        self.lo, self.hi = r * self.size, (r + 1) * self.size

    def reduce_scatter_mean(self, flat: torch.Tensor, out: torch.Tensor) -> None:
        """out ← the group's mean of flat[lo:hi] (`flat` holds `padded` elements)."""
        if self.group is None:
            out.copy_(flat)
            return
        _reduce_scatter(out, flat, self.group)
        out.div_(self.n)

    def all_gather(self, shard: torch.Tensor, flat: torch.Tensor) -> None:
        """flat (`padded` elements) ← every rank's slice, in rank order."""
        if self.group is None:
            flat.copy_(shard)
            return
        _all_gather(flat, shard.contiguous(), self.group)

    def full(self, shard: torch.Tensor) -> torch.Tensor:
        """A new `padded`-element buffer gathered from every rank's slice."""
        flat = torch.empty(self.padded, dtype=shard.dtype, device=shard.device)
        self.all_gather(shard, flat)
        return flat
