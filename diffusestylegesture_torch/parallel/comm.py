"""Collectives over a process group, with their transposes for autograd.

The explicit counterparts of what GSPMD and `shard_map` insert in the JAX
package (`psum`, `all_gather`, `ppermute` and their transposes):

* `copy_to` / `reduce_from`: Megatron's conjugate pair f / g. f is the
  identity forward and an all-reduce of the gradient backward (before a
  column-parallel matmul); g all-reduces forward and passes the gradient
  through backward (after a row-parallel matmul).
* `split_to` / `gather_from`: keep this rank's chunk of a replicated tensor
  along a dimension (backward: all-gather the chunks' gradients), and its
  inverse (backward: keep this rank's chunk of the gradient).
* `shift_right`: the ring `ppermute` i → i + 1 with send/recv (backward: the
  shift to the left), which carries the sequence-parallel halo;
* `all_to_all`: chunk j of dimension 0 to rank j (backward: the same
  exchange of the gradients), and `all_gather_sum`: an all-gather whose
  backward sums the ranks' gradients of each chunk (the expert-parallel
  dispatch and combine).

Every rank of the group must call these in the same order. None (no
parallelism) makes no call; a group of one rank does (a world of one still
runs every collective of a meshed path), except the send / recv of a shift,
which is then a copy. Tensors are sent contiguous; the functions return new
tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated along `dim`, in rank order."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(size(group), dim=dim)[rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(size(ctx.group), dim=ctx.dim)[rank(ctx.group)].contiguous(), None, None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i sends x to rank i + step and returns what rank i − step sent."""
    n = size(group)
    if n == 1:
        return x.clone()
    r = rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _ShiftRight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    n = size(group)
    ins = [c.contiguous() for c in x.chunk(n)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x.contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.chunk(size(ctx.group))[rank(ctx.group)].contiguous(), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x's dimension 0 to rank j; returns the chunks received, in
    rank order."""
    return x if group is None else _AllToAll.apply(x, group)


def all_gather_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x concatenated along dimension 0; the gradient of each
    rank's chunk is the sum of every rank's gradient of it."""
    return x if group is None else _AllGatherSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group, dim)


def shift_right(x: torch.Tensor, group) -> torch.Tensor:
    """Ring `ppermute` i → i + 1 (rank 0 receives the last rank's tensor)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ShiftRight.apply(x, group)
    return _shift(x, group, 1)


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i sends x to rank i + step, returns what rank i − step sent (no autograd)."""
    return _shift(x, group, step)


def broadcast_(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """In-place broadcast from the group's rank `src`."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t

