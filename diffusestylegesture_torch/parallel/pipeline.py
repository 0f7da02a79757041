"""Pipeline parallelism for the transformer trunk (GPipe schedule).

Port of `diffusestylegesture_tpu/parallel/pipeline.py`. The trunk's L layers
split over a `pipe` process group, L / P consecutive layers a stage; the
local batch splits into M microbatches (default P) that stream through the
stages, M + P − 1 ticks. At each tick stage s runs microbatch t − s through
its layers and sends the result to stage s + 1 (`comm.shift_right`: one
send / recv of (mb, T, D) a tick); the last stage's outputs are broadcast to
the whole group, so the rest of the denoiser runs replicated.

The backward runs the schedule in reverse with explicit send / recv of the
activations' gradients, tick by tick, so every rank exchanges in the same
order whatever its autograd graph looks like: stage s backpropagates the
gradient that stage s + 1 sent through the graph of microbatch m (recomputed
under `remat`, `torch.utils.checkpoint`), accumulates its layers' parameter
gradients, and sends the input's gradient to stage s − 1. The input's
gradient, which only stage 0 computes, is broadcast to the group. Each
stage's parameter gradients are its own layers' (zeros for the other
stages'); the trainer sums them over the group.

Dropout draws one stream per (global layer, microbatch): a generator seeded
from one draw of the caller's generator and the layer, drawing the masks of
the whole global batch, of which the microbatch keeps its rows. A recomputed
stage draws the same masks, and a row's masks do not depend on the
microbatch count or the data sharding (a pipelined run logs the losses of
the one-rank pipelined run). Under `no_grad` nothing is stored, and
on a card each stage's dense layers run kernel B (`layer_fn`).

`stack_layer_params` / `unstack_layer_params` stack the per-layer state
dict entries (`layers.{i}.…`) into [L, …] tensors and back, as the JAX
functions do for the param tree.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import comm
from .draws import GlobalDraws, local


def stack_layer_params(layers: Mapping[str, torch.Tensor], num_layers: int,
                       prefix: str = "layers.") -> Dict[str, torch.Tensor]:
    """{'layers.{i}.name': t} → {'name': (L, …) stacked}."""
    names = sorted({k[len(f"{prefix}0."):] for k in layers if k.startswith(f"{prefix}0.")})
    return {n: torch.stack([layers[f"{prefix}{i}.{n}"] for i in range(num_layers)])
            for n in names}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor], num_layers: int,
                         prefix: str = "layers.") -> Dict[str, torch.Tensor]:
    """The inverse of `stack_layer_params`."""
    return {f"{prefix}{i}.{n}": t[i] for n, t in stacked.items() for i in range(num_layers)}


LayerFn = Callable[[torch.nn.Module, torch.Tensor, Optional[GlobalDraws]], torch.Tensor]


class _Stage:
    """This rank's layers and how they run one microbatch. `rows` = (this
    rank's first row in the global batch, microbatch rows, global rows)."""

    def __init__(self, layers: Sequence[torch.nn.Module], first: int, layer_fn: LayerFn,
                 seed: Optional[int], device, remat: bool = False,
                 rows: Tuple[int, int, int] = (0, 0, 0)):
        self.layers, self.first, self.layer_fn = list(layers), first, layer_fn
        self.seed, self.device, self.remat, self.rows = seed, device, remat, rows

    def generator(self, layer: int, mb: int) -> Optional[GlobalDraws]:
        """Global layer `layer`'s dropout stream for microbatch `mb`: a
        generator seeded from the step's seed and the layer, drawing at the
        global batch, of which the microbatch keeps its rows. The masks of a
        row are then the same whatever the microbatch count and the data
        sharding."""
        if self.seed is None:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed + 1_000_003 * layer) % (2 ** 63))
        start, size, total = self.rows
        return GlobalDraws(g, start + mb * size, start + (mb + 1) * size, total)

    def _run(self, h: torch.Tensor, mb: int) -> torch.Tensor:
        for j, layer in enumerate(self.layers):
            h = self.layer_fn(layer, h, self.generator(self.first + j, mb))
        return h

    def run(self, h: torch.Tensor, mb: int) -> torch.Tensor:
        """The stage's layers on one microbatch; with `remat` and autograd on,
        through `torch.utils.checkpoint` (the backward recomputes it)."""
        if self.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(self._run, h, mb, use_reentrant=False)
        return self._run(h, mb)


def _schedule_forward(stage: _Stage, x_mb: List[torch.Tensor], group, keep_graph: bool):
    """Forward ticks; returns (the last stage's outputs, and with `keep_graph`
    each active tick's (microbatch, input, output) for the backward)."""
    P, s = comm.size(group), comm.rank(group)
    M = len(x_mb)
    outs: List[Optional[torch.Tensor]] = [None] * M
    saved = []
    cur = torch.zeros_like(x_mb[0])
    for t in range(M + P - 1):
        m = t - s
        if 0 <= m < M:
            inp = x_mb[m] if s == 0 else cur
            if keep_graph:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage.run(inp, m)
                saved.append((m, inp, y))
            else:
                y = stage.run(inp, m)
            send = y.detach()
            if s == P - 1:
                outs[m] = send
        else:
            send = torch.zeros_like(x_mb[0])
        cur = comm.shift(send, group, 1)
    return outs, saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage, group, M, *params):
        P, s = comm.size(group), comm.rank(group)
        outs, saved = _schedule_forward(stage, list(x.detach().chunk(M)), group,
                                        keep_graph=True)
        out = torch.cat(outs) if s == P - 1 else torch.zeros_like(x)
        comm.broadcast_(out, group, P - 1)
        ctx.stage, ctx.group, ctx.M, ctx.saved = stage, group, M, saved
        ctx.n_params = len(params)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        stage, group, M = ctx.stage, ctx.group, ctx.M
        P, s = comm.size(group), comm.rank(group)
        g_mb = grad_out.contiguous().chunk(M)
        by_mb = {m: (inp, y) for m, inp, y in ctx.saved}
        grad_x: List[Optional[torch.Tensor]] = [None] * M
        cur = torch.zeros_like(g_mb[0])
        for t in reversed(range(M + P - 1)):
            m = t - s
            send = torch.zeros_like(g_mb[0])
            if 0 <= m < M:
                gy = g_mb[m] if s == P - 1 else cur
                inp, y = by_mb[m]
                with torch.enable_grad():
                    torch.autograd.backward(y, gy)
                if inp.grad is not None:
                    send = inp.grad
                if s == 0:
                    grad_x[m] = send
            # the gradient travels one stage back: rank i receives from i + 1
            cur = comm.shift(send, group, -1)
        gx = torch.cat(grad_x) if s == 0 else torch.zeros_like(grad_out)
        comm.broadcast_(gx, group, 0)
        ctx.saved = None
        return (gx, None, None, None) + (None,) * ctx.n_params


def _params(stage: _Stage):
    for layer in stage.layers:
        yield from layer.parameters()


def pipeline_apply(layers: Sequence[torch.nn.Module], x: torch.Tensor, layer_fn: LayerFn, group,
                   num_microbatches: Optional[int] = None, generator=None,
                   remat: bool = False, data_shards: int = 1) -> torch.Tensor:
    """Run x (B, T, D), this rank's rows, through all `layers` pipelined over
    the `pipe` group `group`. `layer_fn(layer, h, generator)` applies one
    layer (the generator is the layer's and microbatch's dropout stream, or
    None without `generator`). `remat` runs each stage through
    `torch.utils.checkpoint`: the backward recomputes its forward instead of
    keeping its activations.
    Raises as the JAX function: L % P, B % M (B the rank's rows of
    `data_shards` · B)."""
    P, s = comm.size(group), comm.rank(group)
    L = len(layers)
    if L % P:
        raise ValueError(f"{L} layers not divisible by pipe={P}")
    B = x.shape[0]
    M = num_microbatches or P
    if B % M:
        raise ValueError(f"batch {B * data_shards} not divisible by data={data_shards} × "
                         f"microbatches={M}")
    per = L // P
    seed = None
    if generator is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=local(generator), device=x.device))
    start, total = ((generator.start, generator.total) if isinstance(generator, GlobalDraws)
                    else (0, B))
    stage = _Stage(layers[s * per:(s + 1) * per], s * per, layer_fn, seed, x.device, remat,
                   (start, B // M, total))
    params = [p for p in _params(stage) if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _Pipeline.apply(x, stage, group, M, *params)
    outs, _ = _schedule_forward(stage, list(x.chunk(M)), group, keep_graph=False)
    out = torch.cat(outs) if s == P - 1 else torch.zeros_like(x)
    return comm.broadcast_(out, group, P - 1)
