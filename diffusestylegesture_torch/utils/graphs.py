"""CUDA graphs over the sampler's step functions and the audio encoder.

The port's counterpart of `diffusestylegesture_tpu/utils/aot.py` and of the
JAX engine's `jax.jit`: the JAX package traces one XLA program per clip, so
its denoising loop runs without Python between denoiser calls. Here each
step function of a `diffusion.sampling.SampleProgram` (and the WavLM
encoder at one window count) is captured once into a `torch.cuda.CUDAGraph`
and replayed: a step's ~60 launches become one `replay()`.

A graph holds the kernels, their arguments and their memory addresses as
they were at capture. So everything a step reads or writes between replays
lies in tensors that outlive the graph (the program's state, the engine's
conditioning buffers), every per-step number is read on the device (the
program's step index), and the random draws come from a generator
registered with the graph, whose offset each replay advances as an eager
draw would. Before its capture each function runs once eagerly on the
capture stream, which builds and loads the kernels' libraries, sets their
shared-memory opt-ins, creates the cuBLAS workspace and fills the RoPE
tables outside the capture. A graph cannot be saved across processes, so
there is no counterpart of `--aot_dir`: capture at first use takes seconds,
and `ops/build.py` caches the compiled kernels in `_build/`.

Launch counters. The kernel wrappers count in Python, which runs at capture
and not at replay: a `StepGraph` records the launches its capture counted
and adds them to the counters at each replay. The eager warm-up's launches
are set-up and are taken off the counters again.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Tuple

import torch

from ..ops import encoder_layer as _el
from ..ops import local_attention as _la


def launch_counts() -> Tuple[int, int, int]:
    """(local attention, encoder layer f32, encoder layer bf16) launches."""
    return _la.launches, _el.launches, _el.launches_bf16


def _set_launch_counts(counts: Tuple[int, int, int]) -> None:
    _la.launches, _el.launches, _el.launches_bf16 = counts


class StepGraph:
    """One captured function. `replay(n)` runs it n times on the current stream."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Tuple[int, int, int]):
        self.graph = graph
        self.launches = launches

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            self.graph.replay()
        counts = launch_counts()
        _set_launch_counts(tuple(c + n * k for c, k in zip(counts, self.launches)))


class GraphSet:
    """Graphs captured on one stream into one memory pool, with the generators
    their draws come from. Graphs of one set must not run concurrently, and
    what one graph hands to the next goes through tensors allocated outside
    the pool; each function's own temporaries live in the pool."""

    def __init__(self, device: torch.device, generators: Iterable[torch.Generator] = ()):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.generators = tuple(generators)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.capture_seconds = 0.0

    def capture(self, fn: Callable[[], object],
                prepare: Optional[Callable[[], None]] = None) -> Tuple[StepGraph, object]:
        """Warm `fn` up once, capture it, and return (graph, what the captured
        call returned: tensors in the pool that each replay overwrites).
        `prepare` runs before the warm-up call, eagerly: it sets the state the
        call may index with (a step index in range). Raises if the capture
        fails, and nothing falls back to eager execution; PyTorch then leaves
        the process's default CUDA generator in capture mode, so its later
        draws raise too."""
        t0 = time.perf_counter()
        before = launch_counts()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            if prepare is not None:
                prepare()
            fn()
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        start = launch_counts()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = fn()
        launches = tuple(b - a for a, b in zip(start, launch_counts()))
        _set_launch_counts(before)
        current.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)
        self.capture_seconds += time.perf_counter() - t0
        return StepGraph(graph, launches), out
