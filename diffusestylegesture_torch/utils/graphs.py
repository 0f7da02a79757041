"""CUDA graphs over the sampler's step functions and the audio encoder.

The port's counterpart of `diffusestylegesture_tpu/utils/aot.py` and of the
JAX engine's `jax.jit`: the JAX package traces one XLA program per clip, so
its denoising loop runs without Python between denoiser calls. Here each
step function of a `diffusion.sampling.SampleProgram` (and the WavLM
encoder at one window count) is captured once into a `torch.cuda.CUDAGraph`
and replayed: a step's ~60 launches become one `replay()`. `ProgramRun`
runs a sampling program so, for every sampling engine, and `use_graphs` is
their rule for when to capture.

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
are set-up and are taken off the counters again, except in a `CapturedStep`,
whose warm-up is a real step.

`CapturedStep` captures a training-style step (forward, backward and the
optimizer's update) as one graph: the counterpart of the JAX package's jitted
train step and of its `lax.scan` chunks (`cli/distill.py --chunk`, the whole
autoencoder run of `eval/embedding.py::train_autoencoder`).
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..ops import encoder_layer as _el
from ..ops import local_attention as _la
from ..parallel import draws
from . import profiling


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off for the duration. Unreachable
    objects in reference cycles may hold CUDA graphs (a finished sampler's);
    a collection that frees one inside a capture destroys a graph while a
    stream captures, which invalidates that capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def launch_counts() -> Tuple[int, int, int, int]:
    """(local attention, encoder layer f32, encoder layer bf16) launches, and
    the encoder layer's f32 GEMM grids that ran on weight planes."""
    return _la.launches, _el.launches, _el.launches_bf16, _el.launches_planes


def _set_launch_counts(counts: Tuple[int, int, int, int]) -> None:
    _la.launches, _el.launches, _el.launches_bf16, _el.launches_planes = counts


class StepGraph:
    """One captured function. `replay(n)` runs it n times on the current stream."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Tuple[int, int, int, int]):
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

    def capture(self, fn: Callable[[], object], prepare: Optional[Callable[[], None]] = None,
                **attrs) -> Tuple[StepGraph, object]:
        """Warm `fn` up once, capture it, and return (graph, what the captured
        call returned: tensors in the pool that each replay overwrites).
        `prepare` runs before the warm-up call, eagerly: it sets the state the
        call may index with (a step index in range). Raises if the capture
        fails, and nothing falls back to eager execution; PyTorch then leaves
        the process's default CUDA generator in capture mode, so its later
        draws raise too. Traced as a `graphs.capture` span whose attrs (`attrs`)
        say what was captured."""
        with profiling.span("graphs.capture", **attrs):
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
            with _collector_paused(), torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = fn()
            launches = tuple(b - a for a, b in zip(start, launch_counts()))
            _set_launch_counts(before)
            current.wait_stream(self.stream)
            torch.cuda.synchronize(self.device)
            self.capture_seconds += time.perf_counter() - t0
        return StepGraph(graph, launches), out


def use_graphs(device: torch.device, graphs: Optional[bool]) -> bool:
    """Whether an engine on `device` captures its programs: `graphs` None
    captures on a CUDA device and runs eagerly elsewhere; True off a CUDA
    device raises."""
    on = device.type == "cuda" if graphs is None else bool(graphs)
    if on and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    return on


class ProgramRun:
    """A `diffusion.sampling.SampleProgram` run a step at a time: with
    `graphs`, one graph a phase, captured at the first `begin` and replayed;
    without, the phases' functions called eagerly."""

    def __init__(self, program, graphs: bool):
        self.program = program
        # what the graphs register: the generator under a `parallel.draws.GlobalDraws`
        self.generator: torch.Generator = draws.local(program.generator)
        self.graph_set = GraphSet(program.sched.device, [self.generator]) if graphs else None
        self.graphs: Optional[List[StepGraph]] = None

    @property
    def capture_seconds(self) -> float:
        return self.graph_set.capture_seconds if self.graph_set is not None else 0.0

    def begin(self, noise: Optional[torch.Tensor] = None) -> None:
        """Capture at first use, then set x_T (drawn unless `noise` is given).
        Each phase is warmed up from the step index it starts at, and the
        warm-up calls' draws are given back to the generator, so the replays
        from `program.init` draw what the eager loop draws."""
        prog = self.program
        if self.graph_set is not None and self.graphs is None:
            self.graphs, step = [], prog.t0
            state = self.generator.get_state()
            for phase in prog.phases:
                graph, _ = self.graph_set.capture(
                    phase.fn, prepare=lambda s=step: prog.idx.fill_(s),
                    what=f"{type(prog).__name__} {phase.name}", batch=prog.shape[0])
                self.graphs.append(graph)
                step -= phase.count
            self.generator.set_state(state)
        prog.init(noise)

    def steps(self):
        """The loop's steps, one at each `next`: a replay, or the phase's `fn`."""
        for i, phase in enumerate(self.program.phases):
            for _ in range(phase.count):
                if self.graphs is None:
                    phase.fn()
                else:
                    self.graphs[i].replay(1)
                yield

    def run(self) -> torch.Tensor:
        """Every step after `begin`, in a plain loop; returns the program's `img`."""
        if self.graphs is None:
            return self.program.run()
        for phase, graph in zip(self.program.phases, self.graphs):
            for _ in range(phase.count):
                graph.replay(1)
        return self.program.img


class CapturedStep:
    """A step that updates state in place, captured once as one CUDA graph and
    replayed: `step(n)` runs n steps and returns the last one's metrics.

    `fn()` takes no arguments. It reads its inputs from tensors that outlive
    the graph (parameters, optimizer buffers, the windows on the card), writes
    every state update into them (`copy_`), draws only from `generators` and
    returns its metrics as a dict of device tensors. The first step runs `fn`
    eagerly on a side stream: it is a real step, and the warm-up that loads the
    kernels' libraries, sets their shared-memory opt-ins and creates the cuBLAS
    workspace outside the capture. Then `fn` is captured, which runs nothing,
    and every later step is a replay. A replay advances each registered
    generator as the eager step does, so the captured steps are bitwise equal
    to eager ones from the same state and generator state.

    Hazards, each of which breaks that equality or the capture:
    * autocast's cast cache must be off inside `fn` (`cache_enabled=False`):
      a cast cached at capture would be a tensor of the pool that no replay
      refreshes;
    * `loss.backward()` is captured together with the optimizer's update that
      reads the gradients it accumulates, in one graph: a backward replayed
      without its update, or the reverse, leaves the gradients stale;
    * the metrics are the graph's output buffers, overwritten by every replay:
      a caller that keeps one step's metrics clones them, and the host reads
      them only at its log boundaries (a read waits for the card);
    * nothing in `fn` may read a value on the host or copy one to the card (a
      Python number becomes a kernel argument, fixed at capture);
    * a capture that fails raises, and leaves PyTorch's default CUDA generator
      in capture mode for the rest of the process: test such failures in a
      subprocess.

    On the CPU, where the caller asks for it, every step runs `fn` eagerly.
    """

    def __init__(self, fn: Callable[[], Dict[str, torch.Tensor]], device: torch.device,
                 generators: Iterable[torch.Generator] = ()):
        self.fn = fn
        self.graph_set = GraphSet(device, generators) if device.type != "cpu" else None
        self.graph: Optional[StepGraph] = None
        self.outputs: Dict[str, torch.Tensor] = {}

    @property
    def capture_seconds(self) -> float:
        return self.graph_set.capture_seconds if self.graph_set is not None else 0.0

    def __call__(self, n: int = 1) -> Dict[str, torch.Tensor]:
        if n < 1:
            raise ValueError(f"CapturedStep: n must be at least 1, not {n}")
        if self.graph_set is None:
            for _ in range(n):
                out = self.fn()
            return out
        if self.graph is None:
            first = self._warm_up_and_capture()
            if n == 1:
                return first
            n -= 1
        self.graph.replay(n)
        return self.outputs

    def _warm_up_and_capture(self) -> Dict[str, torch.Tensor]:
        gs = self.graph_set
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(gs.device)
        gs.stream.wait_stream(current)
        with torch.cuda.stream(gs.stream):
            first = self.fn()  # step 1, eagerly; its launches count
        states = [gen.get_state() for gen in gs.generators]
        graph = torch.cuda.CUDAGraph()
        for gen in gs.generators:
            graph.register_generator_state(gen)
        start = launch_counts()
        with _collector_paused(), torch.cuda.graph(graph, pool=gs.pool, stream=gs.stream):
            self.outputs = self.fn()
        launches = tuple(b - a for a, b in zip(start, launch_counts()))
        _set_launch_counts(start)
        for gen, state in zip(gs.generators, states):
            gen.set_state(state)  # the capture draws nothing: replays advance the generators
        current.wait_stream(gs.stream)
        torch.cuda.synchronize(gs.device)
        gs.capture_seconds += time.perf_counter() - t0
        self.graph = StepGraph(graph, launches)
        return first
