"""Text-to-motion prompts: the caption encoder, classifier-free-guided sampling
over `TextMDM`, and one captured program per request shape.

The engine behind `cli/generate.py` (port of the product path of
`diffusestylegesture_tpu/cli/generate.py`; reference `main/sample/generate.py`):
prompts → the frozen CLIP text tower (`models/clip_text.py`, eager, once a
request) → each prompt's embedding tiled rep-major over its repetitions →
the sampler's loop (`diffusion/sampling.py`) over `TextMDM`, CFG's cond and
uncond passes run as one doubled batch (`make_cfg_model_fn`; guidance 1 runs
the conditional model alone) → (rows, njoints, 1, frames) normalized hml_vec.

The engine outlives a request. It keeps, per (rows, frames), the loop's
program over a text buffer and a generator of its own; on a CUDA device the
program's step functions are captured once, at that shape's first request
(`utils/graphs.py::capture_program`), and every later request of the shape
only replays them. A request writes its text embedding into the buffer and
its seed into the generator, whose state the graphs read at each replay, so
two requests with one seed give the same motion, and the eager loop
(`graphs=False`, the CPU's only path) gives the same numbers as the replays.

Counters, always on (`counters()`): `requests`, `rows` (candidate motions
sampled), `captures` (programs captured) and `replays` (requests served by
replaying one). Traced (`utils/profiling.py`, off by default) as
`t2m.generate` (prompts, rows, frames) around `t2m.encode` (prompts, tokens:
the prompts' ids that are not padding) and `t2m.sample` (path `capture`,
`replay` or `eager`; a capture's `graphs.capture` spans inside), which holds
`t2m.steps` (steps).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion import Schedule, make_cfg_model_fn
from ..diffusion.sampling import PROGRAMS
from ..models.mdm_text import TextMDM
from ..utils import profiling
from ..utils.graphs import GraphSet, capture_program


class _ShapeRun:
    """One (rows, frames): the text buffer, the program over it, its generator
    and, on the graph path, its graph set and one graph a phase."""

    def __init__(self, engine: "TextMotionSampler", rows: int, frames: int):
        dev, model = engine.device, engine.model
        self.text = torch.zeros((rows, model.cfg.clip_dim), device=dev)
        self.generator = torch.Generator(device=dev)
        cond = {"text_emb": self.text}
        if engine.guidance != 1.0:
            model_fn = make_cfg_model_fn(
                lambda _params, x, t, c, uncond=None: model(x, t, c, uncond=uncond),
                engine.guidance, rows, cond=cond)
        else:
            def model_fn(x, t):
                return model(x, t, cond)
        self.program = PROGRAMS[engine.sampler](
            engine.schedule, model_fn, (rows, model.cfg.njoints, 1, frames), self.generator)
        self.graph_set = GraphSet(dev, [self.generator]) if engine.graphs else None
        self.graphs = None


class TextMotionSampler:
    """Prompts → candidate motions (module docstring).

    model: a `TextMDM` on the schedule's device, in eval mode.
    encoder: a caption encoder of `models/clip_text.py` (`make_caption_encoder`
      or `caption_encoder_from_spec`), its tower on the same device.
    schedule: the diffusion `Schedule` (respaced for ddimN).
    sampler: ddpm | ddim | plms | dpmpp; guidance: the CFG scale.
    graphs: None (default) captures on a CUDA device and runs eagerly on the
      CPU; False runs eagerly on the card too (the comparison path); True on
      the CPU raises.
    """

    def __init__(self, model: TextMDM, encoder, schedule: Schedule, sampler: str = "ddpm",
                 guidance: float = 2.5, *, graphs: Optional[bool] = None):
        if sampler not in PROGRAMS:
            raise ValueError(f"unknown sampler {sampler!r} ({sorted(PROGRAMS)})")
        self.device = schedule.device
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.model, self.schedule, self.sampler = model, schedule, sampler
        self.guidance = float(guidance)
        self.clip, self.tokenize = encoder.encoder, encoder.tokenize
        self._runs: Dict[Tuple[int, int], _ShapeRun] = {}
        self._counts = {"requests": 0, "rows": 0, "captures": 0, "replays": 0}

    def counters(self) -> Dict[str, int]:
        return dict(self._counts)

    @property
    def capture_seconds(self) -> float:
        """Seconds spent warming up and capturing graphs so far."""
        return sum(r.graph_set.capture_seconds for r in self._runs.values()
                   if r.graph_set is not None)

    @torch.inference_mode()
    def encode(self, prompts: Sequence[str]) -> torch.Tensor:
        """(P, clip_dim) text embeddings on the device, one a prompt."""
        ids = self.tokenize(list(prompts))
        with profiling.span("t2m.encode", prompts=len(prompts),
                            tokens=int(np.count_nonzero(ids))):
            return self.clip(torch.from_numpy(ids).to(self.device))

    @torch.inference_mode()
    def sample(self, text_emb: torch.Tensor, frames: int, seed: int) -> torch.Tensor:
        """(rows, njoints, 1, frames) samples for the (rows, clip_dim) embeddings,
        their noise drawn from `seed`; a copy, on the device."""
        rows = int(text_emb.shape[0])
        run = self._runs.get((rows, frames))
        if run is None:
            run = self._runs[(rows, frames)] = _ShapeRun(self, rows, frames)
        prog = run.program
        with profiling.span("t2m.sample") as sp:
            run.text.copy_(text_emb)
            run.generator.manual_seed(seed)
            if run.graph_set is None:
                sp.set(path="eager")
            elif run.graphs is None:
                sp.set(path="capture")
                run.graphs = capture_program(run.graph_set, prog, run.generator)
                self._counts["captures"] += 1
            else:
                sp.set(path="replay")
            prog.init()
            with profiling.span("t2m.steps", steps=sum(ph.count for ph in prog.phases)):
                if run.graphs is None:
                    prog.run()
                else:
                    # one replay a step, as the windowed engines issue them
                    for phase, graph in zip(prog.phases, run.graphs):
                        for _ in range(phase.count):
                            graph.replay(1)
                    self._counts["replays"] += 1
            self._counts["requests"] += 1
            self._counts["rows"] += rows
            return prog.img.clone()

    @torch.inference_mode()
    def generate(self, prompts: Sequence[str], frames: int, repetitions: int = 1,
                 seed: int = 10) -> torch.Tensor:
        """(repetitions × P, njoints, 1, frames) candidate motions, rows
        rep-major (the reference's loop over repetitions orders them so)."""
        prompts = list(prompts)
        rows = repetitions * len(prompts)
        with profiling.span("t2m.generate", prompts=len(prompts), rows=rows, frames=frames):
            emb = self.encode(prompts)
            return self.sample(emb.repeat(repetitions, 1), frames, seed)
