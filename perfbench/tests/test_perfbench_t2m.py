"""The text-to-motion cell's own pieces: its reference imports nothing of the
program, its traffic sends the same prompts for a seed, its reader of device
time per guided call on a synthetic trace, and a whole toy run whose answer is
altered where the engine produces it, which must come out not correct (the
shared fault of `test_perfbench_cells.py` alters the windowed engines'
answer, which this path does not run)."""
import itertools
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import registry, runner
from perfbench.harness import traffic as gen
from perfbench.harness.profiling import DeviceOp, Slice, reduce
from perfbench.harness.recorder import Span
from perfbench.systems import t2m
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_isolation import PKG, _imports

BENCH = registry.benchmark()
CELL = registry.workload(BENCH, "t2m-prompt-ddpm1000")
SEED = 2 ** 31 + 4242
MS = 1_000_000


def test_the_reference_imports_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _imports(f"{PKG}/reference/t2m.py")}
    assert not tops & (set(runner.FORBIDDEN) | {"diffusestylegesture_torch"}), tops


def test_a_seed_gives_the_same_prompts_and_noise_seeds():
    traffic = registry.traffic(CELL["traffic"])

    def requests(seed, n=34):
        system = SimpleNamespace(run_seed=seed, traffic=traffic)
        return [t2m.System.request(system, spec)
                for spec in itertools.islice(gen.specs(traffic, seed), n)]

    a = requests(SEED)
    assert a == requests(SEED) and a != requests(SEED + 1)
    words = sorted(len(prompts[0].split()) for prompts, _ in a[:traffic["block"]])
    assert words == list(range(4, 21))  # every block holds each length once
    assert all(len(prompts) == traffic["prompts"] == 1 for prompts, _ in a)


def test_us_per_call_reads_the_denoiser_replays():
    spans = [Span("text", 0, 1 * MS, None), Span("denoiser", 1 * MS, 40 * MS, None)]
    ops, launches = [], {}
    for call in range(3):  # three replayed calls of a 2-layer trunk, 2 ms each
        t0 = (2 + 2 * call) * MS
        corr = 10 + call
        launches[corr] = (t0, "cudaGraphLaunch")
        for layer in range(2):
            ops.append(DeviceOp("void encoder_layer_attention<4>(p)", t0 + layer * MS,
                                t0 + layer * MS + MS // 2, corr))
            ops.append(DeviceOp("void encoder_layer_gemm<2>(p)", t0 + layer * MS + MS // 2,
                                t0 + (layer + 1) * MS, corr))
    ops.append(DeviceOp("elementwise(x)", 500_000, 900_000, 1))       # the text tower
    launches[1] = (100_000, "cudaLaunchKernel")
    red = reduce(Slice(ops, launches, 0, 45 * MS), spans)
    reader = registry.metric("t2m_us_per_call.t2m")
    ctx = SimpleNamespace(reduced=red, system=SimpleNamespace(cfg={"num_layers": 2}))
    assert reader.read(ctx) == pytest.approx(2000.0)
    assert reader.read(SimpleNamespace(reduced=None, system=None)) is None
    empty = reduce(Slice(ops[-1:], {1: launches[1]}, 0, 45 * MS), spans)
    assert reader.read(SimpleNamespace(reduced=empty, system=ctx.system)) is None


def test_work_counts_each_guided_call_and_the_text_tower():
    cfg = tiny.config(CELL["config"])
    traffic = registry.traffic(CELL["traffic"])
    system = SimpleNamespace(cfg=cfg, traffic=traffic, steps=cfg["diffusion_steps"], batch=6)
    call = t2m.call_flops(6, traffic["frames"], cfg)
    assert t2m.System.work(system, {}) == 10 * call + t2m.clip_flops(cfg["clip"])
    assert t2m.System.kernel_shapes(system) == {
        "encoder_layer": (6, 197, cfg["latent_dim"], cfg["num_heads"], cfg["ff_size"])}
    # one layer of the text tower by hand: 4 W x W products and the MLP on 77
    # positions, the causal scores and values over 77 * 78 / 2 pairs
    clip = dict(context_length=77, width=8, layers=1, projection_dim=4)
    assert t2m.clip_flops(clip) == (2 * 77 * 8 * 8 * 4 + 4 * (77 * 78 // 2) * 8
                                    + 2 * 2 * 77 * 8 * 32 + 2 * 8 * 4)


def test_an_altered_answer_is_not_correct(monkeypatch):
    from diffusestylegesture_torch.sample import engine_t2m

    real = engine_t2m.TextMotionSampler.sample

    def altered(self, text_emb, frames, seed):
        return real(self, text_emb, frames, seed) + 1e-2
    monkeypatch.setattr(engine_t2m.TextMotionSampler, "sample", altered)
    res = runner.run_cell(tiny.config(CELL["config"]), tiny.traffic(CELL["traffic"]),
                          registry.cell_metrics(BENCH, CELL["name"], False), SEED, 1.0, False,
                          torch.device("cpu"), 0.0)
    assert res["attempted"] > 0 and not res["correct"], res["checks"]
