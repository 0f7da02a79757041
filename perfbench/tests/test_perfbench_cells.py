"""Each cell's whole run on the CPU at toy widths (the look for a card
skipped): its traffic through the port's entry, its metrics and its check
against the plain reference; then the same run with the timed path broken
underneath, and with the control (the reference in TF32) in the program's
place, each of which must come out not correct."""
import pytest
import torch

from perfbench.harness import registry, runner
from perfbench.tests import tiny

BENCH = registry.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
SEED = 2 ** 31 + 12345  # the driver's seeds are that large


def run(cell_name, control=None, seconds=1.5):
    cell = registry.workload(BENCH, cell_name)
    return runner.run_cell(tiny.config(cell["config"]), tiny.traffic(cell["traffic"]),
                           registry.cell_metrics(BENCH, cell_name, False), SEED, seconds, False,
                           torch.device("cpu"), 0.0, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_and_control_fails(cell):
    res = run(cell)
    gap = res["checks"]["gap"]
    assert res["correct"], gap
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"setup_s"} < set(res["metrics"])
    # the reference in TF32 in the program's place, through the same decision
    ctl = run(cell, control="tf32")
    control = ctl["checks"]["gap"]
    assert not ctl["correct"], control
    assert control["value"] > 3 * gap["value"], (control, gap)


def _alter_answer(monkeypatch):
    """The window's sample altered where the engine produces it."""
    from diffusestylegesture_torch.sample import engine

    real = engine._WindowSampler.finish_window

    def altered(self, run, sample, first, seed):
        out, nxt = real(self, run, sample, first, seed)
        return out + 1e-2, nxt
    monkeypatch.setattr(engine._WindowSampler, "finish_window", altered)


def _unchanged_step(monkeypatch):
    """Every sampling step hands its state back unchanged (it only counts down)."""
    from diffusestylegesture_torch.diffusion import sampling

    for cls in (sampling.DDPMProgram, sampling.DPMPPProgram):
        def step(self, *kind):
            def fn():
                self.idx.sub_(1)
            return fn
        monkeypatch.setattr(cls, "_step", step)
    monkeypatch.setattr(sampling.DPMPPProgram, "_final", lambda self: None)


@pytest.mark.parametrize("fault", [_alter_answer, _unchanged_step],
                         ids=["answer_altered", "step_unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell, seconds=1.0)
    assert not res["correct"], res["checks"]
