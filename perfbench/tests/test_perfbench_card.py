"""On the card: each cell run through `perfbench/run.py` at its own size, once
as it is and once with the control (the reference in TF32) in the program's
place: the program's gap within its limit, the control not correct. Skips
where there is no card."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import registry

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


def _run(cell, *extra):
    out = subprocess.run(
        [sys.executable, os.path.join(registry.PKG, "run.py"), "--workload", cell, "--seed",
         "2147483659", "--seconds", "10", "--trace", "0", *extra],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_passes_and_its_control_fails(card, cell):
    line = _run(cell)
    gap = line["checks"]["gap"]
    assert line["correct"] and gap["value"] <= gap["limit"]
    ctl = _run(cell, "--control", "tf32")
    assert not ctl["correct"] and ctl["checks"]["gap"]["value"] > gap["limit"]
