"""No run may load JAX or the JAX package; the references import nothing of the program."""
import ast
import os
import subprocess
import sys

from perfbench.harness.runner import FORBIDDEN, forbidden_modules

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def test_top_level_names_compare_whole():
    assert forbidden_modules(["diffusestylegesture_torch", "diffusestylegesture_torch.ops",
                              "jaxtyping", "flaxen.x", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "diffusestylegesture_tpu.models",
                              "flax"]) == ["diffusestylegesture_tpu", "flax", "jax"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program():
    ref = os.path.join(PKG, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & (set(FORBIDDEN) | {"diffusestylegesture_torch"}), name


def test_a_cpu_run_loads_no_forbidden_module():
    """A whole tiny run in a fresh interpreter, then a look at sys.modules."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from perfbench.harness import registry, runner\n"
        "from perfbench.tests import tiny\n"
        "bench = registry.benchmark()\n"
        "cell = registry.workload(bench, 'twh-ddpm1000-solo')\n"
        "res = runner.run_cell(tiny.config('twh'), tiny.traffic(cell['traffic']),\n"
        "    registry.cell_metrics(bench, cell['name'], False), 7, 1.0, False,\n"
        "    torch.device('cpu'), 0.0)\n"
        "assert res['correct'], res\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(runner.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
