"""Run one cell of `BENCHMARK.json` once and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `diffusestylegesture_torch`, on a
machine with the CUDA cards the cell asks for. `--trace 0` reports the cell's
end-to-end metrics, `--trace 1` its per-layer metrics from a profiled slice
of the window. `--control tf32` puts the plain reference computed in TF32
(the correctness check's control) in the program's place: the same
comparison then has to report `correct: false`. The benchmark's own runs
leave it off.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None, choices=("tf32",))
    return p.parse_args(argv)


if __name__ == "__main__":
    from perfbench.harness import runner

    sys.exit(runner.main(parse(), T_PROCESS))
