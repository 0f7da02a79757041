"""Benchmark of `diffusestylegesture_torch`, the PyTorch / CUDA port, on NVIDIA cards.

`python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line.
"""
