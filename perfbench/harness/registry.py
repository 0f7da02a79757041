"""Finds what a cell names, by name, in files of their own.

* `BENCHMARK.json` at the root of the checkout lists the cells, metrics and bounds;
* a configuration is the JSON file its entry names (`configs/<name>.json`),
  whose `system` names the module under `perfbench/systems/` that builds it;
* a traffic mix is `perfbench/traffic/<name>.json`;
* a metric is read by `perfbench/metrics/<quantity>.py`, with its `LAYER`,
  `UNIT`, `SOURCE` and `read(ctx)`; the quantity is the metric's name up to
  its first dot, so `mfu.frames` and `mfu.latency` share `mfu.py` and differ
  only in the `moves` and `workloads` that BENCHMARK.json gives them.

Adding any of them adds files; no file here or elsewhere is edited.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import List

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, pkg: str = PKG) -> dict:
    return _json(os.path.join(pkg, "traffic", f"{name}.json"))


def system(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.systems.{name}")


def metric(name: str, pkg: str = PKG) -> ModuleType:
    """The reader module of a metric: the file named by its quantity."""
    quantity = name.split(".")[0]
    path = os.path.join(pkg, "metrics", f"{quantity}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{quantity}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: end-to-end ones with trace off,
    per-layer ones with it on; a metric with a `workloads` list only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]
