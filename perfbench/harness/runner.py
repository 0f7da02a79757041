"""One run of one cell: set-up, the measured window, the metrics, the check
against the plain reference, and the result line.

`run_cell` takes its device from the caller, so a test can drive a whole run
on the CPU at a small size; `main` is what `perfbench/run.py` calls and
refuses to run without the cards the cell asks for.
"""
from __future__ import annotations

import faulthandler
import gc
import json
import math
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import drive, profiling, registry, weights
from .readers import Context
from .recorder import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusestylegesture_tpu")
# the traced slice, unless the traffic sets `trace_slice_s` (long enough to hold
# every kind of call the cell makes, e.g. one encoder call a batch)
TRACE_SLICE_S = 2.0


def forbidden_modules(modules: Sequence[str]) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is a forbidden one."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def run_cell(cfg: dict, traffic: dict, metrics: List[dict], seed: int, seconds: float,
             trace: bool, device, t_process: float, control: Optional[str] = None,
             log=sys.stderr) -> dict:
    """Everything but the look for a card. Returns the result line's fields
    and, under "checks", each compared number with its limit. With `control`
    (a precision below the configuration's, e.g. "tf32") the plain reference
    computed in it takes the program's place: its outputs of the picked
    requests go through the same comparison and decide `correct`."""
    import torch

    cuda = device.type == "cuda"
    system = registry.system(cfg["system"]).System(cfg, traffic, device)
    if cuda:
        from diffusestylegesture_torch.ops import build
        build.build_all()
    system.load(weights.make(system.layouts(), seed, device), seed)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    recorder = Recorder()
    system.start(seed, recorder)
    sliced, gate = [], profiling.Gate()
    if trace:
        gate.install()

    def mid():
        length = min(traffic.get("trace_slice_s", TRACE_SLICE_S), seconds / 4)
        sliced.append(profiling.capture(length, gate))

    driven = drive.DRIVERS[traffic["driver"]](system, traffic, seed, seconds,
                                              mid if trace else None)
    setup_s = driven["start"] - t_process
    print(f"phases: set-up {setup_s:.1f} s, window and drain "
          f"{time.perf_counter() - driven['start']:.1f} s", file=log)
    system.stop()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    reduced = profiling.reduce(sliced[0], recorder.snapshot()) if sliced else None
    if reduced is not None:
        print(f"trace: {len(sliced[0].ops)} device ops, {len(sliced[0].launches)} launches, "
              f"busy {reduced.busy_s:.4f} of {reduced.window_s:.4f} s", file=log)
        for name, rec in reduced.layers.items():
            top = sorted(((k, v[0], profiling.kernel_seconds(rec, "^" + re.escape(k) + "$")[1])
                          for k, v in rec["kernels"].items()), key=lambda x: -x[2])[:4]
            print(f"trace layer {name}: {rec['launches']} launches ({rec['graph_launches']} "
                  f"replays, busy {rec['graph_seconds']:.4f} s), {len(rec['spans'])} spans; "
                  f"{top}", file=log)
    ctx = Context(system, traffic, driven, seconds, setup_s, reduced, gate.pauses)
    values: Dict[str, dict] = {}
    for m in metrics:
        v = registry.metric(m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    counted = ctx.counted()
    failed = sum(1 for r in counted if not r.ok)
    if traffic["driver"] == "open" and counted:
        late = sorted(r.sent - r.due for r in counted if r.sent is not None)
        print(f"generator: {len(late)} requests sent, late by median "
              f"{1e3 * late[len(late) // 2]:.3f} ms, at most {1e3 * late[-1]:.3f} ms", file=log)

    specs = {rid: r.spec for rid, r in driven["records"].items()}
    ids = {id(r) for r in counted if r.ok}
    done = {rid: r.future for rid, r in driven["records"].items() if id(r) in ids}
    outputs = {rid: driven["records"][rid].out for rid in done}
    picks = system.pick(specs, done, np.random.default_rng([seed, 3]), traffic["check_rows"])
    system.free()
    del ctx, driven
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    limits = traffic["limits"][cfg["name"]]
    t0 = time.perf_counter()
    if control and picks:
        outputs = system.reference(control, picks, specs)
        print(f"control: the reference in {control} in the program's place", file=log)
    value = system.compare(picks, specs, outputs) if picks else math.inf
    checks = {"gap": {"value": value, "limit": limits["gap"]}}
    print(f"reference: {len(picks)} pick(s) compared in {time.perf_counter() - t0:.1f} s",
          file=log)
    out = {"correct": bool(value <= limits["gap"]), "attempted": len(counted), "failed": failed,
           "metrics": values, "memory_peak_bytes": peak, "setup_s": setup_s,
           "checks": checks}
    if reduced is not None:
        out["busy_s"], out["window_s"] = reduced.busy_s, reduced.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in reduced.device_ops],
                            "idle_gaps": [list(x) for x in reduced.idle_gaps]}
    return out


def power_limit() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return got.stdout.strip().splitlines()[0] if got.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(args, t_process: float) -> int:
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    metrics = registry.cell_metrics(bench, cell["name"], bool(args.trace))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # a run that outlives its allowance leaves every thread's stack on stderr
    faulthandler.dump_traceback_later(300, exit=False)
    card = power_limit()
    print(f"card: {card}", file=sys.stderr)
    res = run_cell(cfg, traffic, metrics, args.seed, args.seconds, bool(args.trace), device,
                   t_process, control=args.control)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"error: the run loaded forbidden modules: {', '.join(found)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"],
                   "power_limit": card}
    if args.trace:
        device_info["busy_s"], device_info["window_s"] = res["busy_s"], res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device_info}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(line))
    return 0
