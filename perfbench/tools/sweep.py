"""Find the highest arrival rate an open-loop cell's server sustains, by a
sweep of fixed rates in one process (one set-up, one server).

    python3 perfbench/tools/sweep.py --workload zeggs-dpmpp5-open --seed 1 \\
        --seconds 20 --rates 20,30,40,50

For each rate it prints one JSON line: requests offered and resolved per
second, p50 / p95 latency (from when each request was due), and the p95 of the
window's first and last thirds. A rate is sustained when the server resolves
at least 98% of the offered rate and the last third's p95 is within 1.5× of
the first third's (no growing backlog). The cell's traffic file then records
four fifths of the highest sustained rate; this tool is not part of a run.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def stats(records: dict, start: float, seconds: float) -> dict:
    from perfbench.harness.window import percentile

    due = sorted((r for r in records.values() if start <= r.due < start + seconds),
                 key=lambda r: r.due)
    lat = [r.done - r.due if r.ok and r.done is not None else math.inf for r in due]
    # resolutions after a warm-up fifth of the window, to its end: the offered
    # rate at a steady state, less where a backlog grows
    lo = start + seconds / 5
    resolved = sum(1 for r in records.values() if r.ok and r.done is not None
                   and lo <= r.done < start + seconds)
    third = max(1, len(lat) // 3)
    return {"offered_per_s": len(due) / seconds,
            "resolved_per_s": resolved / (start + seconds - lo),
            "p50_s": percentile(lat, 50), "p95_s": percentile(lat, 95),
            "p95_first_third_s": percentile(lat[:third], 95),
            "p95_last_third_s": percentile(lat[-third:], 95), "requests": len(due)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="open-loop rate sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True, help="comma-separated requests per second")
    args = p.parse_args(argv)

    import torch

    from perfbench.harness import drive, registry, weights
    from perfbench.harness.recorder import Recorder

    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    if traffic["driver"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    dev = torch.device("cuda", 0)
    system = registry.system(cfg["system"]).System(cfg, traffic, dev)
    system.load(weights.make(system.layouts(), args.seed, dev), args.seed)
    system.start(args.seed, Recorder())
    for rate in (float(r) for r in args.rates.split(",")):
        t = copy.deepcopy(traffic)
        t["arrivals"] = {"poisson": rate}
        got = drive.open_loop(system, t, args.seed, args.seconds)
        line = {"rate": rate, **stats(got["records"], got["start"], args.seconds)}
        line["sustained"] = (line["resolved_per_s"] >= 0.98 * line["offered_per_s"]
                             and line["p95_last_third_s"] <= 1.2 * line["p95_first_third_s"])
        print(json.dumps(line), flush=True)
        time.sleep(1.0)
    system.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
