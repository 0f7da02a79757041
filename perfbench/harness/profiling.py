"""The traced slice: `torch.profiler` over a few seconds in the middle of the
window, reduced in memory (no trace file is written).

Every device operation (kernel, copy, set) is tied to the host call that
launched it through the profiler's correlation id (a CUDA graph's kernels
carry the id of its `cudaGraphLaunch`), and that launch to the benchmark's
span (`recorder.Span`) it happened in. Only launches made after the profiler
started and before the synchronize that ends the slice began are read: all
their device work lies inside the trace.
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .recorder import Span


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    correlation: int


class Slice(NamedTuple):
    ops: List[DeviceOp]
    launches: Dict[int, Tuple[int, str]]  # correlation id → (host time, runtime call)
    start_ns: int
    sync_ns: int                      # the synchronize that ends the slice began here


class Gate:
    """Holds the program's CUDA-graph replays while the profiler stops.

    Stopping the profiler while another thread is blocked in `cudaGraphLaunch`
    on a full launch queue can deadlock (seen on the H100 machine with the
    server's dispatcher). `install` wraps `utils.graphs.StepGraph.replay` in
    this process so that each replay first waits for the gate; `capture`
    closes it, lets the card drain, starts or stops the profiler and opens it
    again."""

    def __init__(self):
        self._open = threading.Event()
        self._open.set()
        self.pauses: List[Tuple[float, float]] = []   # perf_counter intervals the card idled

    def install(self) -> None:
        from diffusestylegesture_torch.utils import graphs

        real, opened = graphs.StepGraph.replay, self._open

        def replay(graph, n: int = 1) -> None:
            opened.wait()
            real(graph, n)

        graphs.StepGraph.replay = replay

    def close(self) -> None:
        self._open.clear()

    def open(self) -> None:
        self._open.set()


def capture(seconds: float, gate: Gate) -> Slice:
    """Profile the card for `seconds` while the run goes on in other threads;
    `gate.pauses` then holds when the card waited for the profiler to start
    and to stop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    gate.close()
    torch.cuda.synchronize()
    drained = time.perf_counter()
    try:
        prof.start()
    finally:
        gate.pauses.append((drained, time.perf_counter()))
        gate.open()
    start = time.time_ns()
    time.sleep(seconds)
    gate.close()
    sync = time.time_ns()
    torch.cuda.synchronize()
    drained = time.perf_counter()
    try:
        prof.stop()
    finally:
        gate.pauses.append((drained, time.perf_counter()))
        gate.open()
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append(DeviceOp(e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.correlation_id() and e.name().startswith("cuda"):
            launches[e.correlation_id()] = (e.start_ns(), e.name())
    return Slice(ops, launches, start, sync)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace, template
    arguments and parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _span_at(spans: Sequence[Span], starts: List[int], t: int) -> Optional[Span]:
    """The innermost span holding host time t (`spans` sorted by start, `starts`
    their starts); the benchmark's spans do not nest, so the latest started."""
    k = bisect.bisect_right(starts, t) - 1
    return spans[k] if k >= 0 and spans[k].end_ns >= t else None


class Reduced(NamedTuple):
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]            # top operations by device seconds
    idle_gaps: List[Tuple[str, float]]             # longest idle gaps, by what the host did
    # per layer of the benchmark's spans, over complete launches: {layer: {"launches":
    # n, "graph_launches": n, "graph_seconds": busy s of its CUDA-graph replays,
    # "kernels": {short name: [count, [(start, end) ns]]} (in replays), "spans": [Span]}}
    layers: Dict[str, dict]


def _busy_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in union(intervals))


def reduce(sl: Slice, spans: Sequence[Span], top: int = 10) -> Reduced:
    """Only operations launched inside the slice, before its closing synchronize,
    are read: on the program's one stream they run back to back after whatever
    was queued before, so the device window is from the first one's start to
    the last one's end, and a gap inside it is the device waiting for the host.
    Time is a union of intervals: grids launched with programmatic dependent
    launch start before the grid they wait on ends, and their durations overlap."""
    spans = sorted(spans, key=lambda sp: sp.start_ns)
    starts = [sp.start_ns for sp in spans]
    names: Dict[str, str] = {}

    def short(n: str) -> str:
        if n not in names:
            names[n] = short_name(n)
        return names[n]

    owner: Dict[int, Tuple[Optional[Span], bool]] = {}
    for corr, (t, call) in sl.launches.items():
        if sl.start_ns <= t < sl.sync_ns:
            owner[corr] = (_span_at(spans, starts, t), call == "cudaGraphLaunch")
    inside = [o for o in sl.ops if o.correlation in owner]
    if not inside:
        return Reduced(0.0, 0.0, [], [], {})
    lo = min(o.start_ns for o in inside)
    hi = max(o.end_ns for o in inside)
    busy = union([(o.start_ns, o.end_ns) for o in inside])
    by_name: Dict[str, list] = defaultdict(list)
    for o in inside:
        by_name[short(o.name)].append((o.start_ns, o.end_ns))
    device_ops = sorted(((n, _busy_ns(iv) / 1e9) for n, iv in by_name.items()),
                        key=lambda kv: -kv[1])[:top]
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        sp = _span_at(spans, starts, e0)
        gaps.append(("host in " + sp.layer if sp else "host outside the engine's calls",
                     (s1 - e0) / 1e9))
    idle_gaps = sorted(gaps, key=lambda g: -g[1])[:top]

    layers: Dict[str, dict] = {}
    for o in inside:
        sp, graph = owner[o.correlation]
        if sp is None:
            continue
        rec = layers.setdefault(sp.layer, {"launches": set(), "graph_launches": set(),
                                           "graph": [], "kernels": {}, "spans": {}})
        rec["launches"].add(o.correlation)
        rec["spans"][(sp.start_ns, sp.end_ns)] = sp
        if graph:
            rec["graph_launches"].add(o.correlation)
            rec["graph"].append((o.start_ns, o.end_ns))
            k = rec["kernels"].setdefault(short(o.name), [0, []])
            k[0] += 1
            k[1].append((o.start_ns, o.end_ns))
    for rec in layers.values():
        rec["launches"] = len(rec["launches"])
        rec["graph_launches"] = len(rec["graph_launches"])
        rec["graph_seconds"] = _busy_ns(rec.pop("graph")) / 1e9
        rec["spans"] = list(rec["spans"].values())
    return Reduced(_busy_ns(busy) / 1e9, (hi - lo) / 1e9, device_ops, idle_gaps, layers)


def kernel_seconds(layer: dict, pattern: str) -> Tuple[int, float]:
    """(launches, busy device seconds) of a layer's kernels whose short name
    matches `pattern`, in its CUDA-graph replays."""
    rx = re.compile(pattern)
    n, iv = 0, []
    for name, (count, intervals) in layer.get("kernels", {}).items():
        if rx.search(name):
            n += count
            iv += intervals
    return n, _busy_ns(iv) / 1e9
