"""Readings of the program's own spans and counters
(`diffusestylegesture_torch/utils/profiling.py`, `sample/server.py`).

The program stamps its spans on the clock the profiler stamps its host
events with (`time.time_ns`); the driver's window is on `time.perf_counter`.
`Clocks` carries a window bound from one to the other through one paired
reading of both. `device_idle` gives the device's idle intervals in a traced
slice, with the operations chosen and united as `profiling.reduce` chooses
and unites them; each gap goes to the innermost program span open at its
start (`SpanIndex.at`), as `reduce` gives gaps to the benchmark's spans.

A program span here is any object with `name`, `start_ns`, `end_ns`,
`thread` and `attrs` (`profiling.Span`); a span recorded across threads
(`thread` None: a request) holds no host work and is never innermost.
"""
from __future__ import annotations

import bisect
import math
import statistics
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .profiling import Slice, union
from .window import percentile

STEPS = "engine.steps"


class Clocks(NamedTuple):
    perf: float
    ns: int

    @classmethod
    def read(cls) -> "Clocks":
        """`time.time_ns` between two `perf_counter` readings, paired with their mean."""
        a = time.perf_counter()
        ns = time.time_ns()
        b = time.perf_counter()
        return cls((a + b) / 2, ns)

    def to_ns(self, t: float) -> int:
        """A `perf_counter` time on the `time_ns` clock."""
        return self.ns + round((t - self.perf) * 1e9)


def device_idle(sl: Slice) -> Optional[Tuple[int, int, List[Tuple[int, int]]]]:
    """(device window start, end, idle gaps) in ns of the operations launched
    inside the slice, or None where none was."""
    inside = {corr for corr, (t, _) in sl.launches.items() if sl.start_ns <= t < sl.sync_ns}
    busy = union([(o.start_ns, o.end_ns) for o in sl.ops if o.correlation in inside])
    if not busy:
        return None
    return busy[0][0], busy[-1][1], [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]


class SpanIndex:
    """The program spans with a thread that overlap [lo, hi] ns, sorted by start."""

    def __init__(self, spans: Sequence, lo: float = -math.inf, hi: float = math.inf):
        self.spans = sorted((sp for sp in spans if sp.thread is not None
                             and sp.end_ns >= lo and sp.start_ns <= hi),
                            key=lambda sp: sp.start_ns)
        self.starts = [sp.start_ns for sp in self.spans]

    def at(self, t: int):
        """The innermost span open at host time t: of those that hold it, the
        latest started (spans nest on a thread); None where none does."""
        for k in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[k].end_ns >= t:
                return self.spans[k]
        return None


def idle_by_span(sl: Slice, spans: Sequence) -> Optional[Dict[str, float]]:
    """Device idle seconds by the innermost program span at each gap's start
    ("outside" where none is open); None where nothing was launched inside."""
    got = device_idle(sl)
    if got is None:
        return None
    lo, hi, gaps = got
    index = SpanIndex(spans, lo, hi)
    out: Dict[str, float] = defaultdict(float)
    for e0, s1 in gaps:
        sp = index.at(e0)
        out[sp.name if sp else "outside"] += (s1 - e0) / 1e9
    return dict(out)


class StepsSplit(NamedTuple):
    window_ns: int
    idle_in_steps_ns: int
    idle_outside_ns: int
    steps: int                  # graph replays launched in the slice inside `engine.steps`
    launch_gaps_ns: List[int]   # host time between consecutive such replays of one span


def steps_split(sl: Slice, spans: Sequence) -> Optional[StepsSplit]:
    """Device idle inside and outside the program's step loops, with the
    replays launched in them (the slice's launches only, as `reduce` reads them)."""
    got = device_idle(sl)
    if got is None:
        return None
    lo, hi, gaps = got
    index = SpanIndex(spans, lo, hi)
    inside = outside = 0
    for e0, s1 in gaps:
        sp = index.at(e0)
        if sp is not None and sp.name == STEPS:
            inside += s1 - e0
        else:
            outside += s1 - e0
    index = SpanIndex(spans, sl.start_ns, sl.sync_ns)
    by_span: Dict[int, List[int]] = defaultdict(list)
    for t, call in sl.launches.values():
        if call == "cudaGraphLaunch" and sl.start_ns <= t < sl.sync_ns:
            sp = index.at(t)
            if sp is not None and sp.name == STEPS:
                by_span[id(sp)].append(t)
    launch_gaps = []
    for ts in by_span.values():
        ts.sort()
        launch_gaps += [b - a for a, b in zip(ts, ts[1:])]
    return StepsSplit(hi - lo, inside, outside, sum(len(ts) for ts in by_span.values()),
                      launch_gaps)


def replay_gap_us(split: Optional[StepsSplit]) -> Optional[float]:
    """Device idle µs inside the step loops per step replayed in them."""
    if split is None or not split.steps:
        return None
    return split.idle_in_steps_ns / 1e3 / split.steps


def idle_outside_steps_share(split: Optional[StepsSplit]) -> Optional[float]:
    """100 × device idle while the host was in no step loop ÷ the device window."""
    if split is None or not split.window_ns or not split.steps:
        return None
    return 100.0 * split.idle_outside_ns / split.window_ns


def queue_wait_ms(spans: Sequence, lo: int, hi: int, q: float = 95.0) -> Optional[float]:
    """Nearest-rank percentile, over the requests submitted in [lo, hi) ns, of
    submit → the start of the `server.dispatch` span that holds the request
    (a request never dispatched ranks as infinite)."""
    dispatched: Dict[int, int] = {}
    for sp in spans:
        if sp.name == "server.dispatch":
            for rid in sp.attrs.get("requests", ()):
                dispatched[rid] = sp.start_ns
    waits = [(dispatched[sp.attrs["request"]] - sp.start_ns) / 1e6
             if sp.attrs["request"] in dispatched else math.inf
             for sp in spans if sp.name == "server.request" and lo <= sp.start_ns < hi]
    return percentile(waits, q) if waits else None


def padded_share(spans: Sequence, lo: int, hi: int) -> Optional[float]:
    """100 × (windows encoded − windows carrying a request's audio) ÷ windows
    encoded, over the `server.dispatch` spans that started in [lo, hi) ns."""
    ds = [sp.attrs for sp in spans if sp.name == "server.dispatch" and lo <= sp.start_ns < hi]
    encoded = sum(a["windows_encoded"] for a in ds)
    if not encoded:
        return None
    return 100.0 * (encoded - sum(a["windows_carried"] for a in ds)) / encoded


def counted_padded_share(server) -> Optional[float]:
    """100 × `windows_padding` ÷ `windows_encoded` of a `GestureServer`'s
    counters (every batch it dispatched); None where it keeps none."""
    encoded = getattr(server, "windows_encoded", None)
    if not encoded:
        return None
    return 100.0 * server.windows_padding / encoded


def capture_s(spans: Sequence, before: int) -> Optional[float]:
    """Seconds in `graphs.capture` spans that ended before `before` ns."""
    caps = [sp for sp in spans if sp.name == "graphs.capture" and sp.end_ns <= before]
    return sum(sp.end_ns - sp.start_ns for sp in caps) / 1e9 if caps else None


def idle_line(sl: Slice, spans: Sequence) -> Optional[str]:
    """The traced run's `program idle:` line: device idle by innermost program
    span, and the median host interval between consecutive replays in a step loop."""
    by = idle_by_span(sl, spans)
    split = steps_split(sl, spans)
    if by is None or split is None:
        return None
    parts = ", ".join(f"{name} {sec:.6f} s" for name, sec in
                      sorted(by.items(), key=lambda kv: -kv[1]))
    med = (f"{statistics.median(split.launch_gaps_ns) / 1e3:.2f} us"
           if split.launch_gaps_ns else "none")
    return (f"program idle: {parts} of {split.window_ns / 1e9:.6f} s; {split.steps} replays "
            f"in {STEPS}, median {med} between their launches")
