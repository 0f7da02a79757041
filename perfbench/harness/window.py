"""The arithmetic of a measured window over a completion log.

A completion is (time resolved, frames, ok). Completions that resolve within
`SIMULTANEOUS` seconds of the one before are one event: a server resolves
the requests of a batch one after another, and while their clients' threads
wake and take the interpreter lock the last can come tens of milliseconds
after the first; they were delivered together. Two batches of the cells'
servers complete a tenth of a second or more apart.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

SIMULTANEOUS = 0.05


def events(times: Sequence[float]) -> List[Tuple[float, List[int]]]:
    """Sorted completion times → [(event time, indices into `times`)]."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Tuple[float, List[int]]] = []
    last = None
    for i in order:
        if last is not None and times[i] - last <= SIMULTANEOUS:
            out[-1][1].append(i)
        else:
            out.append((times[i], [i]))
        last = times[i]
    return out


def throughput_window(times: Sequence[float], frames: Sequence[int], start: float,
                      seconds: float) -> Optional[Tuple[float, float, List[int], float]]:
    """(frames per second, window seconds, indices counted, window start):
    from the first completion event at or after `start` to the first at or
    after `start + seconds`, counting the frames of the events after the
    first, up to and with the last. None when fewer than two events qualify."""
    evs = [e for e in events(times) if e[0] >= start]
    if not evs:
        return None
    end = next((k for k, e in enumerate(evs) if e[0] >= start + seconds), None)
    if end is None or end == 0:
        return None
    counted = [i for _, idx in evs[1:end + 1] for i in idx]
    span = evs[end][0] - evs[0][0]
    return sum(frames[i] for i in counted) / span, span, counted, evs[0][0]


def overlap(a: Tuple[float, float], intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds of `intervals` inside the interval `a`."""
    return sum(max(0.0, min(a[1], e) - max(a[0], s)) for s, e in intervals)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it. An infinite value (a failed request) ranks last."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
