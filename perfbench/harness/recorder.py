"""The benchmark's own spans: host-clock ranges around the calls it makes
into the program's layers, kept in memory.

`wrap(obj, attr, layer, count)` replaces a bound method of one object with a
wrapper that records (layer, start ns, end ns, count) on the clock the
profiler stamps its host events with (`time.time_ns`). The program is not
edited: the wrapper sits on the instance the benchmark built.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, NamedTuple, Optional


class Span(NamedTuple):
    layer: str
    start_ns: int
    end_ns: int
    count: Optional[int]


class Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def wrap(self, obj, attr: str, layer: str,
             count: Optional[Callable[[tuple], int]] = None) -> None:
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                span = Span(layer, t0, time.time_ns(), count(args) if count else None)
                with self._lock:
                    self.spans.append(span)

        setattr(obj, attr, wrapped)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)
