"""Program spans and trace capture.

A span is a named host-time range recorded where the work happens: the
server's request and batch path, the engine's windows and their step loops,
graph captures. It is stamped on the clock that `torch.profiler` stamps its
host events with (`time.time_ns`), so a gap in a profiler trace of the card
can be put down to what the program was doing then.

Tracing is off by default. `span(name, **attrs)` then returns one shared
no-op context after one global check; it records nothing, and it is falsy,
so a call site builds costly attrs only under `if sp: sp.set(...)`. After
`enable(True)` each span is recorded, when it closes, as a `Span` (id, parent
id, name, start ns, end ns, thread, attrs) in an in-memory list; its parent
is the innermost span open on the same thread. `record` adds a span that
crosses threads (a request, from submit to its result), with no thread.
`spans()` returns a snapshot and `clear()` empties the list; nothing is
written to disk.

`trace_capture(log_dir)` writes a `torch.profiler` Chrome trace. Inside it
tracing is on and each span also opens a `record_function` range, so the
program's spans show on the trace's timeline.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    thread: Optional[int]   # threading.get_ident(); None for a span recorded across threads
    attrs: Dict[str, object]


_on = False          # record spans
_annotate = False    # open a record_function range with each span (trace_capture)
_spans: List[Span] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The context `span` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass

    def drop(self) -> None:
        pass


_OFF = _Off()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded; it is appended to the list when it closes."""
    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "dropped", "_range")

    def __init__(self, name: str, attrs: dict):
        self.id, self.name, self.attrs, self.dropped = next(_ids), name, attrs, False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def drop(self) -> None:
        """Record nothing for this span (e.g. a poll that found no work)."""
        self.dropped = True

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._range = torch.profiler.record_function(self.name) if _annotate else None
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        if not self.dropped:
            _append(Span(self.id, self.parent, self.name, self.start_ns, end,
                         threading.get_ident(), self.attrs))
        return False


def _append(sp: Span) -> None:
    with _lock:
        _spans.append(sp)


def enable(on: bool = True) -> None:
    """Turn tracing on or off for the whole process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str, **attrs):
    """A context that records the span `name` while tracing is on (module docstring)."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def record(name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
           **attrs) -> Optional[int]:
    """Record a span whose ends lie in different threads or calls; returns its
    id (None while tracing is off)."""
    if not _on:
        return None
    sid = next(_ids)
    _append(Span(sid, parent, name, start_ns, end_ns, None, attrs))
    return sid


def spans() -> List[Span]:
    """The spans recorded so far, in the order they closed."""
    with _lock:
        return list(_spans)


def clear() -> None:
    with _lock:
        _spans.clear()


@contextlib.contextmanager
def trace_capture(log_dir: str):
    """A `torch.profiler` trace of the CPU and, where there is one, the card,
    written into `log_dir` as a Chrome trace (TensorBoard's profiler plugin
    and chrome://tracing read it), with the program's spans as ranges on it."""
    global _on, _annotate
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = _on, _annotate
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        _on = _annotate = True
        try:
            yield prof
        finally:
            _on, _annotate = was
