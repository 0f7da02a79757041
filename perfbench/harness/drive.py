"""The load: a closed loop of clients, or an open loop of arrivals at fixed
times, against a system's `submit(spec) -> Future`.

Every request gets a record: its spec, when it was due (open loop) or sent,
when its Future resolved (stamped by a done-callback in the resolving thread)
and its output or failure. `mid()` is called once, in the driving thread,
half way through the window (the traced run's profiler slice).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from . import traffic as traffic_gen


class Record:
    __slots__ = ("spec", "due", "sent", "done", "ok", "out", "future")

    def __init__(self, spec: dict, due: float):
        self.spec, self.due, self.sent, self.future = spec, due, None, None
        self.done: Optional[float] = None
        self.ok = False
        self.out = None


def _finish(rec: Record, fut) -> None:
    try:
        rec.out = fut.result()
        rec.ok = True
    except Exception:  # a failed request: counted in `failed`, never compared
        rec.ok = False


def _watch(rec: Record, fut) -> None:
    rec.future = fut

    def done(f):
        rec.done = time.perf_counter()
        _finish(rec, f)
    fut.add_done_callback(done)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def closed(system, traffic: dict, seed: int, seconds: float,
           mid: Optional[Callable[[], None]] = None, drain_s: float = 300.0) -> dict:
    """`clients` clients, each sending its next request when its last one
    resolved, until a completion event at or after `start + seconds`."""
    specs = traffic_gen.specs(traffic, seed)
    lock = threading.Lock()
    records: Dict[int, Record] = {}
    stop = threading.Event()

    def client():
        while not stop.is_set():
            with lock:
                spec = next(specs)
                rec = records[spec["id"]] = Record(spec, time.perf_counter())
            rec.sent = rec.due
            fut = system.submit(spec)
            _watch(rec, fut)
            try:
                fut.result()
            except Exception:  # recorded by the callback
                pass

    start = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True) for _ in range(traffic["clients"])]
    for t in threads:
        t.start()
    if mid is not None:
        _sleep_until(start + seconds / 2)
        mid()
    _sleep_until(start + seconds)
    deadline = time.perf_counter() + drain_s
    while time.perf_counter() < deadline:
        with lock:
            times = [r.done for r in records.values() if r.done is not None]
        if any(t >= start + seconds for t in times):
            break
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    return {"start": start, "records": records, "clients_alive": sum(t.is_alive() for t in threads)}


def open_loop(system, traffic: dict, seed: int, seconds: float,
              mid: Optional[Callable[[], None]] = None, drain_s: float = 60.0) -> dict:
    """Arrivals at the traffic's fixed gaps from `start` for `seconds`; then
    up to `drain_s` more for the last of them to resolve."""
    specs = traffic_gen.specs(traffic, seed)
    gaps = traffic_gen.gaps(traffic, seed)
    records: Dict[int, Record] = {}

    def submitter(start):
        due = start
        for spec in specs:
            due += next(gaps)
            if due >= start + seconds:
                return
            _sleep_until(due)
            rec = records[spec["id"]] = Record(spec, due)
            rec.sent = time.perf_counter()
            try:
                _watch(rec, system.submit(spec))
            except Exception:  # refused at submit: a failed request
                rec.done = time.perf_counter()

    start = time.perf_counter()
    th = threading.Thread(target=submitter, args=(start,), daemon=True)
    th.start()
    if mid is not None:
        _sleep_until(start + seconds / 2)
        mid()
    th.join()
    deadline = start + seconds + drain_s
    while time.perf_counter() < deadline and any(r.done is None for r in list(records.values())):
        time.sleep(0.01)
    return {"start": start, "records": records, "clients_alive": 0}


DRIVERS = {"closed": closed, "open": open_loop}
