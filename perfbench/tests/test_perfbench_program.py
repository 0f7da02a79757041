"""Readings of the program's own spans and counters (`perfbench/harness/program.py`)
on a synthetic traced slice and synthetic spans with known idle inside and
outside the step loops, known dispatches and known request times; the
padded-window metric on the server's counters; and the span tool's wiring in
a whole toy run on the CPU."""
import math
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import program, readers, registry
from perfbench.harness.profiling import DeviceOp, Slice, reduce
from perfbench.tests import tiny
from perfbench.tools import trace_program

MS = 1_000_000


def span(name, start, end, thread=1, **attrs):
    return SimpleNamespace(name=name, start_ns=round(start * MS), end_ns=round(end * MS),
                           thread=thread, attrs=attrs)


# one window of a solo run: its refill, step loop and finish, under the generate call
SPANS = [span("beat.generate", 0, 100), span("engine.window", 1, 90),
         span("engine.begin", 1, 5), span("engine.steps", 5, 80), span("engine.finish", 80, 90),
         span("server.request", 0, 99, thread=None, request=0)]


def _op(name, start, end, corr):
    return DeviceOp(name, round(start * MS), round(end * MS), corr)


SLICE = Slice(
    [_op("copy", 6, 7, 1),                                    # eager, launched in the refill
     _op("encoder_layer_gemm", 7, 12, 2), _op("encoder_layer_norm", 12, 20, 2),  # replay 1
     _op("encoder_layer_gemm", 21, 35, 3),                    # replay 2: 1 ms after replay 1
     _op("encoder_layer_gemm", 35.5, 50, 4),                  # 0.5 ms
     _op("encoder_layer_gemm", 52, 60, 5),                    # 2 ms
     _op("cat", 81, 83, 6), _op("mul", 86, 88, 7),            # the finish; 21 ms, then 3 ms
     _op("encoder_layer_gemm", 96, 97, 8)],                   # launched after the sync
    {1: (2 * MS, "cudaMemcpyAsync"), 2: (5 * MS, "cudaGraphLaunch"),
     3: (6 * MS, "cudaGraphLaunch"), 4: (7 * MS, "cudaGraphLaunch"),
     5: (8 * MS, "cudaGraphLaunch"), 6: (round(80.5 * MS), "cudaLaunchKernel"),
     7: (85 * MS, "cudaLaunchKernel"), 8: (96 * MS, "cudaGraphLaunch")},
    0, 95 * MS)


def test_idle_goes_to_the_innermost_span_at_each_gap():
    lo, hi, gaps = program.device_idle(SLICE)
    assert (lo, hi) == (6 * MS, 88 * MS)
    assert [(s / MS, e / MS) for s, e in gaps] == [(20, 21), (35, 35.5), (50, 52), (60, 81),
                                                   (83, 86)]
    assert program.idle_by_span(SLICE, SPANS) == {"engine.steps": pytest.approx(0.0245),
                                                  "engine.finish": pytest.approx(0.003)}
    # a cross-thread span (a request) is never innermost; outside every span is "outside"
    assert program.idle_by_span(SLICE, SPANS[-1:]) == {"outside": pytest.approx(0.0275)}


def test_replay_gap_and_idle_outside_steps_add_up_to_the_idle_share():
    split = program.steps_split(SLICE, SPANS)
    assert split.steps == 4 and split.window_ns == 82 * MS
    assert [g / MS for g in split.launch_gaps_ns] == [1, 1, 1]
    gap = program.replay_gap_us(split)
    outside = program.idle_outside_steps_share(split)
    assert gap == pytest.approx(24.5e3 / 4)
    assert outside == pytest.approx(100 * 3 / 82)
    # the same slice through the benchmark's reduction and its idle-share reader
    idle = readers.device_idle_share(SimpleNamespace(reduced=reduce(SLICE, [])))
    assert 100 * gap * split.steps / (split.window_ns / 1e3) + outside == pytest.approx(idle)
    line = program.idle_line(SLICE, SPANS)
    assert line.startswith("program idle: engine.steps 0.024500 s, engine.finish 0.003000 s")
    assert "4 replays in engine.steps, median 1000.00 us" in line


def test_no_step_loop_reads_nothing():
    split = program.steps_split(SLICE, [span("server.dispatch", 0, 100)])
    assert split.steps == 0
    assert program.replay_gap_us(split) is None and program.idle_outside_steps_share(split) is None
    empty = Slice([], {}, 0, 10)
    assert program.steps_split(empty, SPANS) is None and program.idle_line(empty, SPANS) is None


def test_queue_wait_and_padded_share_over_the_window():
    spans = [span("server.request", 5, 40, thread=None, request=0),    # submitted before
             span("server.request", 10, 40, thread=None, request=1),
             span("server.request", 12, 41, thread=None, request=2),
             span("server.request", 30, 70, thread=None, request=3),
             span("server.request", 50, 52, thread=None, request=4),   # failed, never dispatched
             span("server.dispatch", 4, 6, requests=[9], windows_encoded=16, windows_carried=2),
             span("server.dispatch", 20, 25, requests=[0, 1, 2], windows_encoded=16,
                  windows_carried=6),
             span("server.dispatch", 45, 49, requests=[3], windows_encoded=8, windows_carried=8)]
    lo, hi = 8 * MS, 60 * MS
    assert program.queue_wait_ms(spans, lo, hi, q=50) == pytest.approx(10.0)   # 8, 10, 15, inf
    assert program.queue_wait_ms(spans, lo, hi) == math.inf
    assert program.queue_wait_ms(spans, lo, 40 * MS) == pytest.approx(15.0)
    assert program.queue_wait_ms(spans, 80 * MS, 90 * MS) is None
    assert program.padded_share(spans, lo, hi) == pytest.approx(100 * (24 - 14) / 24)
    assert program.padded_share(spans, 80 * MS, 90 * MS) is None


def test_capture_seconds_before_the_window_and_clocks():
    spans = [span("graphs.capture", 1, 3, what="encoder"), span("graphs.capture", 3, 4),
             span("graphs.capture", 9, 12), span("engine.begin", 0, 5)]
    assert program.capture_s(spans, 8 * MS) == pytest.approx(0.003)
    assert program.capture_s(spans, 2 * MS) is None
    clocks = program.Clocks(10.0, 1_000)
    assert clocks.to_ns(10.5) == 1_000 + 500_000_000
    now = program.Clocks.read()
    assert abs(now.to_ns(now.perf) - now.ns) <= 1


def test_padded_share_metric_reads_the_servers_counters():
    metric = registry.metric("wavlm_padded_share.latency")
    assert metric.SOURCE == "program_counter" and metric.UNIT == "%"
    server = SimpleNamespace(windows_encoded=20, windows_padding=15)
    assert metric.read(SimpleNamespace(system=SimpleNamespace(server=server))) == 75.0
    # a server without the counters (the parent's), or none (the solo cell): nothing to read
    assert metric.read(SimpleNamespace(system=SimpleNamespace(server=object()))) is None
    assert metric.read(SimpleNamespace(system=SimpleNamespace())) is None


def test_span_tool_on_a_toy_open_run():
    """The tool's wiring: a whole toy run of the open cell with the program's
    spans on, then its readings; the spans are off again afterwards."""
    from diffusestylegesture_torch.utils import profiling as spans
    from perfbench.harness import drive, profiling as harness, runner

    bench = registry.benchmark()
    cell = registry.workload(bench, "zeggs-dpmpp5-open")
    drivers, capture = dict(drive.DRIVERS), harness.capture
    res, kept = trace_program.traced(
        runner.run_cell, tiny.config("zeggs"), tiny.traffic(cell["traffic"]),
        registry.cell_metrics(bench, cell["name"], True), 2 ** 31 + 7, 1.5, False,
        torch.device("cpu"), 0.0)
    assert not spans.enabled() and drive.DRIVERS == drivers and harness.capture is capture
    assert res["correct"] and res["metrics"]["wavlm_padded_share.latency"]["value"] > 0
    got = trace_program.readings(kept, 1.5)
    assert got["spans"] > 0 and got["capture_s"] is None   # the CPU captures no graph
    assert 0 <= got["queue_wait_ms"] < math.inf and 0 < got["padded_share"] < 100
    assert "replay_gap_us" not in got                      # no traced slice
    spans.clear()
