"""Window and percentile arithmetic on synthetic completion logs."""
import math

from perfbench.harness import window


def test_simultaneous_completions_are_one_event():
    # a batch resolved over 80 ms in steps of 20 ms is one event
    evs = window.events([1.0, 1.02, 2.0, 1.04, 1.06, 1.08])
    assert [sorted(idx) for _, idx in evs] == [[0, 1, 3, 4, 5], [2]]


def test_throughput_counts_events_after_the_first_through_the_last():
    # batches of 2 requests (100 frames each) at 1, 3, 5, 7 s; window from 0.5 for 4 s
    times = [1.0, 1.03, 3.0, 3.03, 5.0, 5.03, 7.0, 7.03]
    frames = [100] * 8
    rate, span, counted, t0 = window.throughput_window(times, frames, 0.5, 4.0)
    assert t0 == 1.0
    # first event at 1.0, first at or after 4.5 is 5.0: events at 3 and 5 counted
    assert span == 4.0 and sorted(counted) == [2, 3, 4, 5]
    assert rate == 400 / 4.0


def test_a_stall_inside_the_window_counts():
    steady = [1.0, 2.0, 3.0, 4.0, 5.0]
    stalled = [1.0, 2.0, 4.5, 5.0, 6.0]   # 1.5 s without a completion
    r1, _, _, _ = window.throughput_window(steady, [10] * 5, 0.5, 3.0)
    r2, span, _, _ = window.throughput_window(stalled, [10] * 5, 0.5, 3.0)
    assert r1 == 30 / 3.0
    assert span == 3.5 and r2 == 20 / 3.5


def test_no_window_without_two_events():
    assert window.throughput_window([1.0], [5], 0.0, 10.0) is None
    assert window.throughput_window([], [], 0.0, 1.0) is None


def test_overlap_counts_only_the_inside():
    assert window.overlap((1.0, 5.0), [(0.0, 2.0), (4.5, 9.0), (6.0, 7.0)]) == 1.5


def test_percentile_nearest_rank_with_failures_last():
    vals = list(range(1, 101))
    assert window.percentile(vals, 95) == 95
    assert window.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert window.percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert window.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf
