"""What the metric files under `perfbench/metrics/` share: each reader takes
the run's `Context` and returns a number, or None where it finds nothing to
read (the harness then leaves the metric out of the line; a share of a
roofline or a peak is never reported as 0 for want of data)."""
from __future__ import annotations

import math
from typing import List, Optional

from perfbench import counts
from .profiling import kernel_seconds
from .window import overlap, percentile, throughput_window


class Context:
    """A run's readings: the system, its completion records, the window, the
    traced slice (`reduced`, or None with trace off) and set-up seconds."""

    def __init__(self, system, traffic: dict, driven: dict, seconds: float, setup_s: float,
                 reduced=None, pauses=()):
        self.system, self.traffic, self.seconds = system, traffic, seconds
        self.start, self.records = driven["start"], driven["records"]
        self.setup_s, self.reduced = setup_s, reduced
        # when the card idled while the traced slice's profiler started and stopped
        self.pauses = list(pauses)
        self._window = None

    def closed_window(self):
        """(frames/s, seconds, [records counted]) of a closed loop's window, or None."""
        if self._window is None:
            done = [r for r in self.records.values() if r.done is not None]
            frames = [self.system.frames(r.spec) if r.ok else 0 for r in done]
            got = throughput_window([r.done for r in done], frames, self.start, self.seconds)
            self._window = (None if got is None else
                            (got[0], got[1], [done[i] for i in got[2]], got[3]))
        return self._window

    def due_in_window(self) -> list:
        """An open loop's requests due inside the window (all it sent)."""
        return [r for r in self.records.values()
                if self.start <= r.due < self.start + self.seconds]

    def counted(self) -> list:
        """The requests a run's end-to-end metric counts."""
        if self.traffic["driver"] == "open":
            return self.due_in_window()
        w = self.closed_window()
        return [] if w is None else w[2]

    def window_seconds(self) -> Optional[float]:
        if self.traffic["driver"] == "open":
            return self.seconds
        w = self.closed_window()
        return None if w is None else w[1]


def frames_per_s(ctx: Context) -> Optional[float]:
    w = ctx.closed_window()
    return None if w is None else w[0]


def latency_p95(ctx: Context) -> Optional[float]:
    reqs = ctx.due_in_window()
    lat = [r.done - r.due if r.ok and r.done is not None else math.inf for r in reqs]
    return percentile(lat, 95.0) if lat else None


def _layer(ctx: Context, name: str) -> Optional[dict]:
    if ctx.reduced is None:
        return None
    return ctx.reduced.layers.get(name)


def kernel_roofline(ctx: Context, layer: str, pattern: str, calls_pattern: str,
                    kernel: str) -> Optional[float]:
    """100 × least time ÷ device time of the kernels matching `pattern` in the
    layer's complete CUDA-graph replays; one kernel matching `calls_pattern`
    marks one call of `kernel` at the cell's shape (`system.kernel_shapes`)."""
    rec = _layer(ctx, layer)
    if rec is None:
        return None
    _, sec = kernel_seconds(rec, pattern)
    calls, _ = kernel_seconds(rec, calls_pattern)
    if not calls or sec <= 0:
        return None
    flops, nbytes = getattr(counts, kernel)(*ctx.system.kernel_shapes()[kernel])
    return 100.0 * calls * counts.least_seconds(flops, nbytes) / sec


def denoiser_us_per_call(ctx: Context) -> Optional[float]:
    """Device µs of the denoiser's CUDA-graph replays per call, one call being
    one kernel-A launch (each denoiser call launches it once)."""
    rec = _layer(ctx, "denoiser")
    if rec is None:
        return None
    calls, _ = kernel_seconds(rec, r"^local_attention_kernel")
    return 1e6 * rec["graph_seconds"] / calls if calls else None


def wavlm_us_per_window(ctx: Context) -> Optional[float]:
    """Device µs of the encoder's replays per window encoded (B × bucket)."""
    rec = _layer(ctx, "wavlm")
    if rec is None:
        return None
    windows = sum(sp.count or 0 for sp in rec["spans"])
    return 1e6 * rec["graph_seconds"] / windows if windows else None


def mfu(ctx: Context) -> Optional[float]:
    """100 × model FLOPs of the counted requests (`system.work`) ÷ window
    seconds ÷ the peak of the configuration's precision. A closed loop's
    window leaves out the time the card idled for the profiler; an open
    loop's work is that of the requests due in its window, whenever served."""
    reqs = [r for r in ctx.counted() if r.ok]
    sec = ctx.window_seconds()
    if not reqs or not sec:
        return None
    if ctx.traffic["driver"] != "open":
        t0 = ctx.closed_window()[3]
        sec -= overlap((t0, t0 + sec), ctx.pauses)
    flops = sum(ctx.system.work(r.spec) for r in reqs)
    return 100.0 * flops / sec / counts.PEAKS[ctx.system.peak + "_flops"]


def device_idle_share(ctx: Context) -> Optional[float]:
    if ctx.reduced is None or ctx.reduced.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.reduced.busy_s / ctx.reduced.window_s)


def batch_fill(ctx: Context) -> Optional[float]:
    """100 × requests ÷ (batches × max batch) over the batches that served
    requests due in the window."""
    mine = {id(r.future) for r in ctx.due_in_window() if r.future is not None}
    batches: List[list] = [futs for _, futs, _ in ctx.system.server.batches
                           if any(id(f) in mine for f in futs)]
    if not batches:
        return None
    return 100.0 * sum(len(b) for b in batches) / (len(batches) *
                                                   ctx.traffic["server"]["max_batch"])
