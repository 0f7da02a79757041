"""Run one cell as `perfbench/run.py` does, with the program's own spans on
from the start of the process, and read them.

    python3 perfbench/tools/trace_program.py --workload <name> --seed <n> \\
        --seconds 30 --trace <0|1>

It prints `run.py`'s result line, then one JSON line {"program": {...}} of
the readings that need the program's spans (`perfbench/harness/program.py`):

* `capture_s`: seconds in `graphs.capture` spans that ended before the window;
* `queue_wait_ms`: p95 of submit → dispatch over the requests submitted in the
  window, and `padded_share`: the share of the windows WavLM encoded that
  carry no request's audio, over the dispatches that started in it (server
  cells);
* with `--trace 1`: `replay_gap_us` (device idle inside `engine.steps` spans
  per step replayed in them), `idle_outside_steps_share` and
  `device_idle_share` of the traced slice, and a `program idle:` line on
  stderr (device idle by innermost program span).

With `--trace 0` the result line's end-to-end metrics are those of a run with
spans on and the profiler off: against `run.py`'s, the cost of the spans.
`run.py` itself leaves the spans off; this tool is not part of a run.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def traced(run, *args, **kwargs):
    """`run(*args, **kwargs)` (a cell's run) with the program's spans on, the
    traced slice and the drive's result kept; returns (its result, kept)."""
    from diffusestylegesture_torch.utils import profiling as spans
    from perfbench.harness import drive, program
    from perfbench.harness import profiling as harness

    kept = {"clocks": program.Clocks.read()}
    real_capture, real_drivers = harness.capture, dict(drive.DRIVERS)

    def capture(seconds, gate):
        kept["slice"] = real_capture(seconds, gate)
        return kept["slice"]

    def keeping(fn):
        def drive_cell(*a, **k):
            kept["driven"] = fn(*a, **k)
            return kept["driven"]
        return drive_cell

    harness.capture = capture
    drive.DRIVERS.update({name: keeping(fn) for name, fn in real_drivers.items()})
    spans.clear()
    spans.enable(True)
    try:
        out = run(*args, **kwargs)
    finally:
        spans.enable(False)
        harness.capture = real_capture
        drive.DRIVERS.update(real_drivers)
    kept["spans"] = spans.spans()
    return out, kept


def readings(kept: dict, seconds: float, log=sys.stderr) -> dict:
    """The span readings of a run `traced` kept (module docstring)."""
    from perfbench.harness import program

    sp = kept["spans"]
    lo = kept["clocks"].to_ns(kept["driven"]["start"])
    hi = lo + round(seconds * 1e9)
    out = {"spans": len(sp), "capture_s": program.capture_s(sp, lo),
           "queue_wait_ms": program.queue_wait_ms(sp, lo, hi),
           "padded_share": program.padded_share(sp, lo, hi)}
    sl = kept.get("slice")
    if sl is not None:
        split = program.steps_split(sl, sp)
        out["replay_gap_us"] = program.replay_gap_us(split)
        out["idle_outside_steps_share"] = program.idle_outside_steps_share(split)
        if split is not None:
            out["device_idle_share"] = 100.0 * (split.idle_in_steps_ns + split.idle_outside_ns) \
                / split.window_ns
            out["steps_replayed"] = split.steps
        line = program.idle_line(sl, sp)
        if line:
            print(line, file=log)
    return out


def main(argv=None) -> int:
    from perfbench import run
    from perfbench.harness import runner

    args = run.parse(argv)
    rc, kept = traced(runner.main, args, T_PROCESS)
    if rc == 0:
        print(json.dumps({"program": readings(kept, args.seconds)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
