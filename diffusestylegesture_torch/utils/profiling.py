"""Scope profiler and trace capture (port of `diffusestylegesture_tpu/utils/profiling.py`).

The reference's wall-time scope profiler (`main/diffusion/logger.py:294-322`,
`profile_kv` / `@profile`) with the same accounting and `wait_<scope>` means;
each scope is also a `torch.profiler.record_function` range, which shows on
the timeline of a `trace_capture`.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

_PROFILE_SUMS: Dict[str, float] = defaultdict(float)
_PROFILE_COUNTS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def profile_kv(scopename: str, device_annotation: bool = True):
    """Wall-time scope accounting (+ a profiler range under capture)."""
    t0 = time.perf_counter()
    ctx = (torch.profiler.record_function(scopename) if device_annotation
           else contextlib.nullcontext())
    try:
        with ctx:
            yield
    finally:
        _PROFILE_SUMS[scopename] += time.perf_counter() - t0
        _PROFILE_COUNTS[scopename] += 1


def profile(fn=None, *, name: Optional[str] = None):
    """Decorator version (ref `logger.py:314-322`)."""

    def deco(f):
        scope = name or f.__name__

        @functools.wraps(f)
        def wrapped(*a, **k):
            with profile_kv(scope):
                return f(*a, **k)

        return wrapped

    return deco(fn) if fn is not None else deco


def profile_means() -> Dict[str, float]:
    """Mean seconds per scope (ref's `wait_*` logkv_mean dump)."""
    return {f"wait_{k}": _PROFILE_SUMS[k] / max(1, _PROFILE_COUNTS[k]) for k in _PROFILE_SUMS}


def reset_profile() -> None:
    _PROFILE_SUMS.clear()
    _PROFILE_COUNTS.clear()


@contextlib.contextmanager
def trace_capture(log_dir: str):
    """A `torch.profiler` trace of the CPU and, where there is one, the card,
    written into `log_dir` as a Chrome trace (TensorBoard's profiler plugin
    and chrome://tracing read it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
