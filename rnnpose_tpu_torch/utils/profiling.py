"""Tracing and profiling utilities: port of `rnnpose_tpu/utils/profiling.py`.

  * `trace(dir)`: context manager that runs `torch.profiler` over everything
    inside (host and, where a card is visible, CUDA activity) and writes a
    Chrome trace, `<dir>/trace.json` (chrome://tracing or Perfetto);
  * `annotate(name)`: a named range that shows up in the trace
    (`torch.profiler.record_function`);
  * `device_busy(prof)`: the device's busy time in a profiled window;
  * `Timer` / `timings` / `timed`: host-side accumulating timers matching
    the reference's `simple_timer`/`timming` singleton (`utils/timer.py:5-22`).
    They read the host clock: around work on the card, synchronise inside
    the window, or they measure the enqueue.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Set, Tuple

import torch

__all__ = ["trace", "annotate", "annotation_names", "device_busy", "Timer", "timings",
           "timed"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; yields the profiler (its `key_averages()` holds the
    per-op host and device times) and writes `<log_dir>/trace.json`. The
    card is synchronised before the profiler stops: a replayed CUDA graph
    returns before its work runs, and work that runs after the stop is not
    in the trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range visible in the trace."""
    return torch.profiler.record_function(name)


def annotation_names(prof: torch.profiler.profile) -> Set[str]:
    """The names of the user-annotation ranges (`annotate`,
    `record_function`) among a profiled window's events."""
    return {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}


def device_busy(prof: torch.profiler.profile) -> Tuple[float, int]:
    """(ms, operations): the summed own times of the device operations
    (kernels, memcpys, memsets) of a profiled window, and their number.
    The spans that user annotations put on the device are left out: a span
    covers the gaps between its kernels, as the table's "Self CUDA time
    total" leaves it out."""
    from torch.autograd import DeviceType

    ranges = annotation_names(prof)
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name not in ranges]
    return sum(e.self_device_time_total for e in device) / 1e3, len(device)


class Timer:
    """Accumulating wall-clock timer."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


timings: Dict[str, Timer] = defaultdict(Timer)


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    """Accumulate into the global `timings` dict (the reference's `timming`
    singleton pattern)."""
    with timings[name]:
        yield
