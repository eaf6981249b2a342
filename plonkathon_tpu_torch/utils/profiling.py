"""Lightweight tracing/profiling helpers.

* `Timings` — a named-section wall-clock registry used by the prover.  On a
  CUDA device each section ends with `torch.cuda.synchronize()`, so a
  section's time includes the device work it enqueued, not just the
  enqueue.
* `annotate(label)` — a `torch.profiler.record_function` range, visible in
  profiler traces.
* `capture(path)` — a `torch.profiler` trace of CPU and CUDA activity
  written as a Chrome trace to `path`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timings:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.sections = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.sections[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"seconds": round(secs, 6), "calls": self.counts[name]}
            for name, secs in sorted(self.sections.items())
        }


@contextlib.contextmanager
def annotate(label: str):
    """Trace range that shows up in torch.profiler traces."""
    with torch.profiler.record_function(label):
        yield


@contextlib.contextmanager
def capture(path: str):
    """Capture a CPU + CUDA trace into the Chrome-trace file `path`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
