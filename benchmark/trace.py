"""Reading the device trace of a traced stretch of requests.

`traced(fn_list)` runs the calls under torch.profiler (CPU and CUDA
activity), each call inside a `request` range, and returns a `Trace`: every
device kernel as (name, start_us, end_us), every host event (profiler
ranges, torch ops and CUDA runtime calls) the same way, and the traced
window, from the first call's start to the last call's end.  The kernel
names follow chip_smoke.py's `device_breakdown`, frozen here: a kernel of
the program's csrc/ keeps its entry name (`k3_kernel`, `k4_dense_kernel`,
...), any other is `torch:` and a short form of its name."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_CSRC = re.compile(r"k\d[ab]?_(?:\w+_)?kernel")
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def kernel_name(raw: str) -> str:
    m = _CSRC.search(raw)
    if m:
        return m.group(0)
    return "torch:" + raw.split("<")[0].split("(")[0][-40:]


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_us, end_us)
    copies: list = field(default_factory=list)    # memcpy / memset on the device
    host: list = field(default_factory=list)      # (name, start_us, end_us)
    window: tuple = (0.0, 0.0)                    # traced window, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of kernel and copy intervals inside the window, merged
        and sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels + self.copies
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """(start_us, end_us) of every stretch of the window with nothing on
        the device."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def host_at(self, t: float) -> str:
        """What the host was in at time t: the innermost profiler range of
        the benchmark or the program, and the innermost op inside it."""
        spans = [(e - s, name) for name, s, e in self.host if s <= t < e]
        if not spans:
            return "host: no traced op"
        spans.sort()
        ranges = [name for _, name in spans if not name.startswith(("aten::", "cuda", "cu"))]
        inner = spans[0][1]
        outer = ranges[0] if ranges else "request"
        return outer if inner == outer else f"{outer} > {inner}"


def traced(calls) -> Trace:
    """Run each call of `calls` under the profiler and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            with record_function("request"):
                call()
                torch.cuda.synchronize()
    tr = Trace()
    requests = []
    events = prof.events()
    ranges = {e.name for e in events
              if e.device_type != torch.autograd.DeviceType.CUDA and not e.name.startswith(("aten::", "cu"))}
    for evt in events:
        s, e = evt.time_range.start, evt.time_range.end
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False) or evt.name in ranges:
                continue  # a profiler range drawn on the device's timeline, not work
            if evt.name.startswith(_NOT_KERNELS):
                tr.copies.append((evt.name, s, e))
            else:
                tr.kernels.append((kernel_name(evt.name), s, e))
        else:
            tr.host.append((evt.name, s, e))
            if evt.name == "request":
                requests.append((s, e))
    if requests:
        tr.window = (min(s for s, _ in requests), max(e for _, e in requests))
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was in, in seconds."""
    by_name: dict = {}
    for name, s, e in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[k, v] for k, v in ops],
        "idle_gaps": [[tr.host_at((s + e) / 2), (e - s) / 1e6] for s, e in gaps],
    }
