"""The traced window: torch.profiler around the measured loop, reduced to
the device's busy intervals, its kernels by name and the idle gaps with
what the host was doing in each.

The harness marks its own spans with `record_function`: `pb.window` around
the loop, `pb.call` around each call, `pb.tsv` around a report write, and a
zero-length `pb.mark.<point>` at each point the program reports through
`pipeline.host_marks` (`MarkList`).  Those land in the trace's clock beside
the CPU ops and the device's kernels and copies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class MarkList(list):
    """A `pipeline.host_marks` list that also drops a zero-length
    `pb.mark.<point>` span into the trace at each mark."""

    def append(self, item):
        with record_function("pb.mark." + item[0]):
            super().append(item)


@dataclass
class Event:
    name: str
    start: int              # ns, the trace's clock
    end: int


@dataclass
class TraceSummary:
    window: tuple                               # (start, end) ns
    device: list = field(default_factory=list)  # [Event] kernels, copies
    host: list = field(default_factory=list)    # [Event] CPU ops, API calls
    spans: list = field(default_factory=list)   # [Event] pb.* spans, marks

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device's events inside the window, merged."""
        lo, hi = self.window
        iv = sorted((max(e.start, lo), min(e.end, hi)) for e in self.device
                    if e.end > lo and e.start < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_time_s(self, match) -> float:
        """Seconds of the device events whose name `match(name)` accepts."""
        return sum(e.end - e.start for e in self.device if match(e.name)) / 1e9

    def top_device_ops(self, n=10) -> list:
        by = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0) + (e.end - e.start)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[short_name(k), v / 1e9] for k, v in top]

    def idle_gaps(self, n=10) -> list:
        """The n longest stretches in which the device ran nothing, each
        named by the harness stage and the innermost host op under its
        midpoint."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._doing((s + e) // 2), (e - s) / 1e9] for s, e in gaps]

    def _doing(self, t: int) -> str:
        stage = "between calls"
        for sp in self.spans:
            if sp.start <= t < sp.end and sp.name == "pb.call":
                marks = [m.start for m in self.spans
                         if m.name.startswith("pb.mark.")
                         and sp.start <= m.start <= sp.end]
                stage = ("after cutoffs" if marks and t >= min(marks)
                         else "until cutoffs")
            elif sp.start <= t < sp.end and sp.name == "pb.tsv":
                stage = "report write"
        inner = None
        for e in self.host:
            if e.start <= t < e.end and (inner is None
                                         or e.start >= inner.start):
                inner = e
        return f"{stage}: {short_name(inner.name) if inner else 'no torch op'}"


def short_name(name: str, limit: int = 120) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name if len(name) <= limit else name[:limit] + "..."


class Tracer:
    """torch.profiler over the window, CUDA activity on a card."""

    def __init__(self, cuda: bool):
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.summary = None
        self.reduce_s = 0.0

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            t0 = time.perf_counter()
            self.summary = _summarize(self.prof)
            self.reduce_s = time.perf_counter() - t0
        return False


def _summarize(prof) -> TraceSummary:
    device, host, spans = [], [], []
    window = None
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        ev = Event(name, start, start + e.duration_ns())
        if e.device_type() != cpu:
            # the device-side copy of a harness span is no device work
            if not name.startswith("pb."):
                device.append(ev)
        elif name == "pb.window":
            window = (ev.start, ev.end)
        elif name.startswith("pb."):
            spans.append(ev)
        else:
            host.append(ev)
    if window is None:
        raise RuntimeError("the trace holds no pb.window span")
    return TraceSummary(window, device, host, spans)


def window_span():
    return record_function("pb.window")


def call_span():
    return record_function("pb.call")


def tsv_span():
    return record_function("pb.tsv")
