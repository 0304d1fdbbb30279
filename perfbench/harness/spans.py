"""The program's own spans and counters, as the per-layer metrics read them.

slimm_tpu_torch opens a `slimm.<stage>` span at each stage boundary while a
torch.profiler runs (its utils/timer.py `span`): `slimm.profile` around
each outermost entry-point call, its stages as children on the caller's
thread.  Those land among the traced window's host events, and are found
here by exact name.  The program's `engine.pipeline.work_counts` counts
calls, host-to-device bytes, minor page faults and CPU seconds; the run
resets it with `pipeline.path_counts` at the window's start, and nothing
calls the program between the window's end and the metrics.  A program
without them (an older commit) gives None to every reader.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

PREFIX = "slimm."


def work_counts() -> dict | None:
    """The program's work counters over the window, or None."""
    from slimm_tpu_torch.engine import pipeline

    counts = getattr(pipeline, "work_counts", None)
    return dict(counts) if counts else None


def calls() -> int | None:
    """The outermost calls of the window, or None (none, or no counter)."""
    counts = work_counts()
    return (counts or {}).get("calls") or None


def spans(run, stage: str) -> list:
    """The traced window's host events named `slimm.<stage>`."""
    t = run.trace
    if t is None:
        return []
    name, (lo, hi) = PREFIX + stage, t.window
    return [e for e in t.host if e.name == name and lo <= e.start
            and e.end <= hi]


def ms_per_call(run, *stages) -> float | None:
    """The summed time of the window's spans of `stages` over its calls,
    in ms; None where the window holds none of them."""
    found = [e for stage in stages for e in spans(run, stage)]
    n = calls()
    if not found or not n:
        return None
    return sum(e.end - e.start for e in found) / n / 1e6


def untraced_ms_per_call(run) -> float | None:
    """The time of each `slimm.profile` span that none of its direct child
    spans covers, summed over the window and taken over its calls, in ms."""
    profiles = spans(run, "profile")
    n = calls()
    if not profiles or not n:
        return None
    lo, hi = run.trace.window
    inner = sorted(((e.start, -e.end) for e in run.trace.host
                    if e.name.startswith(PREFIX)
                    and e.name != PREFIX + "profile"
                    and lo <= e.start and e.end <= hi))
    starts = [s for s, _ in inner]
    free = 0
    for p in profiles:
        covered, end = 0, p.start
        for s, neg_e in inner[bisect_left(starts, p.start):
                              bisect_right(starts, p.end)]:
            e = -neg_e
            if e <= p.end and s >= end:     # a direct child
                covered += e - s
                end = e
        free += (p.end - p.start) - covered
    return free / n / 1e6
