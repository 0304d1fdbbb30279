# Timer and PhaseTimer copied from slimm_tpu/utils/timer.py (the port
# imports nothing of slimm_tpu).
"""Phase stopwatch with the reference's stderr log shape
(src/timer.hpp:13-48, used at slimm.hpp:446-494), and the program's spans
and work counters for a trace."""

from __future__ import annotations

import sys
import time

from torch._C._profiler import _RecordFunctionFast

# What the profiles did, always counted, never reset here (engine.pipeline
# holds the same dict as `work_counts`; its reset_path_counts zeroes it):
# outermost entry-point calls, bytes of every host-to-device copy the
# program issues (counted where the copy is issued, on any device), the
# process's minor page faults and CPU seconds (user + system, every
# thread, the native decoder's included) across the outermost calls, and
# the whole-file plans of profile_arrays taken from the uploaded records
# or the decoder's max_targets (`device_plans`) and those taken on the host
# (`host_plans`, engine/pipeline.py plan_uploaded), and the ancestor
# propagations (state.py propagate_counts) that ran in C++
# (`native_propagations`) or in Python (`python_propagations`), with the LCA
# taxa they started from (`lca_taxa`, summed over them).
work_counts = {"calls": 0, "h2d_bytes": 0, "minor_faults": 0, "cpu_s": 0.0,
               "device_plans": 0, "host_plans": 0, "native_propagations": 0,
               "python_propagations": 0, "lca_taxa": 0}


def span(stage: str):
    """A context manager: a `slimm.<stage>` range on the host's timeline of
    a running torch.profiler (an operator's --trace-dir, a benchmark's
    window), beside the device's kernels and copies; with no profiler
    running it records nothing (under a microsecond).

    The range has function scope.  `torch.profiler.record_function` opens
    a user-scope range, which also puts a copy of itself on the device's
    timeline around the kernels it encloses; that copy would count as
    device work in a trace's busy time."""
    return _RecordFunctionFast("slimm." + stage)


class Timer:
    """lap()/elapsed() stopwatch in seconds (timer.hpp:13-48)."""

    def __init__(self):
        self._start = self._lap_start = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        delta = now - self._lap_start
        self._lap_start = now
        return delta

    def elapsed(self) -> float:
        return time.perf_counter() - self._start


class PhaseTimer:
    """Prints `<message> [<secs> secs]` around phases, like the reference."""

    def __init__(self, enabled: bool = True, stream=None):
        self.enabled = enabled
        self.stream = stream if stream is not None else sys.stderr
        self.timer = Timer()

    def start(self, message: str):
        if self.enabled:
            print(message, end="", file=self.stream, flush=True)
        self.timer.lap()

    def lap(self):
        delta = self.timer.lap()
        if self.enabled:
            print(f"[{delta:.6g} secs]", file=self.stream)
        return delta

    def elapsed(self) -> float:
        return self.timer.elapsed()
