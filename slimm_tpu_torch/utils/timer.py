# Copied from slimm_tpu/utils/timer.py (the port imports nothing of slimm_tpu).
"""Phase stopwatch with the reference's stderr log shape
(src/timer.hpp:13-48, used at slimm.hpp:446-494)."""

from __future__ import annotations

import sys
import time


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
