"""Device timing on the card (counterpart of slimm_tpu/utils/devbench.py).

CUDA events recorded on the current stream around each call; the time
between them includes any host stall inside the call, so a function that
synchronises midway is timed end to end.
"""

from __future__ import annotations

import numpy as np
import torch


def cuda_time(fn, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median seconds of fn(*args) on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return float(np.median(times))


def batch_time(fn, *args, reps: int = 20, rounds: int = 5,
               sleep_cycles: int = 10_000_000) -> float:
    """Median seconds per call of fn(*args), from CUDA events around `reps`
    calls queued back to back.  A sleep kernel runs first in each round so
    that the host queues the calls ahead of the card: a call shorter than
    its own host enqueue is then timed by the card's work, not the host's."""
    if not torch.cuda.is_available():
        raise RuntimeError("batch_time needs a CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / reps)
    return float(np.median(times))
