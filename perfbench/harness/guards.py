"""What a run refuses: a missing card, and the JAX package or its tools in
the process."""

from __future__ import annotations

import subprocess
import sys

# top-level module names that no run may load: JAX, and the JAX package
# with its scripts (bench.py, bench_scaling.py, chip_smoke.py)
FORBIDDEN = ("jax", "jaxlib", "flax", "slimm_tpu", "bench", "bench_scaling",
             "chip_smoke")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among `modules` (default sys.modules),
    each module's name cut at its first dot and compared whole: the port,
    slimm_tpu_torch, begins with the letters of the JAX package's name."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def cards_missing(chips: int) -> str | None:
    """Why this machine cannot run a cell of `chips` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are present")
    return None


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None
