"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from the
root of the repo.  They run on the CPU; those marked `card` need a CUDA
device and skip without one (decided in the `card` fixture, never at
import): `python -m pytest perfbench/tests -q -m card -s` on the card."""

import dataclasses
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


# A cell whose database passes this many bins runs on the CPU as a cut-down
# copy (refseq50k's 1.33 billion bins: the reference alone would need about
# 45 GB); refseq1k's 26.7 million run whole.
CPU_BINS = 32_000_000


def database_bins(cfg: dict) -> int:
    """The bins of the configuration's database: each genome's length over
    the read length, plus one (the lengths harness/generate.py spaces)."""
    lo, hi = cfg["genome_length"]
    n = int(cfg["n_contigs"])
    lengths = np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
    return int((lengths.astype(np.int64) // int(cfg["read_length"]) + 1).sum())


def cut_for_the_cpu(cell):
    """`cell` itself where its database holds at most CPU_BINS bins, else a
    copy with the same genomes, taxonomy and traffic and the genome lengths
    scaled down to about CPU_BINS bins."""
    bins = database_bins(cell.config)
    if bins <= CPU_BINS:
        return cell
    n = int(cell.config["n_contigs"])
    scale = (CPU_BINS - n) / (bins - n)
    lo, hi = cell.config["genome_length"]
    return dataclasses.replace(cell, config=dict(
        cell.config, genome_length=[int(lo * scale), int(hi * scale)]))


@pytest.fixture
def cpu_sized():
    """cut_for_the_cpu, for the tests that run every cell on the CPU."""
    return cut_for_the_cpu
