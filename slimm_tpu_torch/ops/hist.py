"""Histograms of the profile core: plain PyTorch versions and CUDA wrappers.

Counterpart of slimm_tpu/ops/hist.py.  `hist2` computes what `mxu_hist2`
computes (two counts over one bin index: pass A's cov and uniq_cov), `hist1`
what `mxu_hist` computes (pass B's fused counts and the pair presence).

The wrappers decide by the tensor's device: a CPU tensor goes to the plain
version, a CUDA tensor to the hand-written kernel of csrc/hist.cu (built at
first use, ops/_build.py) or to an error.  A record adds one to its bin when
its weight is true and its index lies in [0, n_bins); every other record is
dropped, as in the JAX scatter's `mode="drop"`.

`launch_plan` picks each launch's variant and geometry from the record
count, the domain and the card's SM count and shared memory (read once per
device); csrc/hist.cu says what bounds each kernel and what the variants do
about it.  `hist1_launches` and `hist2_launches` count kernel launches, so
that a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

hist1_launches = 0
hist2_launches = 0

# variant codes of csrc/hist.cu
GLOBAL, SHARED = 0, 1
VARIANT_NAMES = {GLOBAL: "global", SHARED: "shared"}

THREADS = 1024              # csrc/hist.cu kThreads
MAX_THREADS_PER_SM = 2048
SMEM_RESERVED = 1024        # bytes of shared memory the card keeps per block
QUAD = 4                    # records of one 16-byte index load
# below this many records per bin a block-private histogram costs more to
# zero and flush than it saves (the crossover measured on an H100 at 2^18
# records: 37,888 bins, 6.9 records per bin, shared still ahead; 57,000
# bins, 4.6 per bin, global ahead)
SHARED_MIN_RECORDS_PER_BIN = 6


class Plan(NamedTuple):
    variant: int
    blocks: int
    threads: int
    smem: int                # dynamic shared-memory bytes per block


def launch_plan(n: int, n_bins: int, hists: int, sms: int,
                smem_limit: int) -> Plan:
    """The launch of `hists` (1 or 2) histograms of n records over n_bins
    bins on a card of `sms` SMs whose blocks may use smem_limit bytes of
    shared memory.  A bin takes 4 bytes (hist1) or 8 (hist2: two int32
    counters in shared memory, one packed word in device memory).

    A domain that fits takes block-private histograms in shared memory
    when there are enough records per bin to pay for zeroing and flushing
    them, else global atomics.  Blocks: as many as are resident on the card
    at once, but no more than give each thread one quad of records."""
    word = 4 * hists
    blocks = -(-n // (QUAD * THREADS))
    if (n_bins * word <= smem_limit
            and n >= SHARED_MIN_RECORDS_PER_BIN * n_bins):
        smem = n_bins * word
        per_sm = min(MAX_THREADS_PER_SM // THREADS,
                     (smem_limit + SMEM_RESERVED) // (smem + SMEM_RESERVED))
        return Plan(SHARED, max(1, min(blocks, sms * per_sm)), THREADS, smem)
    blocks = min(blocks, sms * (MAX_THREADS_PER_SM // THREADS))
    return Plan(GLOBAL, max(1, blocks), THREADS, 0)


def hist1_plain(idx: torch.Tensor, w: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32[n_bins]: count of records r with w[r] and idx[r] == bin."""
    keep = w & (idx >= 0) & (idx < n_bins)
    return torch.bincount(idx[keep], minlength=n_bins)[:n_bins].to(torch.int32)


def hist2_plain(idx, w1, w2, n_bins):
    return hist1_plain(idx, w1, n_bins), hist1_plain(idx, w2, n_bins)


def _check(idx, weights, n_bins):
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-D int32 tensor")
    for w in weights:
        if (w.dtype != torch.bool or w.shape != idx.shape
                or not w.is_contiguous() or w.device != idx.device):
            raise ValueError("weights must be contiguous bool tensors of "
                             "idx's shape, on idx's device")
    if not 0 <= n_bins < 2**31:
        raise ValueError(f"n_bins {n_bins} outside the int32 range")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {idx.device}")
    if idx.device.type == "cuda" and idx.numel() >= 2**31:
        # a count must stay below 2^31: the packed hist2 word's low half
        # would carry into the high half
        raise ValueError(f"{idx.numel()} records: the kernels take fewer "
                         "than 2^31")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared-memory bytes a block may use) of CUDA device `index`,
    read once; the shared-memory kernels are allowed that much."""
    from . import _build
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        _raise_on(_build.load().slimm_hist_init(ctypes.byref(sms),
                                                ctypes.byref(smem)),
                  "slimm_hist_init")
    return sms.value, smem.value


def plan_for(idx: torch.Tensor, n_bins: int, hists: int) -> Plan:
    """launch_plan for the records of `idx` on its CUDA device."""
    return launch_plan(idx.numel(), n_bins, hists,
                       *device_limits(idx.device.index or 0))


def hist1_cuda(idx, w, n_bins, plan: Plan) -> torch.Tensor:
    """slimm_hist1 launched with `plan`; idx and w checked by the caller."""
    global hist1_launches
    from . import _build
    out = torch.zeros(n_bins, dtype=torch.int32, device=idx.device)
    if idx.numel() == 0 or n_bins == 0:
        return out
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(_build.load().slimm_hist1(
            idx.data_ptr(), w.view(torch.uint8).data_ptr(), idx.numel(),
            out.data_ptr(), n_bins, *plan, stream), "slimm_hist1")
    hist1_launches += 1
    return out


def hist2_cuda(idx, w1, w2, n_bins, plan: Plan):
    """slimm_hist2 launched with `plan`; inputs checked by the caller."""
    global hist2_launches
    from . import _build
    out1 = torch.empty(n_bins, dtype=torch.int32, device=idx.device)
    out2 = torch.empty(n_bins, dtype=torch.int32, device=idx.device)
    if idx.numel() == 0 or n_bins == 0:
        return out1.zero_(), out2.zero_()
    acc = torch.empty(n_bins, dtype=torch.int64, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(_build.load().slimm_hist2(
            idx.data_ptr(), w1.view(torch.uint8).data_ptr(),
            w2.view(torch.uint8).data_ptr(), idx.numel(), acc.data_ptr(),
            out1.data_ptr(), out2.data_ptr(), n_bins, *plan, stream),
            "slimm_hist2")
    hist2_launches += 1
    return out1, out2


def hist1(idx: torch.Tensor, w: torch.Tensor, n_bins: int) -> torch.Tensor:
    """One int32[n_bins] histogram of idx weighted by the bool w."""
    _check(idx, (w,), n_bins)
    if idx.device.type == "cpu":
        return hist1_plain(idx, w, n_bins)
    return hist1_cuda(idx, w, n_bins, plan_for(idx, n_bins, 1))


def hist2(idx: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
          n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two int32[n_bins] histograms of idx weighted by the bools w1 and w2,
    from one pass over idx."""
    _check(idx, (w1, w2), n_bins)
    if idx.device.type == "cpu":
        return hist2_plain(idx, w1, w2, n_bins)
    return hist2_cuda(idx, w1, w2, n_bins, plan_for(idx, n_bins, 2))


def reset_launch_counts():
    global hist1_launches, hist2_launches
    hist1_launches = hist2_launches = 0
