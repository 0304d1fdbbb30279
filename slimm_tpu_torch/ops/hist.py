"""Histograms of the profile core: plain PyTorch versions and CUDA wrappers.

Counterpart of slimm_tpu/ops/hist.py.  `hist2` computes what `mxu_hist2`
computes (two counts over one bin index: pass A's cov and uniq_cov), `hist1`
what `mxu_hist` computes (pass B's fused counts and the pair presence).

The wrappers decide by the tensor's device: a CPU tensor goes to the plain
version, a CUDA tensor to the hand-written kernel of csrc/hist.cu (built at
first use, ops/_build.py) or to an error.  A record adds one to its bin when
its weight is true and its index lies in [0, n_bins); every other record is
dropped, as in the JAX scatter's `mode="drop"`.

`hist1_launches` and `hist2_launches` count kernel launches, so that a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

hist1_launches = 0
hist2_launches = 0


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


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def hist1(idx: torch.Tensor, w: torch.Tensor, n_bins: int) -> torch.Tensor:
    """One int32[n_bins] histogram of idx weighted by the bool w."""
    global hist1_launches
    _check(idx, (w,), n_bins)
    if idx.device.type == "cpu":
        return hist1_plain(idx, w, n_bins)
    from . import _build
    out = torch.zeros(n_bins, dtype=torch.int32, device=idx.device)
    if idx.numel() == 0 or n_bins == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib.slimm_hist1(idx.data_ptr(), w.view(torch.uint8).data_ptr(),
                                  idx.numel(), out.data_ptr(), n_bins, stream),
                  "slimm_hist1")
    hist1_launches += 1
    return out


def hist2(idx: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
          n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two int32[n_bins] histograms of idx weighted by the bools w1 and w2,
    from one pass over idx."""
    global hist2_launches
    _check(idx, (w1, w2), n_bins)
    if idx.device.type == "cpu":
        return hist2_plain(idx, w1, w2, n_bins)
    from . import _build
    out1 = torch.zeros(n_bins, dtype=torch.int32, device=idx.device)
    out2 = torch.zeros(n_bins, dtype=torch.int32, device=idx.device)
    if idx.numel() == 0 or n_bins == 0:
        return out1, out2
    lib = _build.load()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib.slimm_hist2(idx.data_ptr(),
                                  w1.view(torch.uint8).data_ptr(),
                                  w2.view(torch.uint8).data_ptr(), idx.numel(),
                                  out1.data_ptr(), out2.data_ptr(), n_bins,
                                  stream),
                  "slimm_hist2")
    hist2_launches += 1
    return out1, out2


def reset_launch_counts():
    global hist1_launches, hist2_launches
    hist1_launches = hist2_launches = 0
