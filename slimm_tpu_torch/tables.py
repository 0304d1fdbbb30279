"""The per-contig and taxonomy tables the profile core reads on the device.

The profiler has no model weights; besides the records, the device holds
these tables.  They are the arrays that slimm_tpu's profile_arrays hands to
its jit (pipeline.py:1120-1125) plus the dense lineage and superkingdom
codes of `database.tensorize`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .utils.timer import work_counts

# index of the lowest set bit of an 8-bit mask, 7 for the empty mask: the
# first lineage level on which all of a read's targets agree (pass B's LCA)
_FIRST_LEVEL = np.array([7] + [(z & -z).bit_length() - 1 for z in range(1, 256)],
                        np.int32)


def _as_int32(a, name) -> np.ndarray:
    """`a` as int32; a value past int32 raises OverflowError (numpy's cast
    would wrap it silently)."""
    a = np.asarray(a)
    info = np.iinfo(np.int32)
    bad = (a < info.min) | (a > info.max)
    if bad.any():
        raise OverflowError(f"{name}: bin {int(a[bad][0])} passes int32, "
                            "the index type of the bin tables and kernels")
    return a.astype(np.int32)


@dataclass
class DeviceTables:
    lengths: torch.Tensor      # int64[C]: contig lengths (uint32 values)
    bin_offset: torch.Tensor   # int32[C]: first global bin of each contig
    bin_ends: torch.Tensor     # int32[C]: one past its last global bin
    lineage: torch.Tensor      # int32[C, 8]: dense taxon id per level
    sk_code: torch.Tensor      # int32[C]: superkingdom code (pair channel)
    nbins: np.ndarray          # float32[C] on the host: bins per contig
    # avg read length // 2 (center binning) and the bin width: ints, or for
    # a group of files int64[C] tensors, each contig its own file's
    half: int | torch.Tensor
    bin_width: int | torch.Tensor
    q: np.float32              # coverage quantile (-cc)
    n_bins: int                # total bins over all contigs
    n_dense: int               # dense taxon ids
    n_codes: int               # pair codes per contig: 8 levels + S
    first_level: torch.Tensor  # int32[256]: _FIRST_LEVEL on the device
    n_files: int = 1           # files profiled as one (group_tables)

    @property
    def n_contigs(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def device(self) -> torch.device:
        return self.bin_offset.device

    @classmethod
    def from_numpy(cls, lengths, bin_offset, bin_ends, lineage, sk_code, *,
                   n_dense: int, n_codes: int, half, bin_width, q,
                   device, n_files: int = 1) -> "DeviceTables":
        bin_offset = _as_int32(bin_offset, "bin_offset")
        bin_ends = _as_int32(bin_ends, "bin_ends")

        def dev(a, dtype):
            a = np.ascontiguousarray(a, dtype)
            work_counts["h2d_bytes"] += a.nbytes
            return torch.from_numpy(a).to(device)

        def per_contig(x):
            return dev(x, np.int64) if np.ndim(x) else int(x)

        return cls(lengths=dev(np.asarray(lengths).astype(np.uint32), np.int64),
                   bin_offset=dev(bin_offset, np.int32),
                   bin_ends=dev(bin_ends, np.int32),
                   lineage=dev(lineage, np.int32),
                   sk_code=dev(sk_code, np.int32),
                   nbins=(bin_ends - bin_offset).astype(np.float32),
                   half=per_contig(half), bin_width=per_contig(bin_width),
                   q=np.float32(q),
                   n_bins=int(bin_ends[-1]) if len(bin_ends) else 0,
                   n_dense=int(n_dense), n_codes=int(n_codes),
                   first_level=dev(_FIRST_LEVEL, np.int32), n_files=n_files)


def device_tables(st, dense, options, device) -> DeviceTables:
    """Tables for one profile: `st` a ProfileState after init_contigs,
    `dense` its DenseTaxonomy, `options` the ProfileOptions with bin_width
    resolved."""
    return DeviceTables.from_numpy(
        st.lengths, st.bin_offset, st.bin_offset + st.nbins, dense.lineage,
        dense.sk_code, n_dense=dense.n_dense, n_codes=dense.n_pair_codes,
        half=st.avg_read_length // 2, bin_width=options.bin_width,
        q=options.cov_cut_off, device=device)


def group_tables(states, options, dense, device) -> DeviceTables:
    """Tables of K files with one header, profiled as one (the batched
    directory path): file k's contigs are k*C .. k*C + C - 1, its bins
    follow the earlier files' bins, its dense taxon ids are offset by
    k*n_dense, and each contig carries its own file's half read length and
    bin width.  states[k] / options[k]: file k's ProfileState after
    init_contigs and its ProfileOptions; one file gives device_tables."""
    if len(states) == 1:
        return device_tables(states[0], dense, options[0], device)
    K, C = len(states), len(states[0].lengths)
    base = np.cumsum([0] + [int(st.nbins.sum()) for st in states[:-1]])
    return DeviceTables.from_numpy(
        np.tile(states[0].lengths, K),
        np.concatenate([st.bin_offset + b for st, b in zip(states, base)]),
        np.concatenate([st.bin_offset + st.nbins + b
                        for st, b in zip(states, base)]),
        np.concatenate([dense.lineage + k * dense.n_dense for k in range(K)]),
        np.tile(dense.sk_code, K), n_dense=K * dense.n_dense,
        n_codes=dense.n_pair_codes,
        half=np.repeat([st.avg_read_length // 2 for st in states], C),
        bin_width=np.repeat([o.bin_width for o in options], C),
        q=options[0].cov_cut_off, device=device, n_files=K)
