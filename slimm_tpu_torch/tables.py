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

# index of the lowest set bit of an 8-bit mask, 7 for the empty mask: the
# first lineage level on which all of a read's targets agree (pass B's LCA)
_FIRST_LEVEL = np.array([7] + [(z & -z).bit_length() - 1 for z in range(1, 256)],
                        np.int32)


@dataclass
class DeviceTables:
    lengths: torch.Tensor      # int64[C]: contig lengths (uint32 values)
    bin_offset: torch.Tensor   # int32[C]: first global bin of each contig
    bin_ends: torch.Tensor     # int32[C]: one past its last global bin
    lineage: torch.Tensor      # int32[C, 8]: dense taxon id per level
    sk_code: torch.Tensor      # int32[C]: superkingdom code (pair channel)
    nbins: np.ndarray          # float32[C] on the host: bins per contig
    half: int                  # avg read length // 2 (center binning)
    bin_width: int
    q: np.float32              # coverage quantile (-cc)
    n_bins: int                # total bins over all contigs
    n_dense: int               # dense taxon ids
    n_codes: int               # pair codes per contig: 8 levels + S
    first_level: torch.Tensor  # int32[256]: _FIRST_LEVEL on the device

    @property
    def n_contigs(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def device(self) -> torch.device:
        return self.bin_offset.device

    @classmethod
    def from_numpy(cls, lengths, bin_offset, bin_ends, lineage, sk_code, *,
                   n_dense: int, n_codes: int, half: int, bin_width: int, q,
                   device) -> "DeviceTables":
        bin_offset = np.asarray(bin_offset, np.int32)
        bin_ends = np.asarray(bin_ends, np.int32)

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return cls(lengths=dev(np.asarray(lengths).astype(np.uint32), np.int64),
                   bin_offset=dev(bin_offset, np.int32),
                   bin_ends=dev(bin_ends, np.int32),
                   lineage=dev(lineage, np.int32),
                   sk_code=dev(sk_code, np.int32),
                   nbins=(bin_ends - bin_offset).astype(np.float32),
                   half=int(half), bin_width=int(bin_width), q=np.float32(q),
                   n_bins=int(bin_ends[-1]) if len(bin_ends) else 0,
                   n_dense=int(n_dense), n_codes=int(n_codes),
                   first_level=dev(_FIRST_LEVEL, np.int32))


def device_tables(st, dense, options, device) -> DeviceTables:
    """Tables for one profile: `st` a ProfileState after init_contigs,
    `dense` its DenseTaxonomy, `options` the ProfileOptions with bin_width
    resolved."""
    return DeviceTables.from_numpy(
        st.lengths, st.bin_offset, st.bin_offset + st.nbins, dense.lineage,
        dense.sk_code, n_dense=dense.n_dense, n_codes=dense.n_pair_codes,
        half=st.avg_read_length // 2, bin_width=options.bin_width,
        q=options.cov_cut_off, device=device)
