"""Whole-file sharded profiles: counterpart of slimm_tpu/parallel/runner.py.

Reads are routed to data shards on the device that holds a piece (shard =
hash(read id) mod D, mesh.route_shard), so each data shard holds every
record of its reads in the grouped order.  Under model sharding the bin
axis is cut into M slices that tile [0, n_bins): pass A of data shard d
runs on grid[d][m] with the histograms over slice m only.  The merges are
integer sums (and an OR for the pair presence) in
engine.pipeline._core_after_a: the pass-A partials over the data shards on
each model shard's device, the per-contig counters per slice summed over
the slices, the cutoffs on the host once, pass B per data shard, its
outputs summed over the data shards.  So every (data x model)
factorisation gives the packed vector of one device, bit for bit.

What the JAX runner pads for XLA and the TPU (rows to `_bucket(n, 2048)`,
the bin axis to 1024 * M) and its jit cache have no counterpart here.
"""

from __future__ import annotations

import torch

from ..engine.pipeline import Grid, _unpack_bits, fused_profile_shards
from .mesh import device_grid, route_shard


def model_slices(n_bins: int, model_shards: int) -> list:
    """[(lo, hi)] of each model shard: equal slices of ceil(n_bins / M)
    bins that tile [0, n_bins) exactly (the last ones may be short or
    empty)."""
    step = -(-n_bins // model_shards)
    return [(min(m * step, n_bins), min((m + 1) * step, n_bins))
            for m in range(model_shards)]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 uint8 values -> bytes, little bit order (numpy's packbits)."""
    pad = -len(bits) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits.view(-1, 8) << shifts).sum(1).to(torch.uint8)


def route_piece(fmt, arrays, n, D: int) -> list:
    """A piece's tensors over D data shards, on their device:
    [(arrays, records)] with the record order kept within each shard
    (runner.py:62-90).

    "v1" arrays (read_id, rid, pos) route by read id.  "v2" arrays
    (bitpacked read boundaries, contig ids, local bins) route by the
    piece-local read index, and each shard's boundaries are packed again:
    a read's records stay together and in order, so the first record of
    each read keeps its bit.  The shard sizes come to the host: one sync
    per call, the only one of a piece."""
    if fmt == "v1":
        key, cols = arrays[0], arrays
    else:
        bnd, rid, lbin = arrays
        bits = _unpack_bits(bnd, n)
        key = torch.cumsum(bits, 0, dtype=torch.int32) - 1
        cols = (bits, rid, lbin)
    shard = route_shard(key, D)
    # one-byte keys: one radix pass on a GPU
    order = torch.sort(shard.to(torch.uint8) if D <= 256 else shard,
                       stable=True).indices
    counts = torch.bincount(shard, minlength=D).tolist()
    parts = list(zip(*(torch.split(c[order], counts) for c in cols)))
    if fmt == "v2":
        parts = [(_pack_bits(b), r, lb) for b, r, lb in parts]
    return list(zip(parts, counts))


def _as_grid(devices) -> list:
    """The (data, model) grid `devices` as torch.devices, checked."""
    grid = [[torch.device(x) for x in row] for row in devices]
    if not grid or not grid[0] or len({len(row) for row in grid}) != 1:
        raise ValueError("a device grid needs equal, non-empty rows")
    return grid


class ShardedRunner:
    """`sharded_runner` for engine.pipeline.profile_arrays / profile_file /
    profile_file_streaming: data shards over reads x model shards over the
    bin axis, on `devices`, a (data, model) grid of devices in which the
    same device may repeat, or when it is None on
    device_grid(num_shards, model_shards, device)."""

    distributed = False
    reduce = None

    def __init__(self, devices=None, num_shards: int | None = None,
                 model_shards: int = 1, device="cuda"):
        if devices is None:
            device = torch.device(device)
            data = num_shards or (
                max(1, torch.cuda.device_count() // model_shards)
                if device.type == "cuda" else 1)
            devices = device_grid(data, model_shards, device)
        self.devices = _as_grid(devices)
        self.data_shards = len(self.devices)
        self.model_shards = len(self.devices[0])

    def grid(self, make_tables) -> Grid:
        """The Grid of one profile: make_tables(device) runs once per
        distinct device."""
        tables = {}
        rows = [[tables[dev] if dev in tables
                 else tables.setdefault(dev, make_tables(dev)) for dev in row]
                for row in self.devices]
        split = None
        if self.data_shards > 1:
            def split(fmt, arrays, n):
                return route_piece(fmt, arrays, n, self.data_shards)
        return Grid(rows, model_slices(rows[0][0].n_bins, self.model_shards),
                    split=split, reduce=self.reduce)

    def fused(self, read_id, rid, pos, make_tables, **plan) -> dict:
        """The fused profile of grouped host records over the grid (the
        engine interface of runner.py:133-150)."""
        grid = self.grid(make_tables)
        return fused_profile_shards(grid, grid.shards(read_id, rid, pos),
                                    **plan)

    # one process: nothing to agree on
    def broadcast(self, value: int) -> int:
        return value

    def sum_totals(self, *values) -> tuple:
        return values
