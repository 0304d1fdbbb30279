"""The profile core in PyTorch: counterpart of slimm_tpu/engine/pipeline.py.

The same computation as the JAX package's fused per-file profile, written
for eager PyTorch on one device (the `device` of the tensors it is given):

  pass A   records -> center binning, first-hit (read, contig) dedup,
           uniqueness, the cov / uniq_cov histograms (ops.hist.hist2)
  cutoffs  per-contig counters -> the coverage-quantile cutoffs and the
           contig validity mask, computed on the host (one small sync)
  pass B   validity-filtered re-dedup, the vectorised LCA, the fused
           [uniq2 | LCA taxon] histogram and the contig x code pair
           presence (ops.hist.hist1)
  packing  one int32 vector in the JAX package's layout, which
           `_finalize_state` reads back into a ProfileState

Records are int32 (read_id, rid, pos) arrays grouped by read id, unpadded.
Per-read segment reductions run along the record axis as shift windows
(window > 0) or doubling scans (window == 0), as in the JAX package.
Padding buckets and one-hot matmul gathers are not ported: tables are read
with plain index gathers.  `pipeline.py:N` below refers to
slimm_tpu/engine/pipeline.py.

Streamed files (the overlap path of `profile_file` for large files, and
`profile_file_streaming`) run the same passes piece by piece: pass A per
piece as the native stream decoder emits it, the cutoffs once after EOF,
pass B over the kept pieces.  Reads never span pieces and every pass-B
output is a sum or an OR over reads, so this is exact.  The port reads the
v2 pieces that the native decoder (io/native.py) encodes: the
bitpacked read boundaries, the narrow contig ids and the uint16 local
bins, each cut to the piece's valid records (no padding).  v1 chunks (bin
tables past uint16) upload their int32 (read_id, rid, pos) arrays as they
are: `pack_records_compact` (pipeline.py:962-978) was a format for the TPU
host's slow host-to-device link, and it costs a host pass per chunk.

Every path runs over a `Grid` of devices: one device is the 1 x 1 grid;
slimm_tpu_torch.parallel builds larger ones (data shards over reads, model
shards over the bin axis, processes over torch.distributed), and
`_core_after_a` merges between its stages with integer sums.  A group of
files with one header (`profile_files_batched`, the CLI's `-d`) runs as one
profile over tables that lay the files end to end
(tables.group_tables); the cutoffs and the packing are per file.

Under a running torch.profiler each request is a `slimm.profile` span (the
outermost entry-point call) whose children, on the caller's thread, name
its stages: `slimm.init` (per-call host state, the tables on the device),
`slimm.decode_wait` (the host waiting on the decoder), `slimm.upload`,
`slimm.plan` (of a whole file: on the device, after the upload),
`slimm.pass_a`, `slimm.cutoffs` (sums, the one sync, the
host cutoffs), `slimm.pass_b` (with the packing), `slimm.fetch` and
`slimm.finalize`, which holds `slimm.pairs` (the children sets from the
pair presence) and `slimm.propagate` (the ancestor propagation);
engine/reports.py adds `slimm.report` (utils/timer.py `span`).
`work_counts` counts what the calls did, always.
"""

from __future__ import annotations

import copy
import functools
import os
import queue
import resource
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..config import EngineOptions, ProfileOptions
from ..database import SlimmDatabase, tensorize
from ..state import LcaPairs, ProfileState, quantile_cut_off
from ..utils.timer import PhaseTimer, span, work_counts

from ..ops.hist import hist1, hist2
from ..tables import DeviceTables, device_tables, group_tables

# Widest shift window for device dedup and segment reductions; reads with
# more records take the doubling scans (and host dedup).
MAX_WINDOW = 4

# packed layout: 6 rows of n_contigs + 8 scalars + n_dense taxon counts +
# the bitpacked pair presence
_N_SCALARS = 8

# v2 pieces carry the local bin as uint16; files whose contigs have more
# bins stream v1 chunks, and the overlap path gives way (pipeline.py:79)
V2_MAX_BIN = int(np.iinfo(np.uint16).max)

# Which paths ran: files and pieces of the overlap path, why it gave way to
# the whole-file path, files and chunks (v2, v1) of chunk streaming and why
# it gave way (_gives_way), pieces that pass B uploaded again from host
# copies, files profiled through a sharded runner (slimm_tpu_torch.parallel),
# and groups of files profiled as one and groups profiled file by file
# instead.
path_counts = dict.fromkeys((
    "overlap_files", "overlap_pieces",
    "overlap_fallback_open", "overlap_fallback_bins_past_uint16",
    "overlap_fallback_overflow", "overlap_fallback_not_grouped",
    "stream_files", "stream_chunks_v2", "stream_chunks_v1",
    "stream_fallback_open",
    "stream_fallback_not_grouped", "stream_fallback_overflow",
    "pass_b_reuploads", "sharded_files", "batched_groups",
    "batched_fallback_per_file"), 0)


def reset_path_counts():
    """Zero `path_counts` and `work_counts`."""
    for counts in (path_counts, work_counts):
        for key in counts:
            counts[key] = type(counts[key])()


# Host-clock marks for a caller that splits its time: None (off), or a list
# that gets ("cutoffs", time.perf_counter()) right after the cutoffs' one
# host sync, in _core_after_a on every path; a benchmark splits each call
# there.  Stages are spans (utils/timer.py `span`), never new marks.
host_marks = None


def _mark(point: str) -> None:
    if host_marks is not None:
        host_marks.append((point, time.perf_counter()))


# The thread's outermost entry-point call, if one is running
_in_request = threading.local()


def _request(entry):
    """An entry point whose outermost call, on its thread, is one request:
    a `slimm.profile` span around it, and its call, minor page faults and
    CPU seconds counted in work_counts (two getrusage calls).  A call that
    another entry point makes is a part of that request, and opens none."""
    @functools.wraps(entry)
    def call(*args, **kwargs):
        if getattr(_in_request, "on", False):
            return entry(*args, **kwargs)
        _in_request.on = True
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        try:
            with span("profile"):
                return entry(*args, **kwargs)
        finally:
            r1 = resource.getrusage(resource.RUSAGE_SELF)
            _in_request.on = False
            work_counts["calls"] += 1
            work_counts["minor_faults"] += r1.ru_minflt - r0.ru_minflt
            work_counts["cpu_s"] += (r1.ru_utime + r1.ru_stime
                                     - r0.ru_utime - r0.ru_stime)
    return call


# copied from slimm_tpu/engine/pipeline.py:82-94 (the v2 stream's piece cap)
def _bucket(n: int, quantum: int = 8192) -> int:
    """Round up to a padding bucket: geometric 1.25x steps snapped to 2048."""
    if n <= quantum:
        return max(quantum, 1)
    b = float(quantum)
    while b < n:
        b *= 1.25
    return -(-int(b) // 2048) * 2048


# ---------------------------------------------------------------------------
# segment helpers (pipeline.py:176-229)
# ---------------------------------------------------------------------------


def _shift_right(x, d, fill):
    """x moved d places toward the end, the first d places set to fill."""
    out = torch.full_like(x, fill)
    if d < x.shape[0]:
        out[d:] = x[:x.shape[0] - d]
    return out


def _shift_left(x, d, fill):
    out = torch.full_like(x, fill)
    if d < x.shape[0]:
        out[:x.shape[0] - d] = x[d:]
    return out


def _shifts(k_steps, window):
    """Shift distances of a segment pass: the window, or doubling steps."""
    return (range(1, window + 1) if window > 0
            else [1 << k for k in range(k_steps)])


def _seg_end_reduce(t_read, values, combine, identity, *, k_steps, window):
    """Segment reduction along the grouped record axis; the END position of
    each run of equal t_read holds the whole segment's reduction.

    window > 0: shift window of that width (needs window >= max_run - 1).
    window == 0: doubling scan, k_steps >= ceil(log2(max_run)).
    """
    v = values
    for d in _shifts(k_steps, window):
        same = t_read == _shift_right(t_read, d, -2)
        src = values if window > 0 else v
        v = combine(v, torch.where(same, _shift_right(src, d, identity),
                                   identity))
    return v


def _backfill_from_ends(t_read, end_values, end_mask, fill, *, k_steps,
                        window):
    """Propagate each segment's end value back to every element."""
    y = torch.where(end_mask, end_values, fill)
    src = y
    for d in _shifts(k_steps, window):
        same = t_read == _shift_left(t_read, d, -3)
        ny = _shift_left(src if window > 0 else y, d, fill)
        y = torch.where(same & (y == fill), ny, y)
    return y


def _count(mask) -> torch.Tensor:
    """int32 count of a bool tensor (torch.sum would give int64)."""
    return mask.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# pass A (pipeline.py:309-389)
# ---------------------------------------------------------------------------


def _center_gbin(rid, pos, t: DeviceTables):
    """Global bin of each record's center position, with uint32 wrap
    (slimm.hpp:200-201), in int64: torch has no uint32 add or minimum on
    the CPU."""
    rid_c = rid.clamp(0, t.n_contigs - 1)
    half, bin_width = t.half, t.bin_width
    if t.n_files > 1:       # a group of files: each contig its file's own
        half, bin_width = half[rid_c], bin_width[rid_c]
    u32 = 0xFFFFFFFF
    center = torch.minimum(((pos.to(torch.int64) & u32) + half) & u32,
                           t.lengths[rid_c])
    return t.bin_offset[rid_c] + (center // bin_width).to(torch.int32)


def _pass_a_local(read_id, rid, pos, t: DeviceTables, *, dedup_window,
                  k_steps, window, t_gbin=None, bin_lo=0, hist_bins=None):
    """Grouped records -> dedup mask, global bins, uniqueness, coverage.

    t_gbin, when given, holds the records' global bins already (v2 pieces
    carry the decoder's local bin) and pos is not read.  With hist_bins, the
    histograms cover the model shard's bins [bin_lo, bin_lo + hist_bins)
    only: records outside them carry weight 0 (pipeline.py:378-386)."""
    valid = read_id >= 0
    if t_gbin is None:
        t_gbin = _center_gbin(rid, pos, t)

    # first-hit-wins (read, contig) dedup (read_stat.hpp:116-135)
    dup = torch.zeros_like(valid)
    for d in range(1, dedup_window + 1):
        same = read_id == _shift_right(read_id, d, -2)
        dup |= same & (rid == _shift_right(rid, d, -1))
    nondup = valid & ~dup

    # per-read distinct-target count -> uniqueness (slimm.hpp:221-239)
    end_mask = valid & (read_id != _shift_left(read_id, 1, -3))
    cnt_end = _seg_end_reduce(read_id, nondup.to(torch.int32), torch.add, 0,
                              k_steps=k_steps, window=window)
    total = _backfill_from_ends(read_id, cnt_end, end_mask, 0,
                                k_steps=k_steps, window=window)
    t_uniq = nondup & (total == 1)
    uniq_matches = _count(end_mask & (cnt_end == 1))
    if hist_bins is None:
        cov, uniq_cov = hist2(t_gbin, nondup, t_uniq, t.n_bins)
    else:
        idx = t_gbin - bin_lo
        in_range = (idx >= 0) & (idx < hist_bins)
        cov, uniq_cov = hist2(idx, nondup & in_range, t_uniq & in_range,
                              hist_bins)
    return dict(t_gbin=t_gbin, nondup=nondup, cov=cov, uniq_cov=uniq_cov,
                uniq_matches=uniq_matches)


# ---------------------------------------------------------------------------
# per-contig counters and cutoffs (pipeline.py:698-724)
# ---------------------------------------------------------------------------


def _contig_sums_nz(values, t: DeviceTables, lo=0):
    """(per-contig sums, per-contig nonzero-bin counts) over the bins
    [lo, lo + len(values)) of the flat bin axis, from exact int64 prefix
    sums at the contig boundaries clipped to that slice (pipeline.py:700-710;
    lo = 0 and the whole axis on one device)."""
    hi = lo + values.shape[0]
    starts = t.bin_offset.to(torch.int64).clamp(lo, hi) - lo
    ends = t.bin_ends.to(torch.int64).clamp(lo, hi) - lo
    zero = values.new_zeros(1, dtype=torch.int64)
    cs = torch.cat([zero, torch.cumsum(values, 0, dtype=torch.int64)])
    cz = torch.cat([zero, torch.cumsum(values > 0, 0, dtype=torch.int64)])
    return ((cs[ends] - cs[starts]).to(torch.int32),
            (cz[ends] - cz[starts]).to(torch.int32))


def _cutoffs(rc, nzc, urc, nzu, t: DeviceTables):
    """Coverage-quantile cutoffs and the validity mask, on the host.

    The JAX package scans float32 sums in contig order on the device; a CUDA
    reduction keeps no order, so the four per-contig counters come to the
    host and the oracle's own exact `quantile_cut_off` runs there, per file
    over its own contigs for a group of files.  Returns (cc, ucc) as
    float32[n_files] and the validity mask on the device."""
    rc_h, nzc_h, urc_h, nzu_h = (x.cpu().numpy() for x in (rc, nzc, urc, nzu))
    covp = nzc_h.astype(np.float32) / t.nbins
    ucovp = nzu_h.astype(np.float32) / t.nbins
    K = t.n_files
    cc = np.zeros(K, np.float32)
    ucc = np.zeros(K, np.float32)
    if t.q < np.float32(1.0):
        sel = (urc_h > 0).reshape(K, -1)
        for k, (c, u) in enumerate(zip(covp.reshape(K, -1),
                                       ucovp.reshape(K, -1))):
            cc[k] = quantile_cut_off(c[sel[k]], t.q)
            ucc[k] = quantile_cut_off(u[sel[k]], t.q)
    C = len(rc_h) // K
    valid = ((rc_h > 0) & (covp >= np.repeat(cc, C))
             & (ucovp >= np.repeat(ucc, C)))
    work_counts["h2d_bytes"] += valid.nbytes
    return cc, ucc, torch.from_numpy(valid).to(rc.device)


# ---------------------------------------------------------------------------
# pass B (pipeline.py:485-628)
# ---------------------------------------------------------------------------


def _pass_b_local(read_id, rid, t_gbin, nondup, valid_mask, t: DeviceTables,
                  *, k_steps, window, emit_coverage, slices=None):
    """Filtered re-dedup + vectorised LCA (slimm.hpp:351-392, 516-557).

    With emit_coverage, `uniq_cov2` is a list of histograms: over the whole
    bin axis, or with `slices` one per model shard's bins [lo, hi)
    (pipeline.py:571-581).  Every other output is bin-independent."""
    C = t.n_contigs
    rid_c = rid.clamp(0, C - 1)
    tmask = nondup & valid_mask[rid_c]
    end_mask = (read_id >= 0) & (read_id != _shift_left(read_id, 1, -3))

    # per-read valid-target count at segment ends
    cnt = _seg_end_reduce(read_id, tmask.to(torch.int32), torch.add, 0,
                          k_steps=k_steps, window=window)
    total = _backfill_from_ends(read_id, cnt, end_mask, 0,
                                k_steps=k_steps, window=window)
    t_u2 = tmask & (total == 1)          # newly unique (slimm.hpp:383-390)
    multi_end = end_mask & (cnt > 1)

    # LCA: one 8-bit disagreement mask per target against its nearest
    # preceding valid target of the same read, OR-ed to the segment end
    lv = t.lineage[rid_c]                                        # (N, 8)
    bitw = 1 << torch.arange(8, dtype=torch.int32, device=rid.device)
    if window > 0:
        disag_bits = torch.zeros_like(read_id)
        prev_found = torch.zeros_like(tmask)
        for d in range(1, window + 1):
            same = read_id == _shift_right(read_id, d, -2)
            cand = same & _shift_right(tmask, d, False) & ~prev_found
            bits_d = torch.where(lv != _shift_right(lv, d, -1), bitw,
                                 0).sum(1, dtype=torch.int32)
            disag_bits = torch.where(cand, bits_d, disag_bits)
            prev_found |= cand
    else:
        # long runs: the nearest preceding valid target by a doubling scan
        enc = torch.where(tmask, rid, -1)
        last_valid = _seg_end_reduce(   # holds at every position
            read_id, enc, lambda cur, earl: torch.where(cur >= 0, cur, earl),
            -1, k_steps=k_steps, window=0)
        same1 = read_id == _shift_right(read_id, 1, -2)
        prev_rid = torch.where(same1, _shift_right(last_valid, 1, -1), -1)
        prev_found = prev_rid >= 0
        lv_prev = t.lineage[prev_rid.clamp(0, C - 1)]
        disag_bits = torch.where(lv != lv_prev, bitw, 0).sum(
            1, dtype=torch.int32)
    disag_bits = torch.where(tmask & prev_found, disag_bits, 0)
    disag = _seg_end_reduce(read_id, disag_bits, torch.bitwise_or, 0,
                            k_steps=k_steps, window=window)
    rid_mx = _seg_end_reduce(read_id, torch.where(tmask, rid, -1),
                             torch.maximum, -1, k_steps=k_steps,
                             window=window)
    rid_mx_c = rid_mx.clamp(0, C - 1)
    # first agreeing level = lowest zero bit of the OR-ed disagreement mask
    z = ~disag & 0xFF
    first_level = t.first_level[z.long()]
    # lineage[max rid][first agreeing level, or 7] (slimm.hpp:516-531)
    lca_end = t.lineage.view(-1)[rid_mx_c * 8 + first_level]
    lca_clip = lca_end.clamp(0, t.n_dense - 1)

    out = {}
    if emit_coverage and slices is not None:
        # model-sharded: a uniq_cov2 histogram per slice, and the LCA counts
        # in a histogram of their own
        out["uniq_cov2"] = []
        for lo, hi in slices:
            li = t_gbin - lo
            in_range = (li >= 0) & (li < hi - lo)
            out["uniq_cov2"].append(hist1(li, t_u2 & in_range, hi - lo))
        out["taxon_counts"] = hist1(lca_clip, multi_end, t.n_dense)
    elif emit_coverage:
        # one fused histogram: [0, B) uniq_cov2, [B, B + n_dense) LCA counts
        B = t.n_bins
        idx = torch.where(t_u2, t_gbin, B + lca_clip)
        combined = hist1(idx, t_u2 | multi_end, B + t.n_dense)
        out["uniq_cov2"] = [combined[:B]]
        out["taxon_counts"] = combined[B:]
    else:
        # [0, C) per-contig uniq2 counts, [C, C + n_dense) LCA counts
        idx = torch.where(t_u2, rid_c, C + lca_clip)
        combined = hist1(idx, t_u2 | multi_end, C + t.n_dense)
        out["u2_counts"] = combined[:C]
        out["taxon_counts"] = combined[C:]

    # (lca, contig) pairs for the children sets as a (contig x code)
    # presence map: code L < 8 marks the read's first agreeing level, code
    # 8 + k the k-th superkingdom where no level agrees (pipeline.py:601-614)
    no_agree = z == 0
    code_end = torch.where(no_agree, 8 + t.sk_code[rid_mx_c], first_level)
    code_b = _backfill_from_ends(read_id,
                                 torch.where(multi_end, code_end, -1),
                                 end_mask, -1, k_steps=k_steps, window=window)
    t_multi = tmask & (total > 1)
    pidx = rid_c * t.n_codes + code_b.clamp(0, t.n_codes - 1)
    out["pair_levels"] = hist1(pidx, t_multi, _pair_domain(t)) > 0
    out["uniq_matches2"] = _count(end_mask & (cnt == 1))
    return out


def _pair_domain(t: DeviceTables) -> int:
    """Slots of the (contig x code) pair presence, padded to 1024 as in the
    JAX layout: the packed vector carries pdom / 32 presence words."""
    return _pad1024(t.n_contigs * t.n_codes)


def _pad1024(n: int) -> int:
    return -(-n // 1024) * 1024


def _pack_bits_words(x):
    """Bitpack a bool vector (length a multiple of 32) into int32 words whose
    little-endian bytes equal np.packbits(x, bitorder="little")."""
    b = x.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    # disjoint bits: the int64 sum is their OR; the int32 cast wraps bit 31
    return (b << shifts).sum(1).to(torch.int32)


# ---------------------------------------------------------------------------
# the fused profile (pipeline.py:635-786)
# ---------------------------------------------------------------------------


@dataclass
class Grid:
    """Where one profile runs: `tables[d][m]` on the device of data shard d
    and model shard m (one device: `Grid.single`).

    slices[m] = (lo, hi), model shard m's bins, tile [0, n_bins).
    split(fmt, arrays, n), when given, routes a piece's tensors on the
    first device over the data shards by read (parallel/runner.py);
    reduce(x), when given, sums a tensor across processes in place
    (parallel/multihost.py).  The merges below call it on every rank in the
    same order."""
    tables: list
    slices: list
    split: Callable | None = None
    reduce: Callable | None = None

    @classmethod
    def single(cls, t: DeviceTables) -> "Grid":
        return cls([[t]], [(0, t.n_bins)])

    @property
    def D(self) -> int:
        return len(self.tables)

    @property
    def M(self) -> int:
        return len(self.slices)

    @property
    def home(self) -> torch.device:
        """The first device: records are uploaded and routed there."""
        return self.tables[0][0].device

    def window(self, m) -> dict:
        """pass A's bin window of model shard m (none on one model shard)."""
        if self.M == 1:
            return {}
        lo, hi = self.slices[m]
        return dict(bin_lo=lo, hist_bins=hi - lo)

    def bins(self, m) -> int:
        lo, hi = self.slices[m]
        return hi - lo

    def pieces(self, fmt, arrays, n):
        """[(tensors of data shard d, its record count)] for d < D, from a
        piece's tensors on the home device."""
        if self.split is None:
            return [(arrays, n)]
        return self.split(fmt, arrays, n)

    def place(self, d, part) -> list:
        """Data shard d's tensors on the device of each of its model
        shards, one copy per distinct device."""
        on = {}
        for t in self.tables[d]:
            if t.device not in on:
                on[t.device] = tuple(a.to(t.device, non_blocking=True)
                                     for a in part)
        return [on[t.device] for t in self.tables[d]]

    def upload(self, read_id, rid, pos) -> tuple:
        """Host records of a whole file -> (read_id, rid, pos), int32
        tensors on the home device, each copied once."""
        with span("upload"):
            records = []
            for a in (read_id, rid, pos):
                a = np.ascontiguousarray(a, np.int32)
                work_counts["h2d_bytes"] += a.nbytes
                records.append(torch.from_numpy(a).to(self.home))
            return tuple(records)

    def route(self, records) -> list:
        """A whole file's grouped record tensors on the home device ->
        shards[d][m], the tensors of data shard d on tables[d][m]'s device.
        Where the grid is more than the home device, the routing over the
        data shards and the copies to the model shards' devices are an
        `upload` span of their own."""
        if self.split is None and all(t.device == self.home
                                      for t in self.tables[0]):
            return [[records] * self.M]
        with span("upload"):
            return [self.place(d, part) for d, (part, _) in
                    enumerate(self.pieces("v1", records, len(records[0])))]

    def shards(self, read_id, rid, pos) -> list:
        """Grouped host records of a whole file -> shards[d][m] (upload,
        then route)."""
        return self.route(self.upload(read_id, rid, pos))

    def merge(self, parts, m=0):
        """Sum of the data shards' parts on model shard m's device (of data
        shard 0), then across processes."""
        dev = self.tables[0][m].device
        out = parts[0].to(dev)
        for x in parts[1:]:
            out = out + x.to(dev)
        if self.reduce is not None:
            self.reduce(out)
        return out

    def merge_any(self, parts):
        """OR of bool parts on the first device, then across processes (as
        an int32 sum: exact at any process count)."""
        dev = self.tables[0][0].device
        out = parts[0].to(dev)
        for x in parts[1:]:
            out = out | x.to(dev)
        if self.reduce is None:
            return out
        n = out.to(torch.int32)
        self.reduce(n)
        return n > 0


def fused_profile(read_id, rid, pos, t: DeviceTables, *, dedup_window,
                  k_steps, window, emit_coverage=True):
    """The whole per-file profile on the device of the record tensors.

    Returns dict with `packed` (int32[6*C + 8 + n_dense + pair words]:
    reads_count, uniq_reads_count, nz_cov, nz_uniq, uniq_reads_count2,
    valid_mask, scalars [uniq_matches, uniq_matches2, cc<bitcast>,
    ucc<bitcast>, 0, 0, 0, 0], taxon_counts, bitpacked pair presence) and,
    when emit_coverage, the cov / uniq_cov / uniq_cov2 histograms
    (int32[n_bins]) that the -ro/-co reports need."""
    return fused_profile_shards(Grid.single(t), [[(read_id, rid, pos)]],
                                dedup_window=dedup_window, k_steps=k_steps,
                                window=window, emit_coverage=emit_coverage)


def fused_profile_shards(grid: Grid, shards, *, dedup_window, k_steps,
                         window, emit_coverage=True):
    """fused_profile over a grid: shards[d][m] = (read_id, rid, pos) of data
    shard d on tables[d][m]'s device.  Pass A runs per (d, m) over model
    shard m's bins (pipeline.py:657-671); pass B per data shard."""
    with span("pass_a"):
        cov, uniq_cov, uniq_matches, pieces = _pass_a_shards(
            grid, shards, dedup_window=dedup_window, k_steps=k_steps,
            window=window)
    return _core_after_a(grid, cov, uniq_cov, uniq_matches,
                         pieces.__getitem__, emit_coverage=emit_coverage)


def _pass_a_shards(grid: Grid, shards, *, dedup_window, k_steps, window):
    """Pass A of every (data, model) shard, enqueued without a host sync:
    (cov[d][m], uniq_cov[d][m], uniq_matches[d], pass-B pieces[d])."""
    cov, uniq_cov, uniq_matches, pieces = [], [], [], []
    for d, row in enumerate(shards):
        cov.append([])
        uniq_cov.append([])
        for m, (read_id, rid, pos) in enumerate(row):
            a = _pass_a_local(read_id, rid, pos, grid.tables[d][m],
                              dedup_window=dedup_window, k_steps=k_steps,
                              window=window, **grid.window(m))
            cov[d].append(a["cov"])
            uniq_cov[d].append(a["uniq_cov"])
            if m == 0:
                uniq_matches.append(a["uniq_matches"])
                pieces.append([(read_id, rid, a["t_gbin"], a["nondup"],
                                k_steps, window)])
    return cov, uniq_cov, uniq_matches, pieces


def _core_after_a(grid: Grid, cov, uniq_cov, uniq_matches, pass_b_pieces, *,
                  emit_coverage):
    """Everything after the pass-A histograms (pipeline.py:682-770), in
    stages that merge between them: the pass-A partials over the data
    shards, the per-contig counters per model slice summed over the slices,
    the host cutoffs (once), pass B per data shard, its merges, packing.

    cov[d][m] / uniq_cov[d][m]: data shard d's histograms of model slice m
    on tables[d][m]'s device; uniq_matches[d]; pass_b_pieces(d) yields
    (read_id, rid, t_gbin, nondup, k_steps, window) per group of whole reads
    of data shard d on tables[d][0]'s device: a shard's records in one
    piece, or the streamed pieces one by one."""
    D, M = grid.D, grid.M
    t0 = grid.tables[0][0]
    with span("cutoffs"):
        cov_m = [grid.merge([cov[d][m] for d in range(D)], m)
                 for m in range(M)]
        ucov_m = [grid.merge([uniq_cov[d][m] for d in range(D)], m)
                  for m in range(M)]
        uniq_matches = grid.merge(uniq_matches)
        # per-contig counters of the MERGED slices (occupancy does not
        # commute with summation)
        rc, nzc = _slice_sums(grid, cov_m)
        urc, nzu = _slice_sums(grid, ucov_m)
        cc, ucc, valid_mask = _cutoffs(rc, nzc, urc, nzu, t0)
    _mark("cutoffs")
    with span("pass_b"):
        slices = grid.slices if M > 1 else None
        accs = []
        for d in range(D):
            t = grid.tables[d][0]
            acc = _pass_b_acc(t, emit_coverage, slices)
            valid_d = valid_mask.to(t.device)
            for read_id, rid, t_gbin, nondup, k_steps, window in (
                    pass_b_pieces(d)):
                _pass_b_chunk(acc, read_id, rid, t_gbin, nondup, valid_d, t,
                              k_steps=k_steps, window=window,
                              emit_coverage=emit_coverage, slices=slices)
            accs.append(acc)
        # bin-independent pass-B outputs come once per data shard: merged
        # over the data shards only (pipeline.py:744-749)
        if emit_coverage:
            u2_m = [grid.merge([a["u2"][m] for a in accs], m)
                    for m in range(M)]
            u2 = _slice_sums(grid, u2_m)[0]
        else:
            u2 = grid.merge([a["u2"] for a in accs])
        taxon = grid.merge([a["taxon"] for a in accs])
        uniq_matches2 = grid.merge([a["um2"] for a in accs])
        pair = grid.merge_any([a["pair"] for a in accs])
        out = dict(packed=_pack(rc, urc, nzc, nzu, u2, valid_mask,
                                uniq_matches, uniq_matches2, cc, ucc, taxon,
                                pair, t0))
        if emit_coverage:
            out.update(cov=_concat(cov_m, t0), uniq_cov=_concat(ucov_m, t0),
                       uniq_cov2=_concat(u2_m, t0))
    return out


def _slice_sums(grid: Grid, parts):
    """Per-contig (sums, nonzero counts) of merged slices parts[m], each on
    its own device, summed over the slices on the first device."""
    dev = grid.tables[0][0].device
    sums = nz = None
    for m, x in enumerate(parts):
        s, z = _contig_sums_nz(x, grid.tables[0][m], grid.slices[m][0])
        s, z = s.to(dev), z.to(dev)
        sums, nz = (s, z) if sums is None else (sums + s, nz + z)
    return sums, nz


def _concat(parts, t: DeviceTables):
    """The slices of one bin histogram as one int32[n_bins] on t's device."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([x.to(t.device) for x in parts])


def _pass_b_acc(t: DeviceTables, emit_coverage, slices=None):
    """Zeroed pass-B accumulators: u2 (with emit_coverage a list of bin
    histograms, one per slice; else per contig), taxon counts,
    uniq_matches2 and the pair presence."""
    dev = t.device

    def zeros(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype, device=dev)

    if emit_coverage:
        u2 = [zeros(hi - lo) for lo, hi in (slices or [(0, t.n_bins)])]
    else:
        u2 = zeros(t.n_contigs)
    return dict(u2=u2, taxon=zeros(t.n_dense), um2=zeros(()),
                pair=zeros(_pair_domain(t), torch.bool))


def _pass_b_chunk(acc, read_id, rid, t_gbin, nondup, valid_mask,
                  t: DeviceTables, *, k_steps, window, emit_coverage,
                  slices=None):
    """Pass B of one piece of whole reads against the validity mask, added
    into `acc` in place (pipeline.py:1523-1552, where JAX donates the
    buffers); the pair presence is OR-ed."""
    b = _pass_b_local(read_id, rid, t_gbin, nondup, valid_mask, t,
                      k_steps=k_steps, window=window,
                      emit_coverage=emit_coverage, slices=slices)
    if emit_coverage:
        for u2, x in zip(acc["u2"], b["uniq_cov2"]):
            u2 += x
    else:
        acc["u2"] += b["u2_counts"]
    acc["taxon"] += b["taxon_counts"]
    acc["um2"] += b["uniq_matches2"]
    acc["pair"] |= b["pair_levels"]


def _pack(rc, urc, nzc, nzu, u2, valid_mask, uniq_matches, uniq_matches2,
          cc, ucc, taxon_counts, pair_levels, t: DeviceTables):
    """The packed int32 vector (pipeline.py:751-766 and 1487-1500); for a
    group of files (t.n_files = K) the K files' vectors one after another,
    each in the one-file layout.  cc, ucc: float32[K]."""
    K = t.n_files
    if K > 1:
        # a read with exactly one (valid) target is one record counted in
        # uniq_cov (u2), and a record's bin lies in its contig's bins, so a
        # file's unique reads are its contigs' sums; the two group-wide
        # counts are not per file
        uniq_matches = urc.view(K, -1).sum(1, dtype=torch.int32)
        uniq_matches2 = u2.view(K, -1).sum(1, dtype=torch.int32)
        cells = t.n_contigs // K * t.n_codes
        rows = pair_levels.new_zeros(K, _pad1024(cells))
        rows[:, :cells] = pair_levels[:K * cells].view(K, cells)
        pair_levels = rows.view(-1)
    cuts = torch.from_numpy(np.stack([cc, ucc], 1).view(np.int32))
    work_counts["h2d_bytes"] += cuts.nbytes
    scalars = torch.cat([torch.stack([uniq_matches, uniq_matches2], -1)
                         .view(K, 2), cuts.to(rc.device),
                         rc.new_zeros(K, _N_SCALARS - 4)], 1)
    parts = [rc, urc, nzc, nzu, u2, valid_mask.to(torch.int32)]
    return torch.cat([x.view(K, -1) for x in parts] + [
        scalars, taxon_counts.view(K, -1),
        _pack_bits_words(pair_levels).view(K, -1)], 1).view(-1)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


# copied from slimm_tpu/engine/pipeline.py:981-993 (its module imports jax)
def unpack_stats(packed_np, n_contigs, n_dense):
    """Host-side view of the fused `packed` vector."""
    C = n_contigs
    s = packed_np
    scal = s[6 * C:6 * C + _N_SCALARS]
    return dict(
        reads_count=s[0:C], uniq_reads_count=s[C:2 * C],
        nz_cov=s[2 * C:3 * C], nz_uniq=s[3 * C:4 * C],
        uniq_reads_count2=s[4 * C:5 * C], valid=s[5 * C:6 * C].astype(bool),
        uniq_matches=int(scal[0]), uniq_matches2=int(scal[1]),
        cc=np.int32(scal[2]).view(np.float32),
        ucc=np.int32(scal[3]).view(np.float32),
        taxon_counts=s[6 * C + _N_SCALARS:6 * C + _N_SCALARS + n_dense])


# copied from slimm_tpu/engine/pipeline.py:996-1008
def plan_from_max_run(max_run: int):
    """(k_steps, window) for the segment reductions given the longest
    equal-read run."""
    if max_run - 1 <= MAX_WINDOW:
        window = max(1, max_run - 1)
        k_steps = 2
    else:
        window = 0
        k_steps = max(2, int(np.ceil(np.log2(max(max_run, 2)))))
        k_steps = ((k_steps + 1) // 2) * 2   # bucket to even (recompiles)
    return k_steps, window


# copied from slimm_tpu/engine/pipeline.py:1011-1021
def seg_plan(read_id):
    """Host-side plan for the segment reductions: (max_run, k_steps,
    window) from the grouped read-id array."""
    read_id = np.asarray(read_id)
    if len(read_id):
        bnd = np.flatnonzero(np.r_[True, read_id[1:] != read_id[:-1], True])
        max_run = int(np.diff(bnd).max())
    else:
        max_run = 1
    k_steps, window = plan_from_max_run(max_run)
    return max_run, k_steps, window


def plan_records(read_id, rid, pos, n_contigs, *, deduped=True,
                 max_targets=0):
    """Group the records by read and pick the dedup plan (pipeline.py
    1076-1118): device dedup over a shift window when the longest run fits
    it, host first-hit dedup otherwise.

    Returns (read_id, rid, pos, dedup_window, k_steps, window)."""
    read_id = np.asarray(read_id)
    rid = np.asarray(rid)
    pos = np.asarray(pos)
    if max_targets > 0 and deduped:
        # native grouped decode: run length known, order guaranteed
        max_run = max_targets
    else:
        if len(read_id) and not np.all(read_id[:-1] <= read_id[1:]):
            order = np.argsort(read_id, kind="stable")
            read_id, rid, pos = read_id[order], rid[order], pos[order]
        max_run, _, _ = seg_plan(read_id)
    k_steps, window = plan_from_max_run(max_run)
    if deduped:
        dedup_window = 0
    elif max_run - 1 <= MAX_WINDOW:
        dedup_window = max(1, max_run - 1)
    else:
        # pathological duplicate span: host first-hit dedup
        key = read_id.astype(np.int64) * n_contigs + rid
        _, first = np.unique(key, return_index=True)
        first.sort()
        read_id, rid, pos = read_id[first], rid[first], pos[first]
        _, k_steps, window = seg_plan(read_id)
        dedup_window = 0
    return read_id, rid, pos, dedup_window, k_steps, window


def _max_run(read_id) -> tuple:
    """(sorted, max_run) of int32 read ids on their device: whether every id
    is at most the next, and for sorted ids the longest run of equal ids
    (1 for none or one id), as seg_plan counts it.  One host read of
    MAX_WINDOW + 2 flags: sortedness, and for k = 1..MAX_WINDOW + 1 whether
    some id equals the one k places on, which in sorted ids is a run longer
    than k.  A run past MAX_WINDOW + 1 is counted exactly by a scan and a
    second read."""
    flags = [(read_id[:-1] <= read_id[1:]).all()]
    flags += [(read_id[k:] == read_id[:-k]).any()
              for k in range(1, MAX_WINDOW + 2)]
    ordered, *longer = torch.stack(flags).tolist()
    if not ordered:
        return False, 0
    if not longer[-1]:
        return True, 1 + sum(longer)
    runs = torch.unique_consecutive(read_id, return_counts=True)[1]
    return True, int(runs.max())


def plan_uploaded(grid: Grid, records, host, n_contigs, *, deduped=True,
                  max_targets=0):
    """plan_records' plan of a whole file's records, taken from their upload
    (`Grid.upload`) on the home device: (records, dedup_window, k_steps,
    window), the records grouped by read, as plan_records gives them for
    the host arrays `host` = (read_id, rid, pos).

    The decoder's max_targets plans deduped records.  Otherwise one host
    read gives the sortedness and the longest run (_max_run); unsorted
    records are sorted there first (torch's stable sort, the permutation of
    numpy's stable argsort) and read again.  Only raw records whose longest
    run passes MAX_WINDOW + 1 go to the host: plan_records' first-hit dedup
    rewrites `host`, and its output is uploaded.  work_counts counts the
    plans that took the uploaded records (`device_plans`) and those taken
    on the host (`host_plans`)."""
    if max_targets > 0 and deduped:
        max_run = max_targets
    else:
        ordered, max_run = _max_run(records[0])
        if not ordered:
            read_id, order = torch.sort(records[0], stable=True)
            records = (read_id, records[1][order], records[2][order])
            del order
            _, max_run = _max_run(read_id)
        if not deduped and max_run - 1 > MAX_WINDOW:
            work_counts["host_plans"] += 1
            *host, dedup_window, k_steps, window = plan_records(
                *host, n_contigs, deduped=False)
            return grid.upload(*host), dedup_window, k_steps, window
    work_counts["device_plans"] += 1
    k_steps, window = plan_from_max_run(max_run)
    dedup_window = 0 if deduped else max(1, max_run - 1)
    return records, dedup_window, k_steps, window


# ---------------------------------------------------------------------------
# host orchestration (pipeline.py:1035-1296)
# ---------------------------------------------------------------------------


@_request
def profile_arrays(options: ProfileOptions, db: SlimmDatabase,
                   contig_names, contig_lengths,
                   read_id, rid, pos, n_reads: int, hits_count: int,
                   avg_read_length: int, *, device=None,
                   engine: EngineOptions | None = None,
                   sharded_runner=None, deduped: bool = True,
                   max_targets: int = 0) -> ProfileState:
    """Profile decoded record arrays on `device` (by default the card), or
    over the devices of `sharded_runner` (slimm_tpu_torch.parallel), whose
    merges are exact.

    read_id/rid/pos: with deduped=True (decoder contract) one entry per
    distinct (read, contig) with the first hit's position, grouped by read;
    with deduped=False raw multi-hit records in any order.  n_reads and
    hits_count are the file's totals (across processes: the global ones, on
    every process).  Fills the same ProfileState as the scalar oracle."""
    device = _device(device, sharded_runner)
    engine = engine or EngineOptions()
    timer = PhaseTimer(enabled=engine.phase_log)
    timer.start("Intializing coverages for all reference genome ... ")
    with span("init"):
        st, dense = _begin(options, db, contig_names, contig_lengths,
                           avg_read_length)
    timer.lap()

    st.hits_count = hits_count
    if hits_count == 0:
        _warn_no_hits()
        return st
    st.matches_count = n_reads

    timer.start("Analysing alignments, reads and references ....... ")
    grid = _grid(device, sharded_runner,
                 lambda dev: device_tables(st, dense, options, dev))
    records = grid.upload(read_id, rid, pos)
    with span("plan"):
        records, dedup_window, k_steps, window = plan_uploaded(
            grid, records, (read_id, rid, pos), len(st.accessions),
            deduped=deduped, max_targets=max_targets)
    plan = dict(dedup_window=dedup_window, k_steps=k_steps, window=window,
                emit_coverage=engine.fetch_coverage)
    out = fused_profile_shards(grid, grid.route(records), **plan)
    _finalize_state(st, out, dense, engine, options, timer)
    return st


def _device(device, sharded_runner) -> torch.device | None:
    """The device of an entry point: the card unless `device` names
    another, or None when the profile runs over `sharded_runner`'s grid.
    A missing GPU raises; nothing runs on the CPU unless asked."""
    if sharded_runner is not None:
        if device is not None:
            raise ValueError("give exactly one of device and sharded_runner, "
                             "or neither (the card)")
        return None
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('device cuda: no CUDA device is available (pass '
                           'device="cpu" to profile on the CPU)')
    return device


def _begin(options: ProfileOptions, db: SlimmDatabase, contig_names,
           contig_lengths, avg_read_length: int, dense=None):
    """The host state of one profile: (its ProfileState after init_contigs,
    the dense taxonomy of its contigs).  options.bin_width 0 becomes the
    average read length (slimm.hpp:412-413).  A group of files with one
    header passes the `dense` of its first file to the others."""
    st = ProfileState(options=options, ac__taxid=db.ac__taxid,
                      taxid__name=db.taxid__name)
    st.avg_read_length = avg_read_length
    if options.bin_width == 0:
        options.bin_width = avg_read_length
    st.init_contigs(contig_names, contig_lengths, options.bin_width)
    if dense is None:
        dense = tensorize(db, contig_names)
    return st, dense


def _warn_no_hits() -> None:
    print("[WARNING] No mapped reads found in BAM file!", file=sys.stderr)


def _grid(device, runner, make_tables) -> Grid:
    """The Grid of one profile: `device`'s alone, or `runner`'s grid
    (counted in path_counts["sharded_files"]); make_tables(device) builds
    the tables on a device (tables.device_tables, or group_tables for a
    group of files)."""
    with span("init"):
        if runner is None:
            return Grid.single(make_tables(device))
        path_counts["sharded_files"] += 1
        return runner.grid(make_tables)


def _host(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


def _finalize_state(st, out, dense, engine, options, timer):
    """Fill a ProfileState from the fused profile's outputs (pipeline.py
    1167-1250, without the streamed pair-bits branch): tensors, fetched
    first, or numpy arrays already fetched (a file of the batched path)."""
    with span("fetch"):
        out = {key: _host(x) for key, x in out.items()}
    with span("finalize"):
        return _fill_state(st, out, dense, engine, options, timer)


def _fill_state(st, out, dense, engine, options, timer):
    """_finalize_state's work on the fetched outputs."""
    n_contigs = len(st.accessions)
    packed_np = out["packed"]
    stats = unpack_stats(packed_np, n_contigs, dense.n_dense)
    st.reads_count = stats["reads_count"].astype(np.int64)
    st.uniq_reads_count = stats["uniq_reads_count"].astype(np.int64)
    st._nz_cache["cov"] = stats["nz_cov"].astype(np.int64)
    st._nz_cache["uniq_cov"] = stats["nz_uniq"].astype(np.int64)
    st.uniq_matches_count = stats["uniq_matches"]
    st.uniq_hits_count = st.uniq_matches_count  # identical by construction
    if engine.fetch_coverage:
        st.cov = out["cov"].astype(np.uint32)
        st.uniq_cov = out["uniq_cov"].astype(np.uint32)
    else:
        # drop the zero-filled placeholders so bin-level access without a
        # fetch fails loudly instead of reading silent zeros
        st.cov = st.uniq_cov = st.uniq_cov2 = None
    st.compute_abundances()
    timer.lap()

    if options.min_reads == 0:
        options.min_reads = 1 + (st.matches_count - 1) // 10000

    timer.start("Filtering unlikely sequences ..................... ")
    # host recompute for the failure counters and the report cutoffs; the
    # same integers and the same float32 algorithm as the device mask
    valid = st.compute_valid_refs()
    if not np.array_equal(np.asarray(valid), stats["valid"]):  # pragma: no cover
        print("[WARNING] device/host validity mask mismatch; using host",
              file=sys.stderr)
    timer.lap()

    timer.start("Assigning reads to Least Common Ancestor (LCA) ... ")
    st.uniq_reads_count2 = stats["uniq_reads_count2"].astype(np.int64)
    if engine.fetch_coverage:
        st.uniq_cov2 = out["uniq_cov2"].astype(np.uint32)
    st.uniq_matches_count2 = stats["uniq_matches2"]

    # dense LCA counts + children pairs -> taxid dicts
    taxon_counts_into(st, stats["taxon_counts"], dense)
    with span("pairs"):
        pairs_into(st, packed_np[6 * n_contigs + _N_SCALARS + dense.n_dense:],
                   dense)
    with span("propagate"):
        st.propagate_counts()
    timer.lap()
    return st


def taxon_counts_into(st, counts, dense) -> None:
    """The dense LCA counts int[n_dense] added to st.taxon_id__read_count
    (by taxid)."""
    d = np.flatnonzero(counts > 0)
    for tid, n in zip(dense.dense_to_tid[d].tolist(), counts[d].tolist()):
        st.taxon_id__read_count[tid] = st.taxon_id__read_count.get(tid, 0) + n


def pairs_into(st, pair_words, dense) -> None:
    """The bitpacked (contig x level code) pair presence of the packed tail
    (int32 words) decoded into st.lca_pairs, one sorted CSR (state.LcaPairs)
    that propagate_counts takes in: code < 8 is the read's first agreeing
    lineage level L (the lca is lineage[r][L]), code 8 + k means no level
    agreed (the lca is the k-th superkingdom id)."""
    pbytes = np.ascontiguousarray(pair_words).view(np.uint8)
    n_codes = dense.n_pair_codes
    n_contigs = len(dense.lineage)
    pres = np.unpackbits(pbytes, bitorder="little")
    nz = np.flatnonzero(pres[:n_contigs * n_codes])
    r = nz // n_codes
    code = nz % n_codes
    lca_d = np.where(code < 8, dense.lineage[r, np.minimum(code, 7)],
                     dense.sk_dense[np.maximum(code, 8) - 8]
                     if len(dense.sk_dense) else 0)
    # one key per pair, sorted by LCA, then contig
    keys = np.unique(lca_d.astype(np.int64) * n_contigs + r)
    lca = keys // n_contigs
    starts = np.flatnonzero(np.diff(lca, prepend=-1))
    st.lca_pairs = LcaPairs(dense, lca[starts], np.append(starts, len(keys)),
                            (keys - lca * n_contigs).astype(np.int32))
    work_counts["lca_pairs"] += len(keys)


# copied from slimm_tpu/engine/pipeline.py:1253-1263
def open_alignment_file(path: str, engine: EngineOptions | None = None):
    """The native C++ decoder (io/native.py, built at first use; a failed
    build raises), or with `use_native=False` the pure-Python reference
    decoder — identical array contract."""
    engine = engine or EngineOptions()
    if engine.use_native:
        from ..io import native
        return native.NativeAlignmentFile(path,
                                          hash_names=engine.hash_read_names)
    from ..io import AlignmentFile
    return AlignmentFile(path)


@_request
def profile_file(options: ProfileOptions, db: SlimmDatabase, path: str, *,
                 device=None, engine: EngineOptions | None = None,
                 sharded_runner=None) -> ProfileState:
    """Decode one SAM/BAM file and profile it on `device` (by default the
    card), or over the devices of `sharded_runner`.

    On one device, a file of at least `engine.overlap_min_bytes` takes the
    overlap path (pipeline.py:1277-1288): pass A runs on each piece while
    the native decoder goes on with the rest of the file.  Otherwise, or
    when that path gives way, and always with a sharded_runner, the file is
    decoded whole first."""
    device = _device(device, sharded_runner)
    engine = engine or EngineOptions()
    if (sharded_runner is None and engine.use_native
            and engine.overlap_min_bytes > 0):
        try:
            big = os.path.getsize(path) >= engine.overlap_min_bytes
        except OSError:
            big = False
        if big:
            st = _profile_file_overlap(options, db, path, device=device,
                                       engine=engine)
            if st is not None:
                return st
    with span("decode_wait"):
        af = open_alignment_file(path, engine)
        batch = af.load()
    n_reads, hits_count = batch.n_reads, batch.hits_count
    avg = batch.avg_read_length
    if sharded_runner is not None:
        # across processes each decodes its own file: the totals are the
        # sums, and the average read length (hence bin_width) process 0's,
        # which holds the head of the input
        n_reads, hits_count = sharded_runner.sum_totals(n_reads, hits_count)
        avg = sharded_runner.broadcast(avg)
    return profile_arrays(
        options, db, af.contig_names, af.contig_lengths,
        batch.read_id.astype(np.int32), batch.rid, batch.pos,
        n_reads, hits_count, avg, device=device, engine=engine,
        sharded_runner=sharded_runner, max_targets=batch.max_targets)


# ---------------------------------------------------------------------------
# streamed files: pieces of whole reads (pipeline.py:876-928, 1306-1826)
# ---------------------------------------------------------------------------
#
# A piece is (format, arrays, on_device, n, k_steps, window): "v2" arrays
# are (bitpacked read boundaries uint8, contig id uint8|int16|int32, local
# bin as int16 bits), "v1" arrays (read_id, rid, pos) int32; n records, no
# padding; (k_steps, window) its segment plan.  Pass A decodes each piece
# as it arrives; the piece stays on the device (or, past the byte budget,
# on the host) for pass B, which decodes it again.


def _unpack_bits(bnd_packed, n):
    """The first n bits (uint8 0/1) of numpy packbits' little bit order."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bnd_packed.device)
    return ((bnd_packed[:, None] >> shifts) & 1).reshape(-1)[:n]


def _unpack_read_groups(bnd_packed, n_pad, n_valid):
    """Grouped read ids from a bitpacked boundary mask (pipeline.py:111-125;
    bit = first record of its read, numpy packbits little bit-order):
    cumsum(bits) - 1 over the first n_pad records, -1 from n_valid on."""
    gid = torch.cumsum(_unpack_bits(bnd_packed, n_pad), 0,
                       dtype=torch.int32) - 1
    if n_valid < n_pad:
        gid[n_valid:] = -1
    return gid


def _v2_host(bnd, rid_p, bin_p, n):
    """The n valid records of a piece from `next_piece_v2`; the uint16 bins
    as int16 bits, which `_decode_v2` widens with a mask (torch's uint16
    has few CUDA kernels, and a plain int16 read would turn bins of 32768
    and above negative)."""
    return bnd[:-(-n // 8)], rid_p[:n], bin_p[:n].view(np.int16)


def _upload(arrays, device):
    """Host arrays (numpy, or CPU tensors) onto `device`.  On a GPU each
    goes through pinned memory with a non_blocking copy, so the host does
    not wait for it; the pinned block comes from PyTorch's caching host
    allocator, which keeps it until its copy has run.  On the CPU the
    tensors share the arrays' memory."""
    out = []
    for a in arrays:
        x = (a if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(a)))
        work_counts["h2d_bytes"] += x.nbytes
        if device.type != "cpu":
            x = x.pin_memory().to(device, non_blocking=True)
        out.append(x)
    return tuple(out)


def _decode_v2(arrays, n, t: DeviceTables):
    """(read_id, rid, t_gbin) int32 of a v2 piece (pipeline.py:890-894)."""
    bnd, rid_s, lbin = arrays
    rid = rid_s.to(torch.int32)
    t_gbin = (t.bin_offset[rid.clamp(0, t.n_contigs - 1)]
              + (lbin.to(torch.int32) & 0xFFFF))
    return _unpack_read_groups(bnd, n, n), rid, t_gbin


def _decode_v1(arrays, n, t: DeviceTables):
    """(read_id, rid, t_gbin) of a v1 chunk: bins from the positions."""
    read_id, rid, pos = arrays
    return read_id, rid, _center_gbin(rid, pos, t)


_DECODE = {"v2": _decode_v2, "v1": _decode_v1}


def piece_pass_a_acc(acc, read_id, rid, t_gbin, t: DeviceTables, *, k_steps,
                     window, bin_lo=0, hist_bins=None):
    """Pass A over one piece (pipeline.py:879-902, 1467-1483), added into
    acc's cov, uniq_cov and uniq_matches in place.  The native stream
    decoder has deduped the targets, so dedup_window is 0; (k_steps,
    window) is the piece's own plan; bin_lo/hist_bins a model shard's bin
    window, as in _pass_a_local."""
    a = _pass_a_local(read_id, rid, None, t, dedup_window=0, k_steps=k_steps,
                      window=window, t_gbin=t_gbin, bin_lo=bin_lo,
                      hist_bins=hist_bins)
    acc["cov"] += a["cov"]
    acc["uniq_cov"] += a["uniq_cov"]
    acc["uniq_matches"] += a["uniq_matches"]


def _pass_a_pieces(next_piece, grid: Grid, *, budget, counter):
    """Pass A over the pieces that next_piece() returns, until None.

    Each piece is uploaded to the grid's home device and, over several
    data shards, routed there by read (the one host sync of a piece: the
    shard sizes); each shard's part goes to the devices of its row and its
    pass A is enqueued per model shard while the decoder goes on.  Every
    (data, model) shard keeps its own accumulators, merged once after EOF
    (parallel/streaming.py:17-24).  Parts stay on the device up to `budget`
    bytes in all (None: all), later ones as host copies (pipeline.py:
    1741-1768): the piece itself on one data shard, else a non_blocking
    copy into pinned memory, which pass B reads after the cutoffs' sync on
    the home device.  Returns (acc[d][m], kept[d]).  Input that stops
    being qname-grouped partway, or one read's targets past a piece, gives
    way (_GiveWay)."""
    def zeros(t, n):
        return torch.zeros(n, dtype=torch.int32, device=t.device)

    acc = [[dict(cov=zeros(t, grid.bins(m)), uniq_cov=zeros(t, grid.bins(m)),
                 uniq_matches=zeros(t, ())) for m, t in enumerate(row)]
           for row in grid.tables]
    kept = [[] for _ in range(grid.D)]
    while True:
        try:
            with span("decode_wait"):
                piece = next_piece()
        except ValueError as e:
            if "not qname-grouped" not in str(e):
                raise
            raise _GiveWay("not_grouped") from e
        except OverflowError as e:
            raise _GiveWay("overflow") from e
        if piece is None:
            break
        fmt, host, n, k_steps, window = piece
        if n == 0:
            continue
        with span("upload"):
            arrays = _upload(host, grid.home)
        with span("pass_a"):
            for d, (part, n_d) in enumerate(grid.pieces(fmt, arrays, n)):
                if n_d == 0:
                    continue
                nbytes = sum(a.nbytes for a in part)
                on_device = budget is None or budget >= nbytes
                if on_device and budget is not None:
                    budget -= nbytes
                row = grid.place(d, part)
                decoded = {}     # per distinct device of the row
                for m, t in enumerate(grid.tables[d]):
                    if t.device not in decoded:
                        decoded[t.device] = _DECODE[fmt](row[m], n_d, t)
                    read_id, rid, t_gbin = decoded[t.device]
                    piece_pass_a_acc(acc[d][m], read_id, rid, t_gbin, t,
                                     k_steps=k_steps, window=window,
                                     **grid.window(m))
                if on_device:
                    keep = row[0]
                elif grid.D == 1:
                    keep = host
                else:
                    keep = tuple(a.to("cpu", non_blocking=True)
                                 for a in part)
                kept[d].append((fmt, keep, on_device, n_d, k_steps, window))
        path_counts[counter] += 1
    return acc, kept


def _pass_b_pieces(kept, t: DeviceTables):
    """The kept pieces as `_core_after_a` reads them; host copies are
    uploaded again (pipeline.py:1803-1810)."""
    dev = t.bin_offset.device
    for fmt, arrays, on_device, n, k_steps, window in kept:
        if not on_device:
            arrays = _upload(arrays, dev)
            path_counts["pass_b_reuploads"] += 1
        read_id, rid, t_gbin = _DECODE[fmt](arrays, n, t)
        yield read_id, rid, t_gbin, read_id >= 0, k_steps, window


def _stream_totals(st, sr, path, runner=None) -> bool:
    """The stream's totals into `st`, after its last piece; whether any
    record mapped.  Across processes the totals are summed first, so that
    every process takes the same turn at no hits (parallel/streaming.py:
    184-190)."""
    n_reads, hits_count, _ = sr.totals()
    if runner is not None:
        n_reads, hits_count = runner.sum_totals(n_reads, hits_count)
    warn = sr.warning()
    if warn:
        print(f"[WARNING] {path}: {warn}", file=sys.stderr)
    st.hits_count = hits_count
    st.matches_count = n_reads
    if hits_count == 0:
        _warn_no_hits()
    return hits_count > 0


def _core_after_pieces(grid: Grid, acc, kept, engine):
    return _core_after_a(
        grid, [[a["cov"] for a in row] for row in acc],
        [[a["uniq_cov"] for a in row] for row in acc],
        [row[0]["uniq_matches"] for row in acc],
        lambda d: _pass_b_pieces(kept[d], grid.tables[d][0]),
        emit_coverage=engine.fetch_coverage)


class _GiveWay(Exception):
    """A streamed path hands its file back to the whole-file path
    (pipeline.py:79); the argument is the cause, as path_counts names it."""


def _gives_way(kind):
    """Decorates a streamed path, `kind` "overlap" or "stream", called as
    (options, db, path, **kw): where it raises _GiveWay it returns None.
    The one place that counts the cause in path_counts and puts the
    caller's options.bin_width back (_begin may have set it).  Over a
    runner across processes it raises instead: each process would profile
    its own input alone."""
    def wrap(path_fn):
        @functools.wraps(path_fn)
        def run(options, db, path, **kw):
            bin_width = options.bin_width
            try:
                return path_fn(options, db, path, **kw)
            except _GiveWay as e:
                options.bin_width = bin_width
                path_counts[f"{kind}_fallback_{e}"] += 1
                runner = kw.get("runner")
                if runner is not None and runner.distributed:
                    raise ValueError(
                        f"{path}: streaming across processes cannot fall "
                        f"back to the whole-file path ({e})") from None
                return None
        return run
    return wrap


def _open_stream(path: str, engine: EngineOptions):
    """The native stream reader of `path`; a file it cannot open gives
    way."""
    from ..io import native
    try:
        with span("decode_wait"):
            return native.NativeStreamReader(
                path, hash_names=engine.hash_read_names)
    except ValueError:
        raise _GiveWay("open") from None


def _v2_fits(contig_lengths, bin_width) -> bool:
    """Whether every contig's bins, as init_contigs counts them, fit the v2
    pieces' uint16 local bin."""
    nbins = np.asarray(contig_lengths, np.int64) // bin_width + 1
    return not len(nbins) or int(nbins.max()) <= V2_MAX_BIN


def _rid_dtype(n_contigs):
    """The v2 pieces' contig id type (pipeline.py:1373-1378)."""
    if n_contigs <= np.iinfo(np.uint8).max:
        return np.uint8
    if n_contigs <= np.iinfo(np.int16).max:
        return np.int16
    return np.int32


def _v2_pieces(sr, cap, st):
    """next_piece() over the v2 pieces of at most `cap` targets that the
    C++ decoder encodes against `st`'s contigs and bin width while its
    tokenizer thread runs ahead.  Each piece is planned from its own
    longest read, which the same C++ take reports (pipeline.py:1385-1398).
    The JAX package's chunk streaming plans from sr.max_targets instead
    (pipeline.py:1700), which the reader gives as 0 until EOF (ROADMAP
    C1)."""
    rid_dtype = _rid_dtype(len(st.accessions))
    lengths = st.lengths.astype(np.uint32)
    half = np.int32(st.avg_read_length // 2)
    bin_width = np.int32(st.options.bin_width)

    def next_piece():
        piece = sr.next_piece_v2(cap, cap, lengths, half, bin_width,
                                 rid_dtype, with_plan=True)
        if piece is None:
            return None
        bnd, rid_p, bin_p, nv, _, max_run = piece
        k_steps, window = plan_from_max_run(max(int(max_run), 1))
        n = int(nv)
        return "v2", _v2_host(bnd, rid_p, bin_p, n), n, k_steps, window

    return next_piece


def _v1_pieces(sr, chunk_targets):
    """next_piece() over v1 chunks that a daemon thread decodes ahead
    through a queue of two (pipeline.py:1555-1594, 1703-1734), each
    planned from its read ids.  It re-raises the
    decoder's errors, and joins the thread once the thread has returned
    (at EOF or on an error)."""
    feed: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            while True:
                c = sr.next_chunk(chunk_targets)
                feed.put(("ok", c))
                if c is None:
                    return
        except Exception as e:  # non-grouped input or decode error
            feed.put(("err", e))

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    def next_piece():
        kind, chunk = feed.get()
        if kind == "err" or chunk is None:
            th.join()
        if kind == "err":
            raise chunk
        if chunk is None:
            return None
        _, k_steps, window = seg_plan(chunk[0])
        return "v1", chunk, len(chunk[0]), k_steps, window

    return next_piece


@_gives_way("overlap")
def _profile_file_overlap(options: ProfileOptions, db: SlimmDatabase,
                          path: str, *, device, engine: EngineOptions
                          ) -> ProfileState | None:
    """Whole-file profile with pass A overlapping the decode
    (pipeline.py:1306-1446).  Gives way (None) where the JAX package's
    overlap path does: a file the stream reader cannot open, bins past
    uint16, one read's targets past a piece, or input that stops being
    qname-grouped partway (coordinate-sorted input is regrouped by the
    decoder at EOF and stays on this path)."""
    sr = _open_stream(path, engine)
    if not _v2_fits(sr.contig_lengths,
                    options.bin_width or sr.avg_read_length):
        raise _GiveWay("bins_past_uint16")
    with span("init"):
        st, dense = _begin(options, db, sr.contig_names, sr.contig_lengths,
                           sr.avg_read_length)
    timer = PhaseTimer(enabled=engine.phase_log)
    timer.start("Analysing alignments, reads and references ....... ")

    # the JAX package's piece size: at the default cap, scaled up so that a
    # file makes at most ~56 pieces (bytes per record over-estimated:
    # ~100 for SAM text, ~25 for BGZF); an explicit cap is used exactly
    cap = engine.overlap_piece_targets
    if cap == type(engine)().overlap_piece_targets:
        bpr = 25 if path.lower().endswith((".bam", ".gz", ".bgzf")) else 100
        try:
            est_targets = os.path.getsize(path) // bpr + 1
        except OSError:
            est_targets = 0
        cap = max(cap, -(-est_targets // 56))
    n_s = -(-cap // 2048) * 2048
    grid = _grid(device, None,
                 lambda dev: device_tables(st, dense, options, dev))
    acc, kept = _pass_a_pieces(_v2_pieces(sr, n_s, st), grid, budget=None,
                               counter="overlap_pieces")
    path_counts["overlap_files"] += 1
    if not _stream_totals(st, sr, path):
        timer.lap()
        return st
    out = _core_after_pieces(grid, acc, kept, engine)
    return _finalize_state(st, out, dense, engine, options, timer)


@_request
def profile_file_streaming(options: ProfileOptions, db: SlimmDatabase,
                           path: str, *, device=None,
                           engine: EngineOptions | None = None,
                           chunk_targets: int | None = None,
                           sharded_runner=None) -> ProfileState:
    """Chunk-streaming profile of one SAM/BAM file (pipeline.py:1627-1826):
    the same result as profile_file, with the records on the device only
    up to `engine.stream_device_cache_bytes`.  v2 pieces while every
    contig's bins fit uint16, else v1 chunks.  Falls back to profile_file
    where the JAX package does: a file the stream reader cannot open,
    input that stops being qname-grouped partway, or one read's targets
    past a v2 piece; each cause is counted in `path_counts`.  With a
    `sharded_runner` the pieces are routed over its data shards and the
    bins split over its model shards; across processes a fall back raises
    instead (each process would profile its own input alone).  Without
    either, `device` is the card."""
    device = _device(device, sharded_runner)
    engine = engine or EngineOptions()
    st = _stream_file(options, db, path, device=device, engine=engine,
                      chunk_targets=(chunk_targets or engine.stream_chunk
                                     or (4 << 20)),
                      runner=sharded_runner)
    if st is None:
        st = profile_file(options, db, path, device=device, engine=engine,
                          sharded_runner=sharded_runner)
    return st


@_gives_way("stream")
def _stream_file(options: ProfileOptions, db: SlimmDatabase, path: str, *,
                 device, engine: EngineOptions, chunk_targets: int, runner
                 ) -> ProfileState | None:
    """profile_file_streaming's own path; None where it gives way."""
    timer = PhaseTimer(enabled=engine.phase_log)
    timer.start("Streaming alignment chunks ....................... ")
    sr = _open_stream(path, engine)
    avg = sr.avg_read_length
    if runner is not None:
        avg = runner.broadcast(avg)
    with span("init"):
        st, dense = _begin(options, db, sr.contig_names, sr.contig_lengths,
                           avg)
    grid = _grid(device, runner,
                 lambda dev: device_tables(st, dense, options, dev))
    if _v2_fits(st.lengths, options.bin_width):
        next_piece = _v2_pieces(sr, _bucket(chunk_targets, engine.batch_pad),
                                st)
        counter = "stream_chunks_v2"
    else:
        next_piece = _v1_pieces(sr, chunk_targets)
        counter = "stream_chunks_v1"
    acc, kept = _pass_a_pieces(next_piece, grid,
                               budget=engine.stream_device_cache_bytes,
                               counter=counter)
    path_counts["stream_files"] += 1
    hits = _stream_totals(st, sr, path, runner)
    timer.lap()
    if not hits:
        return st
    timer.start("Analysing alignments, reads and references ....... ")
    out = _core_after_pieces(grid, acc, kept, engine)
    timer.lap()
    t2 = PhaseTimer(enabled=engine.phase_log)
    t2.start("Filtering + LCA (fused above) ..................... ")
    return _finalize_state(st, out, dense, engine, options, t2)


# ---------------------------------------------------------------------------
# batched directory profiles (pipeline.py:1830-2000)
# ---------------------------------------------------------------------------
#
# The JAX package stacks a group of files into one lax.scan to pay the TPU
# link's round trip once per group.  Here the group's files are laid end to
# end as one profile (tables.group_tables): file k's contigs, bins and
# dense taxa are offset past the earlier files', and its reads keep to
# themselves, so one pass A, one cutoff sync and one pass B serve the group,
# each histogram one kernel launch, and every packed vector comes back in
# one fetch.  Every count stays per contig, per bin or per taxon of one
# file, so the result is each file's own.  The group-wide read ids, bins
# and record indices are int32, so a group whose sums would pass
# GROUP_LIMIT is cut into sub-groups first (plan_subgroups); the JAX
# package keeps each file's domain to itself and needs no such cut.

# The most that a group's summed read ids, bins or records may reach
GROUP_LIMIT = int(np.iinfo(np.int32).max)


def plan_subgroups(sizes) -> list:
    """Cut a group into runs of consecutive files to profile as one.
    sizes[k] = (reads, bins, records) of file k in group order; in every run
    each of the three sums stays at or below GROUP_LIMIT.  A file past the
    limit alone makes a run of its own.  Returns the runs as lists of
    file indices."""
    runs, run, total = [], [], (0, 0, 0)
    for k, size in enumerate(sizes):
        summed = tuple(a + int(b) for a, b in zip(total, size))
        if run and max(summed) > GROUP_LIMIT:
            runs.append(run)
            run, summed = [], tuple(int(b) for b in size)
        run.append(k)
        total = summed
    if run:
        runs.append(run)
    return runs


@_request
def profile_files_batched(options: ProfileOptions, db: SlimmDatabase,
                          paths: list, *, device=None,
                          engine: EngineOptions | None = None) -> list:
    """Profile a group of SAM/BAM files as one, on `device` (by default the
    card): [(path, ProfileState)] in path order.  Each file is decoded whole
    and gets its own copy of `options` (hence its own bin_width); a file
    with no hits keeps its state and is warned about.  Files whose headers
    differ are profiled one by one through profile_file
    (pipeline.py:1876-2000).  A group past GROUP_LIMIT is profiled in
    sub-groups (plan_subgroups), and a file past it alone through
    profile_file."""
    device = _device(device, None)
    engine = engine or EngineOptions()
    decoded = []
    with span("decode_wait"):
        for path in paths:
            af = open_alignment_file(path, engine)
            decoded.append((path, af, af.load()))
    names0 = list(decoded[0][1].contig_names)
    lengths0 = np.asarray(decoded[0][1].contig_lengths)
    same_ref = all(
        list(af.contig_names) == names0
        and np.array_equal(np.asarray(af.contig_lengths), lengths0)
        for _, af, _ in decoded[1:])
    if not same_ref:
        # profile_arrays sets options' defaults (bin_width, min_reads), so
        # each file gets its own copy
        path_counts["batched_fallback_per_file"] += 1
        return [(path, profile_file(copy.deepcopy(options), db, path,
                                    device=device, engine=engine))
                for path, _, _ in decoded]

    timer = PhaseTimer(enabled=engine.phase_log)
    timer.start("Intializing coverages for all reference genome ... ")
    with span("init"):
        dense = None
        preps, empties = [], []
        for path, af, batch in decoded:
            opts_k = copy.deepcopy(options)
            st, dense = _begin(opts_k, db, names0, lengths0,
                               batch.avg_read_length, dense)
            st.hits_count = batch.hits_count
            st.matches_count = batch.n_reads
            if batch.hits_count == 0:
                empties.append((path, st))
            else:
                preps.append((path, st, opts_k, batch))
    # from here each decoded batch is held in preps alone (a native file
    # holds its decoded records too, until it is let go)
    del decoded, af, batch
    timer.lap()

    results, grouped = {}, []
    if preps:
        timer.start("Analysing alignments, reads and references ....... ")
        with span("plan"):
            sizes = [_group_size(st, b) for _, st, _, b in preps]
            runs = plan_subgroups(sizes)
        for run in runs:
            if max(sizes[run[0]]) > GROUP_LIMIT:
                # alone past the limit: as one file is profiled, which
                # decodes it again, so its first decode is let go before
                path = preps[run[0]][0]
                preps[run[0]] = None
                results[path] = profile_file(copy.deepcopy(options), db, path,
                                             device=device, engine=engine)
                continue
            group = [preps[k] for k in run]
            grouped += zip(group, _profile_group(group, dense, device,
                                                 engine))
            path_counts["batched_groups"] += 1
        timer.lap()
    for path, st in empties:
        _warn_no_hits()
        results[path] = st
    for (path, st, opts_k, _), out in grouped:
        _finalize_state(st, out, dense, engine, opts_k,
                        PhaseTimer(enabled=False))
        results[path] = st
    return [(path, results[path]) for path in paths]


def _group_size(st, batch) -> tuple:
    """(reads, bins, records) that a file adds to a group's domains."""
    return (int(batch.read_id.max()) + 1, int(st.nbins.sum()),
            len(batch.read_id))


def _profile_group(preps, dense, device, engine) -> list:
    """One profile over the files of `preps` [(path, state, options, decoded
    batch)] laid end to end; each file's outputs as numpy arrays, fetched
    once for the group."""
    states = [st for _, st, _, _ in preps]
    batches = [b for _, _, _, b in preps]
    C = len(dense.lineage)
    with span("plan"):
        # the decoder's batches are deduped and grouped by read; one
        # segment plan, the longest read's, serves the group
        # (pipeline.py:1937-1945)
        k_steps, window = plan_from_max_run(max(
            b.max_targets or seg_plan(b.read_id)[0] for b in batches))
        # each file's read ids after the earlier files'
        sums = np.sum([_group_size(st, b) for st, b in zip(states, batches)],
                      axis=0, dtype=np.int64)
        if len(preps) > 1 and sums.max() > GROUP_LIMIT:
            raise OverflowError(f"(reads, bins, records) of a group of files "
                                f"{tuple(sums.tolist())} pass GROUP_LIMIT: "
                                "plan_subgroups cuts such a group first")
        reads = np.array([int(b.read_id.max()) + 1 for b in batches])
        read_id = np.concatenate([b.read_id + r for b, r in
                                  zip(batches, np.cumsum(reads) - reads)])
        rid = np.concatenate([np.asarray(b.rid) + k * C
                              for k, b in enumerate(batches)])
        pos = np.concatenate([b.pos for b in batches])
    grid = _grid(device, None, lambda dev: group_tables(
        states, [opts for _, _, opts, _ in preps], dense, dev))
    out = fused_profile_shards(grid, grid.shards(read_id, rid, pos),
                               dedup_window=0, k_steps=k_steps,
                               window=window,
                               emit_coverage=engine.fetch_coverage)
    with span("fetch"):
        packed = out["packed"].cpu().numpy().reshape(len(preps), -1)
        hists = {key: out[key].cpu().numpy() for key in
                 ("cov", "uniq_cov", "uniq_cov2") if engine.fetch_coverage}
    outs, lo = [], 0
    for k, st in enumerate(states):
        hi = lo + int(st.nbins.sum())
        outs.append(dict(packed=packed[k],
                         **{key: h[lo:hi] for key, h in hists.items()}))
        lo = hi
    return outs
