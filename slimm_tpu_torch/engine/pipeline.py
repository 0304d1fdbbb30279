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
(window > 0) or doubling scans (window == 0), as in the JAX package.  The
TPU-only transfer formats, padding buckets and one-hot matmul gathers are
not ported: tables are read with plain index gathers.  `pipeline.py:N`
below refers to slimm_tpu/engine/pipeline.py.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.database import SlimmDatabase, tensorize
from slimm_tpu.state import ProfileState, quantile_cut_off
from slimm_tpu.utils.timer import PhaseTimer

from ..ops.hist import hist1, hist2
from ..tables import DeviceTables, device_tables

# Widest shift window for device dedup and segment reductions; reads with
# more records take the doubling scans (and host dedup).
MAX_WINDOW = 4

# packed layout: 6 rows of n_contigs + 8 scalars + n_dense taxon counts +
# the bitpacked pair presence
_N_SCALARS = 8

# index of the lowest set bit of an 8-bit mask, 7 for the empty mask: the
# first lineage level on which all of a read's targets agree
_FIRST_LEVEL = np.array([7] + [(z & -z).bit_length() - 1 for z in range(1, 256)],
                        np.int32)


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


def _pass_a_local(read_id, rid, pos, t: DeviceTables, *, dedup_window,
                  k_steps, window):
    """Grouped records -> dedup mask, global bins, uniqueness, coverage."""
    valid = read_id >= 0
    rid_c = rid.clamp(0, t.n_contigs - 1)
    # center-position binning with uint32 wrap (slimm.hpp:200-201), in
    # int64: torch has no uint32 add or minimum on the CPU
    u32 = 0xFFFFFFFF
    center = torch.minimum(((pos.to(torch.int64) & u32) + t.half) & u32,
                           t.lengths[rid_c])
    local_bin = (center // t.bin_width).to(torch.int32)
    t_gbin = t.bin_offset[rid_c] + local_bin

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
    cov, uniq_cov = hist2(t_gbin, nondup, t_uniq, t.n_bins)
    return dict(t_gbin=t_gbin, nondup=nondup, cov=cov, uniq_cov=uniq_cov,
                uniq_matches=uniq_matches)


# ---------------------------------------------------------------------------
# per-contig counters and cutoffs (pipeline.py:698-724)
# ---------------------------------------------------------------------------


def _contig_sums_nz(values, t: DeviceTables):
    """(per-contig sums, per-contig nonzero-bin counts) over the flat bin
    axis, from exact int64 prefix sums at the contig boundaries."""
    starts = t.bin_offset.to(torch.int64)
    ends = t.bin_ends.to(torch.int64)
    zero = values.new_zeros(1, dtype=torch.int64)
    cs = torch.cat([zero, torch.cumsum(values, 0, dtype=torch.int64)])
    cz = torch.cat([zero, torch.cumsum(values > 0, 0, dtype=torch.int64)])
    return ((cs[ends] - cs[starts]).to(torch.int32),
            (cz[ends] - cz[starts]).to(torch.int32))


def _cutoffs(rc, nzc, urc, nzu, t: DeviceTables):
    """Coverage-quantile cutoffs and the validity mask, on the host.

    The JAX package scans float32 sums in contig order on the device; a CUDA
    reduction keeps no order, so the four per-contig counters come to the
    host and the oracle's own exact `quantile_cut_off` runs there.
    Returns (cc, ucc) as float32 and the validity mask on the device."""
    rc_h, nzc_h, urc_h, nzu_h = (x.cpu().numpy() for x in (rc, nzc, urc, nzu))
    covp = nzc_h.astype(np.float32) / t.nbins
    ucovp = nzu_h.astype(np.float32) / t.nbins
    sel = urc_h > 0
    if t.q < np.float32(1.0):
        cc = quantile_cut_off(covp[sel], t.q)
        ucc = quantile_cut_off(ucovp[sel], t.q)
    else:
        cc = ucc = np.float32(0.0)
    valid = (rc_h > 0) & (covp >= cc) & (ucovp >= ucc)
    return np.float32(cc), np.float32(ucc), torch.from_numpy(valid).to(rc.device)


# ---------------------------------------------------------------------------
# pass B (pipeline.py:485-628)
# ---------------------------------------------------------------------------


def _pass_b_local(read_id, rid, t_gbin, nondup, valid_mask, t: DeviceTables,
                  *, k_steps, window, emit_coverage):
    """Filtered re-dedup + vectorised LCA (slimm.hpp:351-392, 516-557)."""
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
    first_level = torch.from_numpy(_FIRST_LEVEL).to(z.device)[z.long()]
    # lineage[max rid][first agreeing level, or 7] (slimm.hpp:516-531)
    lca_end = t.lineage.view(-1)[rid_mx_c * 8 + first_level]
    lca_clip = lca_end.clamp(0, t.n_dense - 1)

    out = {}
    if emit_coverage:
        # one fused histogram: [0, B) uniq_cov2, [B, B + n_dense) LCA counts
        B = t.n_bins
        idx = torch.where(t_u2, t_gbin, B + lca_clip)
        combined = hist1(idx, t_u2 | multi_end, B + t.n_dense)
        out["uniq_cov2"] = combined[:B]
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
    # the domain is padded to 1024 as in the JAX layout: the packed vector
    # carries pdom / 32 presence words
    pdom = -(-(C * t.n_codes) // 1024) * 1024
    pidx = rid_c * t.n_codes + code_b.clamp(0, t.n_codes - 1)
    out["pair_levels"] = hist1(pidx, t_multi, pdom) > 0
    out["uniq_matches2"] = _count(end_mask & (cnt == 1))
    return out


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


def fused_profile(read_id, rid, pos, t: DeviceTables, *, dedup_window,
                  k_steps, window, emit_coverage=True):
    """The whole per-file profile on the device of the record tensors.

    Returns dict with `packed` (int32[6*C + 8 + n_dense + pair words]:
    reads_count, uniq_reads_count, nz_cov, nz_uniq, uniq_reads_count2,
    valid_mask, scalars [uniq_matches, uniq_matches2, cc<bitcast>,
    ucc<bitcast>, 0, 0, 0, 0], taxon_counts, bitpacked pair presence) and,
    when emit_coverage, the cov / uniq_cov / uniq_cov2 histograms
    (int32[n_bins]) that the -ro/-co reports need."""
    a = _pass_a_local(read_id, rid, pos, t, dedup_window=dedup_window,
                      k_steps=k_steps, window=window)
    rc, nzc = _contig_sums_nz(a["cov"], t)
    urc, nzu = _contig_sums_nz(a["uniq_cov"], t)
    cc, ucc, valid_mask = _cutoffs(rc, nzc, urc, nzu, t)

    b = _pass_b_local(read_id, rid, a["t_gbin"], a["nondup"], valid_mask, t,
                      k_steps=k_steps, window=window,
                      emit_coverage=emit_coverage)
    if emit_coverage:
        u2, _ = _contig_sums_nz(b["uniq_cov2"], t)
    else:
        u2 = b["u2_counts"]
    cuts = torch.from_numpy(np.array([cc, ucc], np.float32).view(np.int32))
    scalars = torch.cat([torch.stack([a["uniq_matches"], b["uniq_matches2"]]),
                         cuts.to(rc.device),
                         rc.new_zeros(_N_SCALARS - 4)])
    packed = torch.cat([rc, urc, nzc, nzu, u2, valid_mask.to(torch.int32),
                        scalars, b["taxon_counts"],
                        _pack_bits_words(b["pair_levels"])])
    out = dict(packed=packed)
    if emit_coverage:
        out.update(cov=a["cov"], uniq_cov=a["uniq_cov"],
                   uniq_cov2=b["uniq_cov2"])
    return out


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


# ---------------------------------------------------------------------------
# host orchestration (pipeline.py:1035-1296)
# ---------------------------------------------------------------------------


def profile_arrays(options: ProfileOptions, db: SlimmDatabase,
                   contig_names, contig_lengths,
                   read_id, rid, pos, n_reads: int, hits_count: int,
                   avg_read_length: int, *, device,
                   engine: EngineOptions | None = None,
                   deduped: bool = True, max_targets: int = 0) -> ProfileState:
    """Profile decoded record arrays on `device`.

    read_id/rid/pos: with deduped=True (decoder contract) one entry per
    distinct (read, contig) with the first hit's position, grouped by read;
    with deduped=False raw multi-hit records in any order.  Fills the same
    ProfileState as the scalar oracle."""
    engine = engine or EngineOptions()
    timer = PhaseTimer(enabled=engine.phase_log)
    st = ProfileState(options=options, ac__taxid=db.ac__taxid,
                      taxid__name=db.taxid__name)
    st.avg_read_length = avg_read_length
    if options.bin_width == 0:
        options.bin_width = avg_read_length

    timer.start("Intializing coverages for all reference genome ... ")
    st.init_contigs(contig_names, contig_lengths, options.bin_width)
    dense = tensorize(db, contig_names)
    timer.lap()

    st.hits_count = hits_count
    if hits_count == 0:
        print("[WARNING] No mapped reads found in BAM file!", file=sys.stderr)
        return st
    st.matches_count = n_reads

    timer.start("Analysing alignments, reads and references ....... ")
    read_id, rid, pos, dedup_window, k_steps, window = plan_records(
        read_id, rid, pos, len(st.accessions), deduped=deduped,
        max_targets=max_targets)
    tables = device_tables(st, dense, options, device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    out = fused_profile(dev(read_id), dev(rid), dev(pos), tables,
                        dedup_window=dedup_window, k_steps=k_steps,
                        window=window, emit_coverage=engine.fetch_coverage)
    _finalize_state(st, out, dense, engine, options, timer)
    return st


def _finalize_state(st, out, dense, engine, options, timer):
    """Fill a ProfileState from the fused profile's outputs (pipeline.py
    1167-1250, without the streamed pair-bits branch)."""
    n_contigs = len(st.accessions)
    packed_np = out["packed"].cpu().numpy()
    stats = unpack_stats(packed_np, n_contigs, dense.n_dense)
    st.reads_count = stats["reads_count"].astype(np.int64)
    st.uniq_reads_count = stats["uniq_reads_count"].astype(np.int64)
    st._nz_cache["cov"] = stats["nz_cov"].astype(np.int64)
    st._nz_cache["uniq_cov"] = stats["nz_uniq"].astype(np.int64)
    st.uniq_matches_count = stats["uniq_matches"]
    st.uniq_hits_count = st.uniq_matches_count  # identical by construction
    if engine.fetch_coverage:
        st.cov = out["cov"].cpu().numpy().astype(np.uint32)
        st.uniq_cov = out["uniq_cov"].cpu().numpy().astype(np.uint32)
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
        st.uniq_cov2 = out["uniq_cov2"].cpu().numpy().astype(np.uint32)
    st.uniq_matches_count2 = stats["uniq_matches2"]

    # dense LCA counts + children pairs -> taxid dicts
    counts = stats["taxon_counts"]
    for d in np.flatnonzero(counts > 0).tolist():
        tid = int(dense.dense_to_tid[d])
        st.taxon_id__read_count[tid] = (
            st.taxon_id__read_count.get(tid, 0) + int(counts[d]))
    base = 6 * n_contigs + _N_SCALARS + dense.n_dense
    # bitpacked (contig x level-code) presence in the packed tail: code < 8
    # is the read's first agreeing lineage level L (the lca is lineage[r][L]),
    # code 8 + k means no level agreed (the lca is the k-th superkingdom id)
    pbytes = np.ascontiguousarray(packed_np[base:]).view(np.uint8)
    n_codes = dense.n_pair_codes
    pres = np.unpackbits(pbytes, bitorder="little")
    nz = np.flatnonzero(pres[:n_contigs * n_codes])
    r = (nz // n_codes).astype(np.int64)
    code = (nz % n_codes).astype(np.int64)
    lvl = code < 8
    lca_d = np.where(lvl, dense.lineage[r, np.minimum(code, 7)],
                     dense.sk_dense[np.maximum(code, 8) - 8]
                     if len(dense.sk_dense) else 0)
    pairs = np.unique(np.stack([lca_d, r], axis=1), axis=0)
    # grouped set fills: pairs is sorted, so one slice per distinct LCA
    d_vals, starts = np.unique(pairs[:, 0], return_index=True)
    bounds = np.append(starts, len(pairs))
    tids = dense.dense_to_tid[d_vals]
    col = pairs[:, 1]
    for i, tid in enumerate(tids.tolist()):
        st.taxon_id__children.setdefault(int(tid), set()).update(
            col[starts[i]:bounds[i + 1]].tolist())

    st.propagate_counts()
    timer.lap()
    return st


# copied from slimm_tpu/engine/pipeline.py:1253-1263
def open_alignment_file(path: str, engine: EngineOptions | None = None):
    """Native C++ decoder when built (slimm_tpu/io/native.py), else the
    pure-Python reference decoder — identical array contract."""
    engine = engine or EngineOptions()
    if engine.use_native:
        from slimm_tpu.io import native
        if native.available():
            return native.NativeAlignmentFile(
                path, hash_names=engine.hash_read_names)
    from slimm_tpu.io import AlignmentFile
    return AlignmentFile(path)


def profile_file(options: ProfileOptions, db: SlimmDatabase, path: str, *,
                 device, engine: EngineOptions | None = None) -> ProfileState:
    """Decode one SAM/BAM file whole and profile it on `device`."""
    af = open_alignment_file(path, engine)
    batch = af.load()
    return profile_arrays(
        options, db, af.contig_names, af.contig_lengths,
        batch.read_id.astype(np.int32), batch.rid, batch.pos,
        batch.n_reads, batch.hits_count, batch.avg_read_length,
        device=device, engine=engine, max_targets=batch.max_targets)
