"""A plain NumPy reference of one SLIMM profile, written from SLIMM 0.3's
semantics (slimm.hpp, read_stat.hpp, reference_contig.hpp, misc.hpp) and
independent of the program: it imports nothing but NumPy.

`profile(...)` takes the raw alignment records of one sample (read id,
contig id, 0-based position; grouped by read or not: the first hit of a
(read, contig) pair is the one kept), the header's contigs, the database's
two maps and the profiler's options, and returns the `answer` that
`harness/compare.py` holds the program's result to: per-contig counters,
both coverage cutoffs, the validity mask, the second pass's counters, the
propagated taxon counts and children, the abundances and the report rows.

Record-level work is vectorised.  What runs per taxon or per contig (the
quantile walk, the propagation, the rows) is a loop over at most a few
thousand items, with float32 arithmetic in SLIMM's order.

`rnd` rounds every float result of the profile: the identity for float32,
the profile's stated precision; `to_bfloat16` gives the benchmark's control,
the same profile one precision below.
"""

from __future__ import annotations

import re

import numpy as np

f32 = np.float32
LINEAGE_LENGTH = 8
U32 = 0xFFFFFFFF

# rank levels: long name and one-letter prefix (misc.hpp:24-75)
RANKS = ["strain", "species", "genus", "family", "order", "class", "phylum",
         "superkingdom"]
SHORT = ["r", "s", "g", "f", "o", "c", "p", "k"]

_ACC_DELIM = re.compile(r"[ \t\r\n\v\f.|]")


def identity(x):
    return x


def to_bfloat16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32: the control's arithmetic."""
    a = np.asarray(x, np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32)
    return out if a.ndim else f32(out[()])


def accession(name: str) -> str:
    """First non-empty chunk of a sequence name split on whitespace, '.'
    or '|' (misc.hpp:415-422)."""
    for chunk in _ACC_DELIM.split(name):
        if chunk:
            return chunk
    return ""


def rank_of(rank: str) -> int:
    """The level of a rank name (misc.hpp:37-48); the report's ranks only."""
    if rank not in RANKS:
        raise ValueError(f"rank {rank!r}: the reference reports "
                         f"{', '.join(RANKS)}")
    return RANKS.index(rank)


def _seq_sum(values, rnd) -> np.float32:
    """Sequential float32 sum (a C++ float loop), rounded after each add."""
    total = f32(0.0)
    for v in np.asarray(values, np.float32).tolist():
        total = rnd(f32(total + f32(v)))
    return total


def _quantile_cut(values, q, rnd) -> np.float32:
    """SLIMM's mass quantile (misc.hpp:197-216): walk down from the largest
    value until the mass above reaches q of the total (summed in push
    order); return the value below the stop.  A zero total never stops."""
    vals = np.asarray(values, np.float32)
    if vals.size == 0:
        return f32(0.0)
    total = _seq_sum(vals, rnd)
    vals = np.sort(vals)
    above = f32(0.0)
    i = vals.size - 1
    with np.errstate(invalid="ignore", divide="ignore"):
        while i > 0 and rnd(f32(above / total)) < q:
            above = rnd(f32(above + vals[i]))
            i -= 1
    return f32(vals[i])


def _segments(keys):
    """Start index of each run of equal keys, and the run lengths."""
    if len(keys) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    return starts, np.diff(np.r_[starts, len(keys)])


def profile(read_id, rid, pos, *, contig_names, contig_lengths, ac__taxid,
            taxid__name, options, avg_read_length, rnd=identity) -> dict:
    """The answer of one profile; see the module's docstring.  `options`:
    bin_width, min_reads (0: SLIMM's automatic values), rank, cov_cut_off,
    abundance_cut_off."""
    names = dict(taxid__name)              # read-only copies of the maps
    lineage_of = {}
    accs = [accession(n) for n in contig_names]
    lineage = np.zeros((len(accs), LINEAGE_LENGTH), np.int64)
    for i, acc in enumerate(accs):
        lin = ac__taxid.get(acc)
        if lin is not None:
            lineage[i] = lin
        lineage_of[i] = lineage[i]
    C = len(accs)
    lengths = np.asarray(contig_lengths, np.int64)
    bw = int(options["bin_width"]) or int(avg_read_length)
    nbins = lengths // bw + 1
    offset = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int64)
    B = int(nbins.sum())

    # -- records -> first-hit targets (read_stat.hpp:116-135) ---------------
    read_id = np.asarray(read_id, np.int64)
    rid = np.asarray(rid, np.int64)
    pos = np.asarray(pos, np.int64)
    keep = rid >= 0
    read_id, rid, pos = read_id[keep], rid[keep], pos[keep]
    hits = int(len(rid))
    half = int(avg_read_length) // 2
    center = np.minimum((pos + half) & U32, lengths[rid])
    gbin = offset[rid] + center // bw
    _, first = np.unique(read_id * C + rid, return_index=True)
    order = np.lexsort((first, read_id[first]))  # by read, then first hit
    t = first[order]
    t_read, t_rid, t_bin = read_id[t], rid[t], gbin[t]
    starts, counts = _segments(t_read)
    n_reads = len(starts)
    per_target = np.repeat(counts, counts)
    uniq = per_target == 1

    # -- pass A: coverage, counters (slimm.hpp:191-303) --------------------
    cov = np.bincount(t_bin, minlength=B)
    ucov = np.bincount(t_bin[uniq], minlength=B)
    reads_count = np.bincount(t_rid, minlength=C).astype(np.int64)
    uniq_reads_count = np.bincount(t_rid[uniq], minlength=C).astype(np.int64)
    bounds = np.r_[offset, B]

    def nonzero_per_contig(h):
        cz = np.concatenate([[0], np.cumsum(h > 0)])
        return cz[bounds[1:]] - cz[bounds[:-1]]

    nz_cov = nonzero_per_contig(cov)
    nz_uniq = nonzero_per_contig(ucov)
    uniq_matches = int((counts == 1).sum())

    # -- abundances (slimm.hpp:259-302) -------------------------------------
    len_f = lengths.astype(np.float32)

    def abundance(cnt, total_hits):
        active = cnt > 0
        ab = np.zeros(C, np.float32)
        ab[active] = rnd(((cnt[active] * 100) & U32).astype(np.float32)
                         / f32(total_hits))
        with np.errstate(invalid="ignore", divide="ignore"):
            per_len = rnd(np.where(active, ab / len_f, f32(0.0))
                          .astype(np.float32))
            tot = _seq_sum(per_len, rnd)
            out = rnd(np.where(active, rnd(ab * f32(100.0))
                               / rnd(tot * len_f), f32(0.0))
                      .astype(np.float32))
        return out

    ab = abundance(reads_count, hits)
    uab = abundance(uniq_reads_count, uniq_matches)
    active = reads_count > 0
    reference_count = int(active.sum())
    matched_ref_length = int(lengths[active].sum()) & U32
    min_reads = int(options["min_reads"]) or 1 + (n_reads - 1) // 10000

    # -- cutoffs and validity (slimm.hpp:328-378) ---------------------------
    covp = rnd(nz_cov.astype(np.float32) / nbins.astype(np.float32))
    ucovp = rnd(nz_uniq.astype(np.float32) / nbins.astype(np.float32))
    q = options["cov_cut_off"]
    cc = ucc = f32(0.0)
    if q < 1.0:
        sel = uniq_reads_count > 0
        cc = _quantile_cut(covp[sel], q, rnd)
        ucc = _quantile_cut(ucovp[sel], q, rnd)
    valid = active & (covp >= cc) & (ucovp >= ucc)
    rejected = active & ~valid
    failed = (int((rejected & (covp < cc)).sum()),
              int((rejected & (ucovp < ucc)).sum()),
              int((rejected & (reads_count < min_reads)).sum()))

    # -- pass B: valid targets, unique-again reads, LCA (slimm.hpp:351-557) -
    ok = valid[t_rid]
    b_read, b_rid = t_read[ok], t_rid[ok]
    b_starts, b_counts = _segments(b_read)
    b_per = np.repeat(b_counts, b_counts)
    u2 = np.bincount(b_rid[b_per == 1], minlength=C).astype(np.int64)
    uniq_matches2 = int((b_counts == 1).sum())
    m_seg = b_counts > 1
    lca_count, children = {}, {}
    if m_seg.any():
        mc = b_counts[m_seg]
        lin = lineage[b_rid]                                 # (targets, 8)
        lo = np.minimum.reduceat(lin, b_starts, axis=0)[m_seg]
        hi = np.maximum.reduceat(lin, b_starts, axis=0)[m_seg]
        max_rid = np.maximum.reduceat(b_rid, b_starts)[m_seg]
        agree = lo == hi
        # first level where the read's targets agree, else the last level;
        # the taxon is the largest contig id's (std::set order)
        level = np.where(agree.any(1), agree.argmax(1), LINEAGE_LENGTH - 1)
        lca = lineage[max_rid, level]
        taxa, n = np.unique(lca, return_counts=True)
        lca_count = dict(zip(taxa.tolist(), n.tolist()))
        # (lca, contig) pairs of every valid target of a multi read
        pair = np.unique(np.repeat(lca, mc) * C
                         + b_rid[np.repeat(m_seg, b_counts)])
        p_lca, p_rid = pair // C, pair % C
        taxa, first_pair = np.unique(p_lca, return_index=True)
        for tid, part in zip(taxa.tolist(), np.split(p_rid, first_pair[1:])):
            children[tid] = set(part.tolist())

    # -- propagation to the ancestors (slimm.hpp:559-610) -------------------
    def rank_of_taxon(tid):
        return names.setdefault(tid, (0, ""))[0]

    counts_p = dict(lca_count)
    for tid in sorted(lca_count):
        ch = children[tid]
        lin = lineage_of[min(ch)]
        ref_ids = set(ch)
        for j in range(rank_of_taxon(tid) + 1, LINEAGE_LENGTH):
            r = int(lin[j])
            counts_p[r] = counts_p.get(r, 0) + lca_count[tid]
            children.setdefault(r, set()).update(ref_ids)
    for i in np.flatnonzero(u2 > 0).tolist():
        lin = lineage_of[i]
        ref_ids = set(children.setdefault(int(lin[0]), set()))
        for j in range(1, LINEAGE_LENGTH):
            r = int(lin[j])
            counts_p[r] = counts_p.get(r, 0) + int(u2[i])
            ch = children.setdefault(r, set())
            ch.add(i)
            ch.update(ref_ids)

    rows = _rows(counts_p, children, names, lineage_of, lengths, options,
                 n_reads, int(avg_read_length), cc, rnd)
    return dict(
        hits=hits, matches=n_reads, uniq_matches=uniq_matches,
        avg_read_length=int(avg_read_length), bin_width=bw,
        reads_count=reads_count, uniq_reads_count=uniq_reads_count,
        nz_cov=nz_cov.astype(np.int64), nz_uniq=nz_uniq.astype(np.int64),
        cc=f32(cc), ucc=f32(ucc), valid=np.flatnonzero(valid),
        failed=failed, u2=u2, uniq_matches2=uniq_matches2,
        counts=counts_p,
        children={k: tuple(sorted(v)) for k, v in children.items()},
        abundance=ab, uniq_abundance=uab, reference_count=reference_count,
        matched_ref_length=matched_ref_length, min_reads=min_reads,
        rows=rows,
        work=dict(records=int(len(read_id)), bins=B, contigs=C,
                  dense_taxa=len(np.unique(np.r_[lineage.ravel(), 0])),
                  pair_codes=LINEAGE_LENGTH
                  + len(np.unique(lineage[:, LINEAGE_LENGTH - 1]))))


def _fmt(v) -> str:
    """C++ default stream formatting of a float: 6 significant digits."""
    return "%.6g" % float(f32(v))


def _lineage_string(rank, lin, names):
    parts = []
    for i in range(LINEAGE_LENGTH - 1, rank - 1, -1):
        name = names.setdefault(int(lin[i]), (0, ""))[1] or \
            "unknown_" + RANKS[i]
        parts.append(SHORT[i] + "__" + name)
    return "|".join(parts)


def _rows(counts, children, names, lineage_of, lengths, options, matches,
          avg, cc, rnd):
    """The profile TSV's rows (slimm.hpp:733-843) in taxid order: the
    rank's taxa over the cutoffs, then each parent's unclassified rest, then
    the catch-all row."""
    rank = rank_of(options["rank"])
    parent = LINEAGE_LENGTH - 1 if rank == LINEAGE_LENGTH - 1 else rank + 1
    cut = f32(options["abundance_cut_off"])
    zero_lin = np.zeros(LINEAGE_LENGTH, np.int64)

    def share(count):
        return rnd(f32(rnd(f32(count) / f32(matches)) * f32(100)))

    def taxon_lineage(tid):
        return zero_lin if tid == 0 else lineage_of[min(children[tid])]

    parent_ab, parent_reads = {}, {}
    for tid, count in counts.items():
        if names.setdefault(tid, (0, ""))[0] == parent:
            parent_ab[tid] = share(count)
            parent_reads[tid] = count
    rows = []
    sum_reads, sum_ab = 0, f32(0.0)
    ab_by_parent, reads_by_parent = {}, {}
    for tid in sorted(counts):
        count = counts[tid]
        if names.setdefault(tid, (0, ""))[0] != rank:
            continue
        ch = sorted(children[tid])
        genome_length = int(lengths[ch].sum()) // len(ch)
        lin = lineage_of[ch[-1]]
        cov = rnd(f32(f32((count * avg) & U32) / f32(genome_length)))
        ab = share(count)
        p = int(lin[parent])
        ab_by_parent[p] = rnd(f32(ab_by_parent.get(p, f32(0.0)) + ab))
        reads_by_parent[p] = reads_by_parent.get(p, 0) + count
        name = names[tid][1]
        if ab < cut or cov < cc or name == "":
            continue
        rows.append((RANKS[rank], str(tid),
                     _lineage_string(rank, taxon_lineage(tid), names),
                     _fmt(ab), str(count)))
        sum_ab = rnd(f32(sum_ab + ab))
        sum_reads += count
    for p in sorted(ab_by_parent):
        rest = rnd(f32(parent_ab.get(p, f32(0.0)) - ab_by_parent[p]))
        rest_reads = (parent_reads.get(p, 0) - reads_by_parent[p]) & U32
        name = names.setdefault(p, (0, ""))[1] + "_unclassified"
        if rest > cut and name != "_unclassified":
            rows.append((RANKS[rank], f"{p}*",
                         _lineage_string(parent, taxon_lineage(p), names)
                         + "|" + SHORT[rank] + "__" + name,
                         _fmt(rest), str(rest_reads)))
            sum_reads += rest_reads
            sum_ab = rnd(f32(sum_ab + rest))
    rows.append((RANKS[rank], "0*", _lineage_string(rank, zero_lin, names),
                 _fmt(rnd(f32(f32(100.0) - sum_ab))),
                 str((matches - sum_reads) & U32)))
    return ["\t".join(r) for r in rows]
