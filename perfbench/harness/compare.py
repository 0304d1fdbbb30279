"""What a run compares: the program's answer for one sample against the
reference's (reference/slimm.py), field by field, exactly.

Every field is an integer count or a float32 computed in SLIMM's order, so
each number compared is a count of fields that differ, and every limit is 0
(an exact comparison).  The fields fall into the layers they come from:

  pass_a    records, reads, unique reads; per contig: reads, unique reads,
            non-zero bins of cov and uniq_cov; the read length and bin width
  cutoffs   both coverage cutoffs (bits), the validity mask, the counts of
            contigs that failed each cutoff and min-reads
  pass_b    per-contig unique-again reads, unique-again read total
  taxa      the taxon read counts and children sets after propagation (the
            state keeps the LCA counts and pairs only in propagated form)
  finalize  both abundance vectors (bits), reference count, matched
            length, min-reads

A file cell also holds each TSV it wrote to the reference's rows, line by
line (`differ`): the number `tsv`.
"""

from __future__ import annotations

import numpy as np

GROUPS = {
    "pass_a": ("hits", "matches", "uniq_matches", "avg_read_length",
               "bin_width", "reads_count", "uniq_reads_count", "nz_cov",
               "nz_uniq"),
    "cutoffs": ("cc", "ucc", "valid", "failed"),
    "pass_b": ("u2", "uniq_matches2"),
    "taxa": ("counts", "children"),
    "finalize": ("abundance", "uniq_abundance", "reference_count",
                 "matched_ref_length", "min_reads"),
}


def answer_of_state(st) -> dict:
    """The fields of a ProfileState that the reference also computes."""
    return dict(
        hits=st.hits_count, matches=st.matches_count,
        uniq_matches=st.uniq_matches_count,
        avg_read_length=st.avg_read_length, bin_width=st.options.bin_width,
        reads_count=np.asarray(st.reads_count),
        uniq_reads_count=np.asarray(st.uniq_reads_count),
        nz_cov=np.asarray(st.nonzero_bins("cov")),
        nz_uniq=np.asarray(st.nonzero_bins("uniq_cov")),
        cc=np.float32(st.coverage_cut_off()),
        ucc=np.float32(st.uniq_coverage_cut_off()),
        valid=np.array(sorted(st.valid_ref_ids), np.int64),
        failed=(st.failed_byCov, st.failed_byUniqCov, st.failed_by_min_read),
        u2=np.asarray(st.uniq_reads_count2),
        uniq_matches2=st.uniq_matches_count2,
        counts=dict(st.taxon_id__read_count),
        children={k: tuple(sorted(np.asarray(list(v)).tolist()))
                  for k, v in st.taxon_id__children.items()},
        abundance=np.asarray(st.abundance, np.float32),
        uniq_abundance=np.asarray(st.uniq_abundance, np.float32),
        reference_count=st.reference_count,
        matched_ref_length=st.matched_ref_length,
        min_reads=st.options.min_reads)


def differ(a, b) -> int:
    """How many elements of one field differ (floats by their bits)."""
    if isinstance(a, dict):
        keys = set(a) | set(b)
        return sum(1 for k in keys if k not in a or k not in b or a[k] != b[k])
    if isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        n = max(len(a), len(b))
        return sum(1 for i in range(n)
                   if i >= len(a) or i >= len(b) or a[i] != b[i])
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), np.asarray(b, np.float32).view(np.uint32)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def compare(got: dict, want: dict) -> dict:
    """Fields that differ, per group."""
    return {group: sum(differ(got[f], want[f]) for f in fields)
            for group, fields in GROUPS.items()}
