# Copied from slimm_tpu/oracle.py (the port imports nothing of slimm_tpu).
"""Scalar reference oracle.

A faithful, from-scratch scalar reimplementation of the reference profiler's
exact semantics (reference: src/slimm.hpp, src/read_stat.hpp,
src/reference_contig.hpp, src/misc.hpp), used to generate golden fixtures and
to verify the TPU engine.  It fills the same ProfileState the engine fills,
so propagation and report generation (slimm_tpu.state) are shared by
construction.

Replicated quirks (each unit-tested in tests/):
  * first-hit-wins per (read, contig): the reference's add_target loop
    iterates by value (read_stat.hpp:125), so a 2nd alignment of a read to
    the same contig is dropped — every target holds exactly one bin.
  * mass-quantile cutoff semantics incl. the element-below-stop-index return
    and the NaN total guard (misc.hpp:197-216).
  * LCA "last inserted wins": the returned taxid at the first level where the
    per-read taxid set is a singleton is the lineage value of the largest
    contig id (std::set iterates ascending; slimm.hpp:516-531).  If no level
    agrees the value is lineage[max_rid][7].
  * float arithmetic in float32 with the reference's accumulation order.
  * uint32 wraparound for the catch-all row's read count (slimm.hpp:835).

Documented divergences (shared with the engine, see state.py):
  * canonical sorted row order instead of unordered_map iteration order;
  * rank == "superkingdom" uses parent_rank == superkingdom (the reference
    reads considered_ranks[1] out of bounds, slimm.hpp:739).
"""

from __future__ import annotations

from .config import ProfileOptions
from .state import ProfileState
from .taxonomy import LINEAGE_LENGTH

FLAG_UNMAPPED = 0x4
FLAG_FIRST = 0x40
FLAG_LAST = 0x80


def average_read_length(records, sample_size: int = 100000) -> int:
    """Mean length of the first <=100k records with nonempty seq, integer
    division (misc.hpp:509-522)."""
    count = total = 0
    for _, _, _, _, seq_len in records:
        if count >= sample_size:
            break
        if seq_len == 0:
            continue
        total += seq_len
        count += 1
    if count == 0:
        raise ZeroDivisionError("no records with sequences (misc.hpp:521)")
    return total // count


class OracleProfiler:
    """Scalar end-to-end profile of one file (get_profiles, slimm.hpp:395-496)."""

    def __init__(self, options: ProfileOptions, ac__taxid: dict,
                 taxid__name: dict, contigs):
        self.options = options
        self.state = ProfileState(options=options, ac__taxid=ac__taxid,
                                  taxid__name=taxid__name)
        self.contigs = list(contigs)  # [(sequence_name, length)]
        self.reads: dict[str, list] = {}  # read key → [(rid, bin)] targets

    def run(self, records):
        """records: iterable of (qname, flag, rid, pos, seq_len); rid < 0
        encodes an invalid reference id; pos is 0-based."""
        st = self.state
        st.avg_read_length = average_read_length(records)
        if self.options.bin_width == 0:
            self.options.bin_width = st.avg_read_length
        st.init_contigs([n for n, _ in self.contigs],
                        [l for _, l in self.contigs], self.options.bin_width)
        self.analyze_alignments(records)
        if st.hits_count == 0:
            return st
        if self.options.min_reads == 0:
            self.options.min_reads = 1 + (st.matches_count - 1) // 10000
        self.filter_alignments()
        self.get_reads_lca_count()
        return st

    def analyze_alignments(self, records):
        # HOT LOOP 1 (slimm.hpp:191-303)
        st = self.state
        half = st.avg_read_length // 2
        w = self.options.bin_width
        for qname, flag, rid, pos, _ in records:
            if (flag & FLAG_UNMAPPED) or rid < 0:
                continue
            # int32 + uint32 wraps to uint32 in C++ (slimm.hpp:200)
            center = min((pos + half) & 0xFFFFFFFF, int(st.lengths[rid]))
            bin_no = center // w
            key = qname
            if flag & FLAG_FIRST:
                key = qname + ".1"
            elif flag & FLAG_LAST:
                key = qname + ".2"
            targets = self.reads.setdefault(key, [])
            # first-hit-wins per (read, contig) (read_stat.hpp:116-135)
            if all(t[0] != rid for t in targets):
                targets.append((rid, bin_no))
            st.hits_count += 1

        if st.hits_count == 0:
            return

        for targets in self.reads.values():
            if len(targets) == 1:
                rid, bin_no = targets[0]
                st.uniq_matches_count += 1
                st.reads_count[rid] += 1      # positions.size() is always 1
                st.cov[st.bin_offset[rid] + bin_no] += 1
                st.uniq_reads_count[rid] += 1
                st.uniq_hits_count += 1
                st.uniq_cov[st.bin_offset[rid] + bin_no] += 1
            else:
                for rid, bin_no in targets:
                    st.reads_count[rid] += 1
                    st.cov[st.bin_offset[rid] + bin_no] += 1
        st.matches_count = len(self.reads)
        st.compute_abundances()

    def filter_alignments(self):
        # (slimm.hpp:351-392)
        st = self.state
        st.compute_valid_refs()
        for key in self.reads:
            targets = [t for t in self.reads[key] if t[0] in st.valid_ref_ids]
            self.reads[key] = targets
            if len(targets) == 1:
                rid, bin_no = targets[0]
                st.uniq_reads_count2[rid] += 1
                st.uniq_matches_count2 += 1
                st.uniq_cov2[st.bin_offset[rid] + bin_no] += 1

    def get_lca(self, ref_ids) -> int:
        # level-wise lineage gather; last-inserted (max rid) wins
        # (slimm.hpp:516-531)
        st = self.state
        taxa_id = 1
        ordered = sorted(ref_ids)
        for level in range(LINEAGE_LENGTH):
            level_set = set()
            for rid in ordered:
                taxa_id = st.lineage_of_acc(st.accessions[rid])[level]
                level_set.add(taxa_id)
            if len(level_set) == 1:
                break
        return taxa_id

    def get_reads_lca_count(self):
        # HOT LOOP 2 (slimm.hpp:533-557) + shared propagation
        st = self.state
        for targets in self.reads.values():
            if len(targets) > 1:
                ref_ids = {rid for rid, _ in targets}
                lca = self.get_lca(ref_ids)
                st.taxon_id__read_count[lca] = (
                    st.taxon_id__read_count.get(lca, 0) + 1)
                st.taxon_id__children.setdefault(lca, set()).update(ref_ids)
        st.propagate_counts()
