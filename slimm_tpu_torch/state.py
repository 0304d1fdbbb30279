# Copied from slimm_tpu/state.py (the port imports nothing of slimm_tpu).
"""Shared per-file profile state + finalization (propagation, reports).

Both the scalar oracle (slimm_tpu.oracle) and the TPU engine
(slimm_tpu.engine) fill a ProfileState; everything downstream of the hot
loops — ancestor propagation, cutoffs, and the three report writers — lives
here once, so engine/oracle parity is structural.

Coverage state is kept FLAT: one global bin array indexed by
bin_offset[contig] + local_bin (the reference's per-contig ragged
vector<uint32> bins, reference_contig.hpp:67-95, re-laid-out for dense tensor
work).

Replicated reference quirks are documented in slimm_tpu.oracle's docstring.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .config import ProfileOptions
from .taxonomy import LINEAGE_LENGTH, considered_ranks, rank_name, rank_short
from .utils.timer import work_counts

f32 = np.float32


def fmt_float(v) -> str:
    """C++ default ostream float formatting: 6 significant digits, %g style."""
    return "%.6g" % float(f32(v))


def seq_sum_f32(values) -> np.float32:
    """Sequential float32 accumulation (C++ `float` loop order)."""
    arr = np.asarray(values, np.float32)
    if arr.size == 0:
        return f32(0.0)
    return np.cumsum(arr, dtype=np.float32)[-1]


def quantile_cut_off(values, q) -> np.float32:
    """Mass-quantile cutoff (reference misc.hpp:197-216).

    total accumulates in the *original push order* before sorting; the walk
    descends from the top until cumulative/total >= q and returns the element
    below the stop index.  A zero total yields NaN ratios whose comparison
    with q is false, so the loop never runs and the max element is returned.
    """
    vals = np.asarray(values, np.float32)
    if vals.size == 0:
        return f32(0.0)
    total = seq_sum_f32(vals)
    vals = np.sort(vals)
    sub_total = f32(0.0)
    i = vals.size - 1
    while i > 0:
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = f32(sub_total / total)
        if not (ratio < q):  # NaN-safe: NaN < q is False
            break
        sub_total = f32(sub_total + vals[i])
        i -= 1
    return f32(vals[i])


@dataclass
class ProfileState:
    """Everything the reports need for one input file (class slimm state,
    slimm.hpp:92-188, in dense-array form)."""

    options: ProfileOptions
    ac__taxid: dict                  # live DB maps (mutated like the reference)
    taxid__name: dict

    # contig tables
    accessions: list = field(default_factory=list)
    taxa_id: np.ndarray = None       # (n_contigs,) lineage[0] per contig
    lengths: np.ndarray = None       # (n_contigs,) int64
    nbins: np.ndarray = None         # (n_contigs,) = length // bin_width + 1
    bin_offset: np.ndarray = None    # (n_contigs,) exclusive prefix sum

    # flat coverage histograms (uint32, total_bins)
    cov: np.ndarray = None
    uniq_cov: np.ndarray = None
    uniq_cov2: np.ndarray = None

    # per-contig counters
    reads_count: np.ndarray = None
    uniq_reads_count: np.ndarray = None
    uniq_reads_count2: np.ndarray = None
    abundance: np.ndarray = None         # float32
    uniq_abundance: np.ndarray = None    # float32

    # scalars
    avg_read_length: int = 0
    hits_count: int = 0
    matches_count: int = 0
    uniq_matches_count: int = 0
    uniq_matches_count2: int = 0
    uniq_hits_count: int = 0
    reference_count: int = 0
    matched_ref_length: int = 0
    failed_by_min_read: int = 0
    failed_byCov: int = 0
    failed_byUniqCov: int = 0
    rank_row_count: int = 0      # rows emitted by the last abundance_rows
    rank_failed_count: int = 0   # rows dropped below cutoff (slimm.hpp:838)

    valid_ref_ids: set = field(default_factory=set)
    taxon_id__read_count: dict = field(default_factory=dict)
    taxon_id__children: dict = field(default_factory=dict)

    _coverage_cut_off: np.float32 = f32(0.0)
    _uniq_coverage_cut_off: np.float32 = f32(0.0)
    # device-computed per-contig nonzero-bin counts (engine fast path)
    _nz_cache: dict = field(default_factory=dict)

    # -- db access mirroring unordered_map::operator[] insert-on-miss ---------

    def name_of(self, taxid: int):
        entry = self.taxid__name.get(taxid)
        if entry is None:
            entry = (0, "")
            self.taxid__name[taxid] = entry
        return entry

    def lineage_of_acc(self, acc: str):
        lineage = self.ac__taxid.get(acc)
        if lineage is None:
            lineage = [0] * LINEAGE_LENGTH
            self.ac__taxid[acc] = lineage
        return lineage

    # -- derived per-contig stats ---------------------------------------------

    def init_contigs(self, contig_names, contig_lengths, bin_width: int):
        """Contig init + accession→taxid lookup (slimm.hpp:420-445)."""
        from .taxonomy import accession_id

        self.accessions = [accession_id(n) for n in contig_names]
        self.lengths = np.asarray(contig_lengths, np.int64)
        self.taxa_id = np.zeros(len(self.accessions), np.int64)
        for i, acc in enumerate(self.accessions):
            self.taxa_id[i] = self.lineage_of_acc(acc)[0]
        self.nbins = self.lengths // bin_width + 1
        self.bin_offset = np.concatenate([[0], np.cumsum(self.nbins)[:-1]])
        total = int(self.nbins.sum())
        self.cov = np.zeros(total, np.uint32)
        self.uniq_cov = np.zeros(total, np.uint32)
        self.uniq_cov2 = np.zeros(total, np.uint32)
        n = len(self.accessions)
        self.reads_count = np.zeros(n, np.int64)
        self.uniq_reads_count = np.zeros(n, np.int64)
        self.uniq_reads_count2 = np.zeros(n, np.int64)
        self.abundance = np.zeros(n, np.float32)
        self.uniq_abundance = np.zeros(n, np.float32)

    def bins(self, which: str, i: int) -> np.ndarray:
        arr = getattr(self, which)
        o = int(self.bin_offset[i])
        return arr[o:o + int(self.nbins[i])]

    def nonzero_bins(self, which: str) -> np.ndarray:
        """Per-contig count of nonzero bins."""
        cached = self._nz_cache.get(which)
        if cached is not None:
            return cached
        arr = getattr(self, which)
        csum = np.concatenate([[0], np.cumsum(arr > 0)])
        ends = self.bin_offset + self.nbins
        return csum[ends] - csum[self.bin_offset]

    def cov_percent(self, which: str = "cov") -> np.ndarray:
        """float32 nonzero/bins per contig (reference_contig.hpp:148-159)."""
        return (self.nonzero_bins(which).astype(np.float32)
                / self.nbins.astype(np.float32))

    def cov_depth(self, which: str, i: int) -> np.float32:
        """Sequential-float32 mean bin height; 0 if no nonzero bin
        (reference_contig.hpp:191-207)."""
        b = self.bins(which, i)
        if not (b > 0).any():
            return f32(0.0)
        return f32(seq_sum_f32(b) / len(b))

    # -- abundance normalization (slimm.hpp:259-302) ---------------------------

    def compute_abundances(self):
        active0 = self.reads_count > 0
        self.reference_count = int(active0.sum())
        self.matched_ref_length = int(self.lengths[active0].sum()) & 0xFFFFFFFF
        for counts, hits, out in (
                (self.reads_count, self.hits_count, self.abundance),
                (self.uniq_reads_count, self.uniq_hits_count, self.uniq_abundance)):
            active = counts > 0
            ab = np.zeros(len(counts), np.float32)
            ab[active] = (((counts[active] * 100) & 0xFFFFFFFF).astype(np.float32)
                          / f32(hits))
            with np.errstate(invalid="ignore", divide="ignore"):
                total_ab = seq_sum_f32(np.where(
                    active, ab / self.lengths.astype(np.float32), f32(0.0)))
                out[:] = np.where(
                    active,
                    (ab * f32(100.0)) / (total_ab * self.lengths.astype(np.float32)),
                    f32(0.0))

    # -- cutoffs (slimm.hpp:328-349, 672-688) ----------------------------------

    def coverage_cut_off(self) -> np.float32:
        if self._coverage_cut_off == 0.0 and self.options.cov_cut_off < 1.0:
            covs = self.cov_percent("cov")[self.uniq_reads_count > 0]
            self._coverage_cut_off = quantile_cut_off(covs, self.options.cov_cut_off)
        return self._coverage_cut_off

    def uniq_coverage_cut_off(self) -> np.float32:
        if self._uniq_coverage_cut_off == 0.0 and self.options.cov_cut_off < 1.0:
            covs = self.cov_percent("uniq_cov")[self.uniq_reads_count > 0]
            self._uniq_coverage_cut_off = quantile_cut_off(covs,
                                                           self.options.cov_cut_off)
        return self._uniq_coverage_cut_off

    def expected_coverage(self) -> np.float32:
        return f32(f32((self.avg_read_length * self.matches_count) & 0xFFFFFFFF)
                   / self.matched_ref_length)

    def compute_valid_refs(self):
        """Contig validity mask + failure counters (slimm.hpp:351-378)."""
        covp = self.cov_percent("cov")
        ucovp = self.cov_percent("uniq_cov")
        cc = self.coverage_cut_off()
        ucc = self.uniq_coverage_cut_off()
        active = self.reads_count > 0
        valid = active & (covp >= cc) & (ucovp >= ucc)
        self.valid_ref_ids = set(np.flatnonzero(valid).tolist())
        rejected = active & ~valid
        self.failed_byUniqCov += int((rejected & (ucovp < ucc)).sum())
        self.failed_by_min_read += int(
            (rejected & (self.reads_count < self.options.min_reads)).sum())
        self.failed_byCov += int((rejected & (covp < cc)).sum())
        return valid

    # -- ancestor propagation (slimm.hpp:559-610) ------------------------------

    #: LCA-taxid count past which propagate_counts routes to the native
    #: C++ implementation (same sequential semantics, children sets as
    #: bitsets — ~20x the Python loop at full-RefSeq cardinality).  The
    #: Python loop below stays the spec: tests (incl. the fuzz sweep) run
    #: under the threshold, and test_state locks native == Python parity
    #: on a large synthetic state.
    NATIVE_PROPAGATE_MIN = 4096

    def propagate_counts(self):
        """Runs after per-read LCA counts and children sets are in
        taxon_id__read_count / taxon_id__children.

        Pass 1: each LCA taxid's count is added to every ancestor along the
        lineage of its FIRST (min) child, from rank(taxid)+1 up to
        superkingdom, with children sets unioned upward.  Iteration is in
        sorted-key order (the reference's unordered order is
        implementation-defined; sums commute).

        Pass 2: each contig's uniq_reads_count2 is added to every ancestor
        (levels 1..7) of that contig's lineage.

        work_counts counts which of the two ran, the C++ or the loop,
        and the LCA taxa it started from.
        """
        work_counts["lca_taxa"] += len(self.taxon_id__read_count)
        if (len(self.taxon_id__read_count) >= self.NATIVE_PROPAGATE_MIN
                and self._propagate_native()):
            work_counts["native_propagations"] += 1
            return
        work_counts["python_propagations"] += 1
        snapshot = dict(self.taxon_id__read_count)
        for t_id in sorted(snapshot):
            count = snapshot[t_id]
            rnk = self.name_of(t_id)[0]
            children = self.taxon_id__children[t_id]
            first_child = min(children)
            lineage = self.lineage_of_acc(self.accessions[first_child])
            ref_ids = set(children)
            for j in range(rnk + 1, LINEAGE_LENGTH):
                receiver = lineage[j]
                self.taxon_id__read_count[receiver] = (
                    self.taxon_id__read_count.get(receiver, 0) + count)
                self.taxon_id__children.setdefault(receiver, set()).update(ref_ids)

        for i in np.flatnonzero(self.uniq_reads_count2 > 0).tolist():
            count2 = int(self.uniq_reads_count2[i])
            lineage = self.lineage_of_acc(self.accessions[i])
            ref_ids = set(self.taxon_id__children.setdefault(lineage[0], set()))
            for j in range(1, LINEAGE_LENGTH):
                receiver = lineage[j]
                self.taxon_id__read_count[receiver] = (
                    self.taxon_id__read_count.get(receiver, 0) + count2)
                ch = self.taxon_id__children.setdefault(receiver, set())
                ch.add(i)
                ch.update(ref_ids)

    def _propagate_native(self) -> bool:
        """Native C++ propagate_counts (stpu_propagate_run): exact
        sequential semantics of the loop above.  Returns False when the
        native library is absent or declines (the loop then runs — and
        raises — exactly as before)."""
        try:
            from .io import native
            if not native.available():
                return False
        except Exception:  # pragma: no cover - import environment issues
            return False
        n_contigs = len(self.accessions)
        # name_of per snapshot key first: replicates the pure loop's
        # insert-on-miss side effect on taxid__name and yields the ranks
        tax = np.fromiter(sorted(self.taxon_id__read_count), np.int64,
                          len(self.taxon_id__read_count))
        cnt = np.fromiter((self.taxon_id__read_count[int(t)] for t in tax),
                          np.int64, len(tax))
        rnk = np.fromiter((self.name_of(int(t))[0] for t in tax), np.int32,
                          len(tax))
        lineage = np.asarray(
            [self.lineage_of_acc(a) for a in self.accessions], np.int64
        ).reshape(n_contigs, LINEAGE_LENGTH)
        ch_items = list(self.taxon_id__children.items())
        ctax = np.fromiter((t for t, _ in ch_items), np.int64, len(ch_items))
        sizes = np.fromiter((len(s) for _, s in ch_items), np.int64,
                            len(ch_items))
        coff = np.zeros(len(ch_items) + 1, np.int64)
        np.cumsum(sizes, out=coff[1:])
        cch = np.empty(int(coff[-1]), np.int32)
        for i, (_, s) in enumerate(ch_items):
            cch[coff[i]:coff[i + 1]] = list(s)
        c2idx = np.flatnonzero(self.uniq_reads_count2 > 0).astype(np.int32)
        c2cnt = self.uniq_reads_count2[c2idx].astype(np.int64)
        res = native.propagate(n_contigs, lineage, tax, cnt, rnk, ctax,
                               coff, cch, c2idx, c2cnt)
        if res is None:
            return False
        out_tax, out_cnt, out_flags, out_choff, out_cch = res
        counts = {}
        children = {}
        choff_list = out_choff.tolist()
        cnt_list = out_cnt.tolist()
        flag_list = out_flags.tolist()
        # children become sorted int32 array views into the CSR payload —
        # materializing Python sets for ~10M total elements costs 10x the
        # propagation itself.  min()/iteration consumers handle both
        # representations (see _first_child / abundance_rows).
        for i, t in enumerate(out_tax.tolist()):
            f = flag_list[i]
            if f & 1:
                counts[t] = cnt_list[i]
            if f & 2:
                children[t] = out_cch[choff_list[i]:choff_list[i + 1]]
        self.taxon_id__read_count = counts
        self.taxon_id__children = children
        return True

    @staticmethod
    def _first_child(children) -> int:
        """min() over a children entry — a Python set (pure path) or a
        sorted int32 array (native propagate path)."""
        if isinstance(children, np.ndarray):
            return int(children[0])
        return min(children)

    # -- report rows -----------------------------------------------------------

    def lineage_string(self, rank: int, lineage) -> str:
        # (slimm.hpp:690-710)
        name = self.name_of(lineage[rank])[1]
        if name == "":
            name = "unknown_" + rank_name(rank)
        s = rank_short(rank) + "__" + name
        for i in range(rank + 1, LINEAGE_LENGTH):
            name = self.name_of(lineage[i])[1]
            if name == "":
                name = "unknown_" + rank_name(i)
            s = rank_short(i) + "__" + name + "|" + s
        return s

    def lineage_string_of_taxid(self, rank: int, taxa_id: int) -> str:
        # lineage from the FIRST (min) child's accession (slimm.hpp:712-730)
        if taxa_id == 0:
            lineage = [0] * LINEAGE_LENGTH
        else:
            first_child = self._first_child(self.taxon_id__children[taxa_id])
            lineage = self.lineage_of_acc(self.accessions[first_child])
        return self.lineage_string(rank, lineage)

    def abundance_rows(self):
        """Profile TSV rows (slimm.hpp:733-843), canonically ordered:
        main rows by taxid, then unclassified rows by parent taxid, then the
        catch-all row (the reference emits unordered_map order)."""
        cr = considered_ranks(self.options.rank)
        rank, parent_rank = cr[1], cr[0]

        parent_abundance = {}
        parent_reads_count = {}
        for t_id, count in self.taxon_id__read_count.items():
            if self.name_of(t_id)[0] == parent_rank:
                parent_abundance[t_id] = f32(f32(count) / self.matches_count * 100)
                parent_reads_count[t_id] = count

        rows = []
        sum_reads_count = 0
        sum_abundance = f32(0.0)
        sum_ab_by_parent = {}
        sum_reads_by_parent = {}
        emitted = 0      # `count` in the reference verbose line
        failed = 0       # `faild_count` (slimm.hpp:802, 838)

        for t_id in sorted(self.taxon_id__read_count):
            count = self.taxon_id__read_count[t_id]
            if self.name_of(t_id)[0] != rank:
                continue
            children = self.taxon_id__children[t_id]
            if isinstance(children, np.ndarray):
                ch = children
            else:
                ch = np.fromiter(children, np.int64, len(children))
            genome_length = int(self.lengths[ch].sum()) // len(ch)
            child_acc = self.accessions[int(ch.max())]  # LAST child (max id)
            lineage = self.lineage_of_acc(child_acc)
            cov = f32(f32((count * self.avg_read_length) & 0xFFFFFFFF)
                      / genome_length)
            abundance = f32(f32(count) / self.matches_count * 100)
            name = self.name_of(t_id)[1]
            parent_tax_id = lineage[parent_rank]
            sum_ab_by_parent[parent_tax_id] = f32(
                sum_ab_by_parent.get(parent_tax_id, f32(0.0)) + abundance)
            sum_reads_by_parent[parent_tax_id] = (
                sum_reads_by_parent.get(parent_tax_id, 0) + count)
            if (abundance < self.options.abundance_cut_off
                    or cov < self.coverage_cut_off() or name == ""):
                failed += 1
                continue
            rows.append((rank_name(rank), str(t_id),
                         self.lineage_string_of_taxid(rank, t_id),
                         fmt_float(abundance), str(count)))
            sum_abundance = f32(sum_abundance + abundance)
            sum_reads_count += count
            emitted += 1

        # unclassifieds with known parent (slimm.hpp:816-831)
        for parent in sorted(sum_ab_by_parent):
            uncl_ab = f32(parent_abundance.get(parent, f32(0.0))
                          - sum_ab_by_parent[parent])
            unc_reads = (parent_reads_count.get(parent, 0)
                         - sum_reads_by_parent[parent]) & 0xFFFFFFFF
            name = self.name_of(parent)[1] + "_unclassified"
            if uncl_ab > self.options.abundance_cut_off and name != "_unclassified":
                lineage_str = (self.lineage_string_of_taxid(parent_rank, parent)
                               + "|" + rank_short(rank) + "__" + name)
                rows.append((rank_name(rank), str(parent) + "*", lineage_str,
                             fmt_float(uncl_ab), str(unc_reads)))
                sum_reads_count += unc_reads
                sum_abundance = f32(sum_abundance + uncl_ab)

        # catch-all residual row (slimm.hpp:833-835); uint32 wrap preserved
        rows.append((rank_name(rank), "0*",
                     self.lineage_string_of_taxid(rank, 0),
                     fmt_float(f32(f32(100.0) - sum_abundance)),
                     str((self.matches_count - sum_reads_count) & 0xFFFFFFFF)))
        # counters for the reference's verbose per-rank summary
        # (slimm.hpp:836-840), consumed by reports.write_abundance
        self.rank_row_count = emitted
        self.rank_failed_count = failed
        return rows

    def raw_rows(self):
        """_raw.tsv rows (slimm.hpp:883-943), one per contig in index order.
        uniq2_abundance is reported as 0 — the reference never computes it."""
        nz = self.nonzero_bins("cov")
        nz1 = self.nonzero_bins("uniq_cov")
        nz2 = self.nonzero_bins("uniq_cov2")
        covp = self.cov_percent("cov")
        ucovp = self.cov_percent("uniq_cov")
        ucovp2 = self.cov_percent("uniq_cov2")
        rows = []
        for i, acc in enumerate(self.accessions):
            name = self.name_of(int(self.taxa_id[i]))[1]
            if name == "":
                name = "no_name_found"
            rows.append((
                acc, str(int(self.taxa_id[i])), name,
                str(int(self.reads_count[i])), fmt_float(self.abundance[i]),
                fmt_float(self.uniq_abundance[i]), fmt_float(0.0),
                str(int(self.lengths[i])), str(int(self.uniq_reads_count[i])),
                str(int(self.uniq_reads_count2[i])),
                str(int(self.nbins[i])), str(int(nz[i])),
                str(int(nz1[i])), str(int(nz2[i])),
                fmt_float(self.cov_depth("cov", i)),
                fmt_float(self.cov_depth("uniq_cov", i)),
                fmt_float(self.cov_depth("uniq_cov2", i)),
                fmt_float(covp[i]), fmt_float(ucovp[i]), fmt_float(ucovp2[i])))
        return rows

    def coverage_rows(self):
        """(_coverage, _uniq_coverage, _uniq_coverage2) CSV rows for valid
        refs in ascending id order (slimm.hpp:846-881)."""
        out = ([], [], [])
        for rid in sorted(self.valid_ref_ids):
            prefix = [self.accessions[rid]]
            for ti in self.lineage_of_acc(self.accessions[rid]):
                prefix.append(self.name_of(ti)[1])
            for stream, which in zip(out, ("cov", "uniq_cov", "uniq_cov2")):
                stream.append(",".join(
                    prefix + [str(int(h)) for h in self.bins(which, rid)]))
        return out
