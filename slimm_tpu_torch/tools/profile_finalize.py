"""Host tail of a profile at full-RefSeq cardinality: the port's counterpart
of profile_finalize.py (over slimm_tpu_torch.state, the port's taxonomy and
the port's finalize code).

    python -m slimm_tpu_torch.tools.profile_finalize [n_contigs] [n_lca]

Builds profile_finalize.py's synthetic ProfileState (`build_synthetic`,
copied from profile_finalize.py:33-104): n_contigs contigs whose lineages
span about 1.25 n_contigs taxids, n_lca LCA outcomes at those taxids.
Then times the host tail as engine.pipeline._finalize_state runs it:

  1. the dense LCA counts -> taxid dict (pipeline.taxon_counts_into)
  2. the pair-presence decode -> one sorted children CSR
     (pipeline.pairs_into)
  3. propagate_counts (ancestor propagation, slimm.hpp:559-610)
  4. abundance_rows at every rank (what the report writers walk)

Steps 1-2 decode what a device pass returns for the synthetic outcome: the
per-taxon counts and the presence of each (LCA, child) pair whose child's
lineage holds the LCA (the pairs a device pass can emit), into a fresh
state.  Steps 3-4 run on the synthetic state itself, as profile_finalize.py
runs them, and print its lines.  Everything runs on the host CPU; no
device is touched.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..config import ProfileOptions
from ..database import SlimmDatabase, tensorize
from ..engine.pipeline import _pad1024, pairs_into, taxon_counts_into
from ..state import ProfileState
from ..taxonomy import LINEAGE_LENGTH, RANK_LIST


# copied from profile_finalize.py:33-104
def build_synthetic(n_contigs: int, n_lca: int, seed: int = 0,
                    shuffle_taxids: bool = False):
    """`shuffle_taxids` remaps taxid values through a random bijection so
    numeric order is uncorrelated with rank level — this exercises the
    sequential order-dependence of propagate_counts (a receiver processed
    BEFORE some of its contributors sees their pushes late)."""
    rng = np.random.default_rng(seed)
    # taxonomy shape: strains -> species -> genus -> ... -> superkingdom,
    # fanout ~5 per level like real RefSeq bacteria
    lineages = np.zeros((n_contigs, LINEAGE_LENGTH), np.int64)
    base = 1_000_000
    lineages[:, 0] = base + np.arange(n_contigs)            # strain/species
    for lvl in range(1, LINEAGE_LENGTH):
        group = np.arange(n_contigs) // (5 ** lvl)
        lineages[:, lvl] = base + n_contigs + 10_000_000 * lvl + group
    if shuffle_taxids:
        uniq = np.unique(lineages)
        perm = rng.permutation(len(uniq))
        remap = dict(zip(uniq.tolist(),
                         (base + perm * 7 + 1).tolist()))
        lineages = np.vectorize(remap.__getitem__)(lineages)
    ac__taxid = {}
    taxid__name = {}
    accs = [f"ACC{i:07d}" for i in range(n_contigs)]
    for i in range(n_contigs):
        ac__taxid[accs[i]] = lineages[i].tolist()
    for lvl in range(LINEAGE_LENGTH):  # rank code == lineage level
        for t in np.unique(lineages[:, lvl]).tolist():
            taxid__name[int(t)] = (lvl, f"taxon{t}")

    opt = ProfileOptions()
    st = ProfileState(options=opt, ac__taxid=ac__taxid,
                      taxid__name=taxid__name)
    st.accessions = accs
    st.taxa_id = lineages[:, 0].copy()
    st.lengths = rng.integers(1_000_000, 5_000_000,
                              n_contigs).astype(np.int64)
    st.nbins = st.lengths // 1000 + 1
    st.bin_offset = np.concatenate([[0], np.cumsum(st.nbins)[:-1]])
    n = n_contigs
    st.reads_count = rng.integers(0, 2000, n).astype(np.int64)
    st.uniq_reads_count = rng.integers(0, 500, n).astype(np.int64)
    st.uniq_reads_count2 = rng.integers(0, 500, n).astype(np.int64)
    st.abundance = np.zeros(n, np.float32)
    st.uniq_abundance = np.zeros(n, np.float32)
    st.hits_count = int(st.reads_count.sum())
    st.matches_count = st.hits_count
    st.uniq_hits_count = int(st.uniq_reads_count.sum())
    st.avg_read_length = 100
    st.valid_ref_ids = set(range(n))

    # LCA outcome: n_lca taxids spread over the species level (the common
    # case) with a tail at higher ranks; children sets of size 1-8
    lca_levels = rng.choice(LINEAGE_LENGTH, n_lca,
                            p=[.55, .2, .1, .06, .04, .03, .01, .01])
    lca_contig = rng.integers(0, n_contigs, n_lca)
    counts = rng.integers(1, 5000, n_lca)
    read_count = {}
    children = {}
    for i in range(n_lca):
        t = int(lineages[lca_contig[i], lca_levels[i]])
        read_count[t] = read_count.get(t, 0) + int(counts[i])
        ch = children.setdefault(t, set())
        ch.add(int(lca_contig[i]))
        for _ in range(int(rng.integers(0, 8))):
            ch.add(int(rng.integers(0, n_contigs)))
    st.taxon_id__read_count = read_count
    st.taxon_id__children = children
    # pre-seed the memoized cutoffs (bin arrays aren't materialized here)
    st._coverage_cut_off = np.float32(1e-9)
    st._uniq_coverage_cut_off = np.float32(1e-9)
    return st


def device_outputs(st):
    """What a device pass returns for `st`'s LCA outcome: (dense, the dense
    per-taxon counts, the pair presence as the packed tail's int32 words).
    A pair is present where its child's lineage holds the LCA."""
    dense = tensorize(SlimmDatabase(ac__taxid=st.ac__taxid,
                                    taxid__name=st.taxid__name),
                      st.accessions)
    tids = np.fromiter(st.taxon_id__read_count, np.int64)
    counts = np.zeros(dense.n_dense, np.int64)
    counts[np.searchsorted(dense.dense_to_tid, tids)] = np.fromiter(
        st.taxon_id__read_count.values(), np.int64)
    lca = [(t, c) for t, ch in st.taxon_id__children.items() for c in ch]
    t_d = np.searchsorted(dense.dense_to_tid,
                          np.array([t for t, _ in lca], np.int64))
    child = np.array([c for _, c in lca], np.int64)
    on_level = dense.lineage[child] == t_d[:, None]
    held = on_level.any(1)
    n_codes = dense.n_pair_codes
    pres = np.zeros(_pad1024(len(dense.lineage) * n_codes), np.uint8)
    pres[child[held] * n_codes + on_level[held].argmax(1)] = 1
    return dense, counts, np.packbits(pres, bitorder="little").view(np.int32)


def decode_tail(st):
    """Steps 1-2 on a fresh state: (state, seconds of each step)."""
    dense, counts, words = device_outputs(st)
    out = ProfileState(options=ProfileOptions(), ac__taxid=st.ac__taxid,
                       taxid__name=st.taxid__name)
    t0 = time.perf_counter()
    taxon_counts_into(out, counts, dense)
    t1 = time.perf_counter()
    pairs_into(out, words, dense)
    t2 = time.perf_counter()
    return out, (t1 - t0, t2 - t1)


def main(argv=None) -> None:
    """Prints profile_finalize.py's lines, with steps 1-2 before its
    own."""
    argv = sys.argv[1:] if argv is None else argv
    n_contigs = int(argv[0]) if len(argv) > 0 else 5000
    n_lca = int(argv[1]) if len(argv) > 1 else 50_000
    st = build_synthetic(n_contigs, n_lca)
    n_distinct = len(st.taxon_id__read_count)
    print(f"contigs={n_contigs} lca_entries={n_lca} "
          f"distinct_lca_taxids={n_distinct}")

    decoded, (s1, s2) = decode_tail(st)
    n_pairs = len(decoded.lca_pairs.contigs)
    print(f"dense counts -> taxid dict: {s1:.3f} s "
          f"({len(decoded.taxon_id__read_count)} taxids)")
    print(f"pair decode -> children CSR: {s2:.3f} s ({n_pairs} pairs)")

    t0 = time.perf_counter()
    st.propagate_counts()
    t1 = time.perf_counter()
    print(f"propagate_counts: {t1 - t0:.3f} s "
          f"({len(st.taxon_id__read_count)} taxids after propagation)")

    st.compute_abundances()
    t2 = time.perf_counter()
    total_rows = 0
    for rank in RANK_LIST[1:]:
        st.options.rank = rank
        rows = st.abundance_rows()
        total_rows += len(rows)
    t3 = time.perf_counter()
    print(f"abundance_rows all ranks: {t3 - t2:.3f} s ({total_rows} rows)")


if __name__ == "__main__":
    main()
