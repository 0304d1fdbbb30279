"""The full-RefSeq deployment of the benchmark (perfbench/configs/
refseq50k.json) at a CPU size, and the two ancestor propagations of
slimm_tpu_torch.state held to each other and to slimm_tpu.state's.

The configuration's taxonomy (species of 4 genomes, genera of 16, ..., one
superkingdom) and multi-mapping (the first extra hit on another strain of
the species, the second in the genus) are kept; its 50,000 genomes of
2-6 Mbp become 20,000 of 20-60 kbp and a sample has 1.5M records: the
fewest, in round numbers, at which a profile passes NATIVE_PROPAGATE_MIN
LCA taxa (4,269 and 4,260 on the two seeds), so that the propagation runs
in C++ (io/native.py `propagate`) as on the full database.
`profile_arrays` on the CPU is held field by field to the benchmark's
NumPy reference (perfbench/reference/slimm.py) through
perfbench/harness/compare.py, and `pipeline.work_counts` says which
propagation ran.  The pair presence's decode into one sorted CSR
(`pipeline.pairs_into`) is held to a bit-by-bit decode into sets, and its
hand-off to the C++ as arrays to the Python loop and to slimm_tpu.state's."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from slimm_tpu_torch.config import EngineOptions, ProfileOptions
from slimm_tpu_torch.database import SlimmDatabase, tensorize
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.engine.pipeline import _pad1024
from slimm_tpu_torch.io import native
from slimm_tpu_torch.state import ProfileState
from slimm_tpu_torch.tools.profile_finalize import (build_synthetic,
                                                    device_outputs)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import compare, generate  # noqa: E402
from reference import slimm as reference  # noqa: E402

torch.set_num_threads(1)

CONTIGS = 20000
GENOME_LENGTH = [20000, 60000]
RECORDS = 1_500_000
SEEDS = (5, 2**33 + 2026)


@pytest.fixture(scope="module")
def cfg():
    native.build()
    with open(os.path.join(BENCH, "configs", "refseq50k.json")) as f:
        c = json.load(f)
    return dict(c, n_contigs=CONTIGS, genome_length=GENOME_LENGTH)


@pytest.fixture(autouse=True)
def fresh_counts():
    tp.reset_path_counts()
    yield
    tp.reset_path_counts()


@pytest.mark.parametrize("seed", SEEDS)
def test_profile_equals_the_reference_on_the_native_propagation(cfg, seed):
    db = generate.make_database(cfg, seed)
    s = generate.make_sample(cfg, db, seed, 0, RECORDS)
    pdb = SlimmDatabase(
        ac__taxid={k: list(v) for k, v in db["ac__taxid"].items()},
        taxid__name=dict(db["taxid__name"]))
    st = tp.profile_arrays(
        ProfileOptions(**cfg["options"]), pdb, db["names"], db["lengths"],
        s["read_id"], s["rid"], s["pos"], s["n_reads"], len(s["rid"]),
        cfg["read_length"], device="cpu",
        engine=EngineOptions(fetch_coverage=False, phase_log=False),
        deduped=False)
    want = reference.profile(
        s["read_id"], s["rid"], s["pos"], contig_names=db["names"],
        contig_lengths=db["lengths"], ac__taxid=db["ac__taxid"],
        taxid__name=db["taxid__name"], options=cfg["options"],
        avg_read_length=cfg["read_length"])
    differing = compare.compare(compare.answer_of_state(st), want)
    assert not any(differing.values()), differing

    counts = tp.work_counts
    assert counts["calls"] == 1
    assert counts["native_propagations"] == 1
    assert counts["python_propagations"] == 0
    assert counts["lca_taxa"] >= ProfileState.NATIVE_PROPAGATE_MIN
    # the pairs went to the C++ as arrays: no children set was built
    assert counts["lca_pairs"] >= counts["lca_taxa"]
    assert counts["children_sets"] == 0
    assert st.lca_pairs is None


def test_profile_under_the_threshold_propagates_in_python(cfg):
    """A sample too small to pass NATIVE_PROPAGATE_MIN LCA taxa: the
    Python loop runs, on one children set a taxon filled from the decoded
    pairs, and the profile still equals the reference."""
    seed = 2**31 + 17
    small = dict(cfg, n_contigs=2000)
    db = generate.make_database(small, seed)
    s = generate.make_sample(small, db, seed, 0, 100_000)
    pdb = SlimmDatabase(
        ac__taxid={k: list(v) for k, v in db["ac__taxid"].items()},
        taxid__name=dict(db["taxid__name"]))
    st = tp.profile_arrays(
        ProfileOptions(**cfg["options"]), pdb, db["names"], db["lengths"],
        s["read_id"], s["rid"], s["pos"], s["n_reads"], len(s["rid"]),
        cfg["read_length"], device="cpu",
        engine=EngineOptions(fetch_coverage=False, phase_log=False),
        deduped=False)
    want = reference.profile(
        s["read_id"], s["rid"], s["pos"], contig_names=db["names"],
        contig_lengths=db["lengths"], ac__taxid=db["ac__taxid"],
        taxid__name=db["taxid__name"], options=cfg["options"],
        avg_read_length=cfg["read_length"])
    differing = compare.compare(compare.answer_of_state(st), want)
    assert not any(differing.values()), differing

    counts = tp.work_counts
    assert counts["python_propagations"] == 1
    assert counts["native_propagations"] == 0
    assert 0 < counts["lca_taxa"] < ProfileState.NATIVE_PROPAGATE_MIN
    assert counts["children_sets"] == counts["lca_taxa"]
    assert counts["lca_pairs"] >= counts["lca_taxa"]


def _with_quirks(st):
    """An INTERMEDIATE-rank taxid and a nameless taxid among the LCAs."""
    keys = sorted(st.taxon_id__read_count)
    st.taxid__name[keys[1]] = (8, "odd_intermediate")
    st.taxid__name.pop(keys[2])
    return st


@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["ordered", "shuffled_taxids"])
def test_native_and_python_propagations_agree(shuffle):
    """One state past the threshold, propagated with NATIVE_PROPAGATE_MIN
    forced low (C++) and forced high (the Python loop), and the same state
    built by the JAX package's profile_finalize.py and propagated by
    slimm_tpu.state's loop (the spec): equal counts, children and
    taxid__name (insert-on-miss), and each path counted once."""
    import profile_finalize as jfinal

    native.build()
    st = _with_quirks(build_synthetic(8000, 12000, seed=7,
                                      shuffle_taxids=shuffle))
    spec = _with_quirks(jfinal.build_synthetic(8000, 12000, seed=7,
                                               shuffle_taxids=shuffle))
    assert type(spec).__module__ == "slimm_tpu.state"
    assert spec.taxon_id__read_count == st.taxon_id__read_count
    assert spec.taxon_id__children == st.taxon_id__children
    lca_taxa = len(st.taxon_id__read_count)
    assert lca_taxa >= ProfileState.NATIVE_PROPAGATE_MIN
    low, high = st, copy.deepcopy(st)
    low.NATIVE_PROPAGATE_MIN = 1
    high.NATIVE_PROPAGATE_MIN = 10**9
    spec.NATIVE_PROPAGATE_MIN = 10**9
    low.propagate_counts()
    assert tp.work_counts["native_propagations"] == 1
    high.propagate_counts()
    assert tp.work_counts["python_propagations"] == 1
    assert tp.work_counts["lca_taxa"] == 2 * lca_taxa
    spec.propagate_counts()

    for got in (low, high):
        assert got.taxon_id__read_count == spec.taxon_id__read_count
        assert got.taxon_id__children.keys() == spec.taxon_id__children.keys()
        for t, ch in got.taxon_id__children.items():
            assert set(np.asarray(list(ch)).tolist()) == set(
                spec.taxon_id__children[t]), t
        assert got.taxid__name == spec.taxid__name
    assert all(isinstance(ch, np.ndarray)
               for ch in low.taxon_id__children.values())


# -- the (LCA, contig) pairs: one sorted CSR from the pair presence, handed
# to the native propagation as arrays ----------------------------------------


def _pair_map_taxonomy(seed):
    """A DenseTaxonomy over 300 contigs of three superkingdoms, contig 7's
    accession unknown to the database (an all-zero lineage)."""
    rng = np.random.default_rng(seed)
    n = 300
    lineages = np.zeros((n, 8), np.int64)
    for lvl in range(8):
        group = np.arange(n) // (3 ** lvl) if lvl < 7 else np.arange(n) % 3
        lineages[:, lvl] = 100 + 1000 * lvl + group
    lineages = lineages[rng.permutation(n)]
    accs = [f"ACC{i:05d}" for i in range(n)]
    ac__taxid = {a: lineages[i].tolist() for i, a in enumerate(accs)}
    del ac__taxid[accs[7]]
    taxid__name = {int(t): (lvl, f"t{t}") for lvl in range(8)
                   for t in np.unique(lineages[:, lvl]).tolist()}
    return tensorize(SlimmDatabase(ac__taxid=ac__taxid,
                                   taxid__name=taxid__name), accs)


def _decode_by_sets(words, dense):
    """The pair presence decoded bit by bit into children sets."""
    n_codes = dense.n_pair_codes
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    children = {}
    for i in np.flatnonzero(bits[:len(dense.lineage) * n_codes]).tolist():
        r, code = divmod(i, n_codes)
        d = dense.lineage[r, code] if code < 8 else dense.sk_dense[code - 8]
        children.setdefault(int(dense.dense_to_tid[d]), set()).add(r)
    return children


@pytest.mark.parametrize("share", [0.0, 0.002, 0.05, 0.5],
                         ids=["empty", "sparse", "some", "dense"])
@pytest.mark.parametrize("seed", [3, 2**32 + 9])
def test_pairs_decode_into_the_children_the_sets_give(seed, share):
    """pairs_into's CSR over random pair-presence maps, the superkingdom
    codes 8 + k and the unknown accession's all-zero lineage among them:
    LCAs ascending, contigs ascending and int32 within each, and as sets
    exactly the children a bit-by-bit decode gives."""
    dense = _pair_map_taxonomy(seed)
    assert dense.n_pair_codes == 8 + 4   # three superkingdoms and 0
    assert not dense.lineage[7].any()
    rng = np.random.default_rng(seed)
    pres = np.zeros(_pad1024(len(dense.lineage) * dense.n_pair_codes),
                    np.uint8)
    pres[:len(dense.lineage) * dense.n_pair_codes] = (
        rng.random(len(dense.lineage) * dense.n_pair_codes) < share)
    if share:
        pres[7 * dense.n_pair_codes + 2] = 1    # the all-zero lineage
        pres[7 * dense.n_pair_codes + 9] = 1    # superkingdom code 8 + 1
    words = np.packbits(pres, bitorder="little").view(np.int32)
    want = _decode_by_sets(words, dense)

    st = ProfileState(options=ProfileOptions(), ac__taxid={},
                      taxid__name={})
    tp.pairs_into(st, words, dense)
    pairs = st.lca_pairs
    n_pairs = sum(len(ch) for ch in want.values())
    assert tp.work_counts["lca_pairs"] == n_pairs == len(pairs.contigs)
    assert pairs.contigs.dtype == np.int32
    assert np.all(np.diff(pairs.lca) > 0)
    assert pairs.offsets[0] == 0 and pairs.offsets[-1] == n_pairs
    assert np.all(np.diff(pairs.offsets) > 0)
    for i in range(len(pairs.lca)):
        assert np.all(np.diff(
            pairs.contigs[pairs.offsets[i]:pairs.offsets[i + 1]]) > 0)
    assert pairs.taxids.tolist() == sorted(want)
    assert st.taxon_id__children == {}
    st.take_pairs_as_sets()
    assert st.lca_pairs is None
    assert st.taxon_id__children == want
    assert tp.work_counts["children_sets"] == len(want)


def _decoded_state(module_build, shuffle):
    """build_synthetic's state past the threshold with the quirks, a
    nameless LCA taxid kept in taxid__name, and its counts and children
    put back through the device outputs' decode (taxon_counts_into,
    pairs_into): the children a device pass can emit."""
    st = _with_quirks(module_build(8000, 12000, seed=11,
                                   shuffle_taxids=shuffle))
    keys = sorted(st.taxon_id__read_count)
    st.taxid__name[keys[3]] = (0, "")
    dense, counts, words = device_outputs(st)
    st.taxon_id__read_count, st.taxon_id__children = {}, {}
    tp.taxon_counts_into(st, counts, dense)
    tp.pairs_into(st, words, dense)
    return st, keys


@pytest.mark.parametrize("route", ["arrays", "declined", "python"])
@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["ordered", "shuffled_taxids"])
def test_array_hand_off_propagates_as_the_loop(monkeypatch, route, shuffle):
    """The decoded pairs of one state past the threshold, propagated in C++
    from the CSR (`arrays`: no children set built), by the Python loop
    after the C++ declined (`declined`) and by the loop alone (`python`),
    against slimm_tpu.state's loop on the same children as sets: equal
    counts, children and taxid__name (the INTERMEDIATE-rank, nameless and
    absent LCA taxids; the absent one inserted as (0, ""))."""
    import profile_finalize as jfinal

    native.build()
    st, keys = _decoded_state(build_synthetic, shuffle)
    assert keys[2] not in st.taxid__name
    assert st.taxid__name[keys[1]] == (8, "odd_intermediate")
    spec = _with_quirks(jfinal.build_synthetic(8000, 12000, seed=11,
                                               shuffle_taxids=shuffle))
    spec.taxid__name[keys[3]] = (0, "")
    assert type(spec).__module__ == "slimm_tpu.state"
    as_sets = copy.deepcopy(st)
    as_sets.take_pairs_as_sets()
    spec.taxon_id__read_count = dict(st.taxon_id__read_count)
    spec.taxon_id__children = copy.deepcopy(as_sets.taxon_id__children)
    spec.NATIVE_PROPAGATE_MIN = 10**9
    spec.propagate_counts()
    assert spec.taxid__name[keys[2]] == (0, "")
    tp.reset_path_counts()

    if route == "python":
        st.NATIVE_PROPAGATE_MIN = 10**9
    if route == "declined":
        monkeypatch.setattr(native, "propagate", lambda *a: None)
    st.propagate_counts()
    counts = tp.work_counts
    assert counts["native_propagations"] == (route == "arrays")
    assert counts["python_propagations"] == (route != "arrays")
    assert counts["children_sets"] == (
        0 if route == "arrays" else len(as_sets.taxon_id__children))
    assert st.lca_pairs is None
    assert st.taxon_id__read_count == spec.taxon_id__read_count
    assert st.taxon_id__children.keys() == spec.taxon_id__children.keys()
    for t, ch in st.taxon_id__children.items():
        if route == "arrays":
            assert ch.dtype == np.int32 and np.all(np.diff(ch) > 0)
        assert set(np.asarray(list(ch)).tolist()) == (
            spec.taxon_id__children[t]), t
    assert st.taxid__name == spec.taxid__name
