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
propagation ran."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from slimm_tpu_torch.config import EngineOptions, ProfileOptions
from slimm_tpu_torch.database import SlimmDatabase
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.io import native
from slimm_tpu_torch.state import ProfileState
from slimm_tpu_torch.tools.profile_finalize import build_synthetic

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
