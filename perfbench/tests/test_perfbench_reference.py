"""The NumPy reference against the port on the CPU: field by field and the
report's rows, on samples of the benchmark's own generator and on the
repo's toy data set.  (The test imports the port; the reference does not.)"""

import copy
import json
import os

import numpy as np
import pytest

from harness import compare, generate, spec
from reference import slimm as reference

OPTIONS = dict(bin_width=0, min_reads=0, rank="species", cov_cut_off=0.95,
               abundance_cut_off=0.01)


def _port_state(db_maps, names, lengths, read_id, rid, pos, n_reads, avg,
                options):
    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.engine.pipeline import profile_arrays

    db = SlimmDatabase(ac__taxid=copy.deepcopy(db_maps[0]),
                       taxid__name=dict(db_maps[1]))
    return profile_arrays(ProfileOptions(**options), db, names, lengths,
                          np.asarray(read_id, np.int32), rid, pos, n_reads,
                          len(rid), avg, device="cpu",
                          engine=EngineOptions(fetch_coverage=False,
                                               phase_log=False),
                          deduped=False)


def _same(st, want):
    got = compare.answer_of_state(st)
    assert compare.compare(got, want) == dict.fromkeys(compare.GROUPS, 0)
    assert ["\t".join(r) for r in st.abundance_rows()] == want["rows"]


def _config(name, **changes):
    with open(os.path.join(spec.BENCH_DIR, "configs", name + ".json")) as f:
        return dict(json.load(f), **changes)


@pytest.mark.parametrize("config,n_contigs,seed", [
    ("genus50", 50, 0), ("genus50", 50, 2**33 + 5), ("refseq1k", 120, 77)])
def test_reference_equals_port_on_generated_samples(config, n_contigs, seed):
    cfg = _config(config, n_contigs=n_contigs)
    db = generate.make_database(cfg, seed)
    s = generate.make_sample(cfg, db, seed, 0, 40000)
    want = reference.profile(
        s["read_id"], s["rid"], s["pos"], contig_names=db["names"],
        contig_lengths=db["lengths"], ac__taxid=db["ac__taxid"],
        taxid__name=db["taxid__name"], options=OPTIONS, avg_read_length=150)
    st = _port_state((db["ac__taxid"], db["taxid__name"]), db["names"],
                     db["lengths"], s["read_id"], s["rid"], s["pos"],
                     s["n_reads"], 150, OPTIONS)
    _same(st, want)
    assert want["counts"]                                  # LCAs happened
    assert want["valid"].size < n_contigs                  # cutoffs bit
    assert want["work"]["records"] == len(s["rid"])


@pytest.mark.parametrize("options", [OPTIONS, dict(OPTIONS, rank="genus",
                                                   bin_width=100,
                                                   cov_cut_off=0.8)])
def test_reference_equals_port_on_the_toy_set(toy_set, options):
    af, db, batch = toy_set
    want = reference.profile(
        batch.read_id, batch.rid, batch.pos, contig_names=af.contig_names,
        contig_lengths=af.contig_lengths, ac__taxid=db.ac__taxid,
        taxid__name=db.taxid__name, options=options,
        avg_read_length=batch.avg_read_length)
    st = _port_state((db.ac__taxid, db.taxid__name), af.contig_names,
                     af.contig_lengths, batch.read_id, batch.rid, batch.pos,
                     batch.n_reads, batch.avg_read_length, options)
    _same(st, want)


@pytest.fixture(scope="module")
def toy_set(tmp_path_factory):
    from tests.toy import build_toy_dataset

    from slimm_tpu_torch.config import BuildOptions
    from slimm_tpu_torch.database import build_database
    from slimm_tpu_torch.io import AlignmentFile

    d = tmp_path_factory.mktemp("toy")
    ds = build_toy_dataset(str(d))
    db = build_database(BuildOptions(
        fasta_path=ds.fasta_path, ac__taxid_paths=[ds.acc2taxid_path],
        names_path=ds.names_path, nodes_path=ds.nodes_path,
        output_path=str(d / "toy.sldb")))
    af = AlignmentFile(ds.sam_path)
    return af, db, af.load(dedup=False)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.14159, -2.5e-3], np.float32)
    got = reference.to_bfloat16(x)
    assert got.view(np.uint32).tolist() == [
        v & 0xFFFF0000 for v in got.view(np.uint32).tolist()]
    assert got[0] == 1.0 and got[1] == 1.0           # a tie goes to even
    assert got[2] == np.float32(1.015625)            # a tie rounds up to even
    assert abs(got[3] - 3.14159) < 2**-7 * 4
    assert reference.to_bfloat16(np.float32(1.0)) == np.float32(1.0)


@pytest.mark.parametrize("config", ["genus50", "refseq1k"])
def test_every_seed_gets_the_same_work_in_another_order(config):
    """The seed orders the work and leaves its amount: the same genome
    lengths, taxonomy and counts of reads, records and hits per genome."""
    cfg = _config(config)
    dbs = [generate.make_database(cfg, s) for s in (1, 2**40 + 3)]
    assert not np.array_equal(dbs[0]["lengths"], dbs[1]["lengths"])
    assert sorted(dbs[0]["lengths"]) == sorted(dbs[1]["lengths"])
    assert np.array_equal(dbs[0]["lineage"], dbs[1]["lineage"])
    lin = dbs[0]["lineage"]
    assert len(np.unique(lin[:, -1])) == 1               # one superkingdom
    samples = [generate.make_sample(cfg, db, s, 0, 30000)
               for db, s in zip(dbs, (1, 2**40 + 3))]
    a, b = ([np.sort(np.bincount(s["rid"][first_hit(s)],
                                 minlength=len(lin))) for s in samples])
    assert np.array_equal(a, b)
    assert len(samples[0]["rid"]) == len(samples[1]["rid"])
    for s in samples:        # the k-th extra hit on a relative at rank k
        first = first_hit(s)
        own = s["rid"][first][s["read_id"]]
        k = np.arange(len(s["rid"])) - np.flatnonzero(first)[s["read_id"]]
        assert set(np.unique(k)) == {0, 1, 2}
        for j, rank in enumerate(cfg["partner_ranks"], start=1):
            size = int(cfg["taxon_sizes"][rank])
            hit = k == j
            assert (own[hit] != s["rid"][hit]).all()
            assert (own[hit] // size == s["rid"][hit] // size).all()


def first_hit(s):
    return np.r_[True, s["read_id"][1:] != s["read_id"][:-1]]
