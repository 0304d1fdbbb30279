"""The traffic generator (harness/generate.py).

The lock: every configuration of BENCHMARK.json makes the same bytes from
the same seed as the generator before `genomes_per_species`,
`taxa_per_parent` and `extra_hits` were added (sha256 of the database, two
samples of each, and genus50's SAM and BAM files, on two seeds; the
digests are of commit 641c962's generator).  The new keys: a skewed
taxonomy and reads with many extra hits, the same counts on every seed,
distinct hits nearest first, and a cut-down skewed deployment profiled
correctly on the CPU, with the host plan that reads of more than
MAX_WINDOW + 1 records bring back."""

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import pytest

from harness import cell as cell_mod
from harness import generate, spec

LOCK_SEEDS = (18, 2**40 + 18)
LOCK_RECORDS = 20000

LOCK = {
    ("genus50", 18): {
        "database":
            "c772fae1ca0e2a90836a4b8ca01de7bc65b0e172da31da5674d384400e91a4e4",
        "sample0":
            "a666ed70512627745cf6ac4c0b7ce67c3b019820dbb9a851eb7920d3e86f255c",
        "sample1":
            "606fbea3c1a386daa74085fe1a3d733e3404a205a7e774fa6310e642fd28531a",
        "sam":
            "04190de0decd0fd01ff355a5a1054219a90626c6b35c653753bd2bcb1999e410",
        "bam":
            "22486ba4176f9ff641b1aadca0d1a4e11361f76995820d94d58fc1f1d50b2a5d",
    },
    ("genus50", 2**40 + 18): {
        "database":
            "61caf165b7d4acf47e8f61365c9738d265972aa7406ec0a08df1b058924bbaea",
        "sample0":
            "fc17d2e8f4aad81bfbf9acadbd2c10e6ddd28b2b4160f26e46c98366a1566fd8",
        "sample1":
            "6a0c11b1194dac3b996f88bf627d308f22ba24d0806116ef51c320a22055b3b6",
        "sam":
            "7e01b9d34fd7396907e20dfb14a5752eaa142e4a75cb7a09244b55534c0a3a5a",
        "bam":
            "638b6ff8b3cc52815bb3b3f9e4b9a7ea93e916c2cc90b1ec28e12e489830591c",
    },
    ("refseq1k", 18): {
        "database":
            "7100f294874b14951e99db53298dbfc3d3a90b40fbd0f38d00d92a7e5690afc6",
        "sample0":
            "41f581dbac2d17592f53d661e857684bede0bc1293d8e42c57bb7f4ee002ee83",
        "sample1":
            "e62fdcc1e9f3bbbf75a961a5b964b454df44948f3ee607e0869b15471ca61e84",
    },
    ("refseq1k", 2**40 + 18): {
        "database":
            "1c52d4ea951fc112b9a491921905776cefad3a17b16fc8a100f36da0dd8fd1eb",
        "sample0":
            "75749f92d40ebeaff7ef764654cf19bb751ed959de5cedd681779b20f5605860",
        "sample1":
            "159325488c5774295db67926bd15e91c567028e2e40ee30bb8443bb158467602",
    },
    ("refseq50k", 18): {
        "database":
            "eef987694a8f9d67c88afcdfde4a324f299b12522ec3577bba1c5fdbf4261f80",
        "sample0":
            "23b90cb09579ef83522d7e4e0f957e90ab010126be652f64281d8164ab41afb1",
        "sample1":
            "75165accc313dcc6c451641e87142b45288c73b03bed6da2e7d8c98a2c980432",
    },
    ("refseq50k", 2**40 + 18): {
        "database":
            "985f5ff0671fbb6529557206c9aec3a199c99b268014e08d66f18b5878510ed4",
        "sample0":
            "60dc57adee1746b26c79c407f38d3f86846e53b78776ca3b06873c8d3295edd8",
        "sample1":
            "b0bef1fa86e9ce65c5721ca36151b653af5ecd23392afd7e7ac71b4641bbabf5",
    },
}


def _config(name, **changes):
    with open(os.path.join(spec.BENCH_DIR, "configs", name + ".json")) as f:
        return dict(json.load(f), **changes)


def _sha(*parts):
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype.str}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()


def digests(gen, name, seed, tmp):
    """sha256 of what `gen` makes for configuration `name` from `seed`: the
    database (names, lengths, lineage, both maps in their order), samples
    0 and 1 of LOCK_RECORDS records, and for genus50 sample 0's SAM and
    BAM bytes."""
    cfg = _config(name)
    db = gen.make_database(cfg, seed)
    out = {"database": _sha(db["names"], db["lengths"], db["lineage"],
                            list(db["ac__taxid"].items()),
                            list(db["taxid__name"].items()))}
    for i in (0, 1):
        s = gen.make_sample(cfg, db, seed, i, LOCK_RECORDS)
        out[f"sample{i}"] = _sha(s["read_id"], s["rid"], s["pos"],
                                 s["n_reads"], s["read_len"])
        if name == "genus50" and i == 0:
            for fmt, write in (("sam", gen.write_sam), ("bam", gen.write_bam)):
                path = os.path.join(tmp, f"lock.{fmt}")
                write(path, db, s)
                with open(path, "rb") as f:
                    out[fmt] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("name,seed", sorted(LOCK))
def test_every_configuration_makes_the_locked_bytes(name, seed, tmp_path):
    assert digests(generate, name, seed, str(tmp_path)) == LOCK[name, seed]


def test_the_lock_covers_every_configuration():
    names = {c["name"] for c in spec.load_benchmark()["configs"]}
    assert names == {name for name, _ in LOCK}


# -- the new keys ------------------------------------------------------------

# a cut-down skewed deployment: 2,000 genomes of 20-60 kbp, one species of
# 200 genomes, a few of 20-50, the rest of one genome; up to 15 extra hits
SKEWED = dict(
    n_contigs=2000, genome_length=[20000, 60000],
    genomes_per_species=[[200, 1], [50, 2], [30, 3], [20, 5], [1, 1510]],
    taxa_per_parent={"genus": 4, "family": 5, "order": 2, "class": 3,
                     "phylum": 3, "superkingdom": 100},
    extra_hits=[[1, 0.1], [3, 0.1], [7, 0.05], [15, 0.05]])
UNIFORM_KEYS = ("taxon_sizes", "multi_share", "partner_ranks")
SEEDS = (5, 2**31 + 5, 3 * 2**40 + 1)
RECORDS = 200_000


def _skewed(base="refseq50k", **changes):
    cfg = {k: v for k, v in _config(base).items() if k not in UNIFORM_KEYS}
    return dict(cfg, **SKEWED, **changes)


def _uniform_many_hits():
    """refseq1k (species of one genome, genera of 4, ...) with extra_hits in
    place of multi_share and partner_ranks."""
    cfg = {k: v for k, v in _config("refseq1k", n_contigs=300).items()
           if k not in ("multi_share", "partner_ranks")}
    return dict(cfg, extra_hits=[[1, 0.2], [5, 0.1], [40, 0.05]])


def _first(s):
    return np.r_[True, s["read_id"][1:] != s["read_id"][:-1]]


def _taxon_sizes(lineage):
    """Genomes in each contig's taxon, per level 0-7 and the database."""
    sizes = [np.bincount(col)[col] for col in lineage.T]
    return np.column_stack(sizes + [np.full(len(lineage), len(lineage))])


def test_skewed_taxonomy_is_the_files_on_every_seed():
    cfg = _skewed()
    dbs = [generate.make_database(cfg, s) for s in SEEDS]
    lin = dbs[0]["lineage"]
    for db in dbs[1:]:
        assert np.array_equal(db["lineage"], lin)
        assert db["taxid__name"] == dbs[0]["taxid__name"]
        assert sorted(db["lengths"]) == sorted(dbs[0]["lengths"])
    # species: contiguous groups of the listed sizes, in order
    _, species = np.unique(lin[:, 1], return_counts=True)
    want = np.repeat([g for g, _ in SKEWED["genomes_per_species"]],
                     [s for _, s in SKEWED["genomes_per_species"]])
    assert np.array_equal(species, want)
    # each higher rank: taxa_per_parent whole taxa of the rank below
    taxa = [len(species)]
    for lvl, rank in enumerate(generate.RANKS[1:], start=2):
        below = lin[np.r_[True, lin[1:, lvl - 1] != lin[:-1, lvl - 1]]]
        _, held = np.unique(below[:, lvl], return_counts=True)
        per = SKEWED["taxa_per_parent"][rank]
        assert (held[:-1] == per).all() and 1 <= held[-1] <= per, rank
        assert np.array_equal(np.diff(lin[:, lvl]) != 0,
                              np.diff(lin[:, lvl]) == 1)
        taxa.append(len(held))
    assert taxa == [1521, 381, 77, 39, 13, 5, 1]
    assert len(dbs[0]["taxid__name"]) == 2000 + sum(taxa)


@pytest.mark.parametrize("make", [_skewed, _uniform_many_hits],
                         ids=["skewed", "uniform"])
def test_counts_are_the_same_on_every_seed(make):
    """Records, reads with each number of extra hits, reads per genome
    (first hits) and taxa per rank: the same on every seed."""
    cfg = make()
    n = cfg["n_contigs"]
    seen = []
    for seed in SEEDS:
        db = generate.make_database(cfg, seed)
        s = generate.make_sample(cfg, db, seed, 0, RECORDS)
        first = _first(s)
        hits = np.diff(np.r_[np.flatnonzero(first), len(first)]) - 1
        seen.append(dict(
            records=len(s["rid"]), reads=s["n_reads"],
            per_k=np.bincount(hits).tolist(),
            per_genome=np.sort(np.bincount(s["rid"][first],
                                           minlength=n)).tolist(),
            taxa=[len(np.unique(c)) for c in db["lineage"].T]))
        assert s["n_reads"] == first.sum() == s["read_id"][-1] + 1
        assert np.array_equal(s["read_id"], np.sort(s["read_id"]))
    assert all(x == seen[0] for x in seen[1:])
    shares = dict((k, sh) for k, sh in cfg["extra_hits"])
    total = sum(k * sh for k, sh in cfg["extra_hits"])
    assert seen[0]["reads"] == int(RECORDS / (1 + total))
    for k, n_k in enumerate(seen[0]["per_k"]):
        assert abs(n_k - shares.get(k, 0) * seen[0]["reads"]) < 1 or k == 0


@pytest.mark.parametrize("make", [_skewed, _uniform_many_hits],
                         ids=["skewed", "uniform"])
def test_extra_hits_are_distinct_and_nearest_first(make):
    """A read's i-th extra hit lies at the nearest level that still has a
    genome the read has not taken: the level L with size(L-1) - 1 <= i <
    size(L) - 1, sizes counted in genomes of the read's own taxon at each
    level (0: the genome, 8: the database); and no genome twice a read."""
    cfg = make()
    for seed in SEEDS:
        db = generate.make_database(cfg, seed)
        s = generate.make_sample(cfg, db, seed, 1, RECORDS)
        lin = db["lineage"]
        first = _first(s)
        starts = np.flatnonzero(first)
        own = s["rid"][starts][s["read_id"]]
        i = np.arange(len(s["rid"])) - starts[s["read_id"]] - 1
        extra = i >= 0
        own, hit, i = own[extra], s["rid"][extra], i[extra]
        same = lin[hit] == lin[own]
        level = np.where(same.any(axis=1), np.argmax(same, axis=1), 8)
        sizes = _taxon_sizes(lin)[own]
        rows = np.arange(len(own))
        assert (level >= 1).all()                    # never its own genome
        assert (sizes[rows, level - 1] - 1 <= i).all()
        assert (i < sizes[rows, level] - 1).all()
        key = s["read_id"].astype(np.int64) * len(lin) + s["rid"]
        assert len(np.unique(key)) == len(key)
        assert level.max() >= 2             # some reads leave their species
    assert np.bincount(i).size == max(k for k, _ in cfg["extra_hits"])


def test_extra_hits_may_take_every_other_genome():
    cfg = _uniform_many_hits()
    cfg = dict(cfg, extra_hits=[[cfg["n_contigs"] - 1, 0.01]])
    db = generate.make_database(cfg, 7)
    s = generate.make_sample(cfg, db, 7, 0, 50_000)
    runs = np.bincount(s["read_id"])
    assert runs.max() == cfg["n_contigs"]
    for r in np.flatnonzero(runs == runs.max())[:3]:
        assert sorted(s["rid"][s["read_id"] == r]) == list(range(300))


def _without(cfg, *keys):
    return {k: v for k, v in cfg.items() if k not in keys}


@pytest.mark.parametrize("case", [
    "taxon_sizes_and_genomes_per_species", "taxon_sizes_and_taxa_per_parent",
    "genomes_per_species_alone", "taxa_per_parent_alone",
    "extra_hits_and_multi_share", "extra_hits_and_partner_ranks",
    "skewed_without_extra_hits", "k_past_the_other_genomes",
    "shares_past_one", "genomes_not_n_contigs", "a_rank_missing"])
def test_conflicting_or_broken_keys_raise(case):
    uniform = _config("genus50")
    skewed = _skewed()
    cfg = {
        "taxon_sizes_and_genomes_per_species": dict(
            _without(skewed, "taxa_per_parent"),
            taxon_sizes=uniform["taxon_sizes"]),
        "taxon_sizes_and_taxa_per_parent": dict(
            _without(uniform, "multi_share", "partner_ranks"),
            taxa_per_parent=SKEWED["taxa_per_parent"],
            extra_hits=SKEWED["extra_hits"]),
        "genomes_per_species_alone": _without(skewed, "taxa_per_parent"),
        "taxa_per_parent_alone": _without(skewed, "genomes_per_species"),
        "extra_hits_and_multi_share": dict(uniform, extra_hits=[[1, 0.1]]),
        "extra_hits_and_partner_ranks": dict(
            _without(uniform, "multi_share"), extra_hits=[[1, 0.1]]),
        "skewed_without_extra_hits": dict(
            _without(skewed, "extra_hits"), multi_share=0.1,
            partner_ranks=["species", "genus"]),
        "k_past_the_other_genomes": dict(skewed, extra_hits=[[2000, 0.1]]),
        "shares_past_one": dict(skewed, extra_hits=[[1, 0.6], [2, 0.5]]),
        "genomes_not_n_contigs": dict(skewed, n_contigs=2001),
        "a_rank_missing": dict(skewed, taxa_per_parent=_without(
            SKEWED["taxa_per_parent"], "order")),
    }[case]
    with pytest.raises(ValueError):
        db = generate.make_database(cfg, 3)
        generate.make_sample(cfg, db, 3, 0, 10_000)


def test_cut_down_skewed_deployment_is_correct_with_the_host_plan():
    """The core traffic over SKEWED on the CPU: correct, and every call's
    records (reads of up to 16) planned on the host."""
    from slimm_tpu_torch.engine import pipeline

    c = spec.load_cell("refseq50k.core")
    c = dataclasses.replace(c, name="skewed.core", config=_skewed())
    out = cell_mod.run_cell(c, seed=SEEDS[1], seconds=0.5, trace=False,
                            device="cpu", t_start=time.perf_counter(),
                            records=RECORDS, engine={"phase_log": False})
    assert out["correct"] is True, out["checks"]
    calls = out["info"]["calls"]
    assert calls >= 2
    assert pipeline.work_counts["host_plans"] == calls
    assert pipeline.work_counts["device_plans"] == 0
    assert pipeline.work_counts["lca_taxa"] > 0
