"""Batched directory profiles, the entry points' default device, and the
last host copies: slimm_tpu_torch against slimm_tpu on the CPU.

`profile_files_batched` lays a group of files end to end as one profile;
each file's state must equal what slimm_tpu's `profile_files_batched` (one
lax.scan per group) gives it, exactly.  `misc_compat` and
`tools/preprocess` are the port's own copies, held to their originals on
the cases of tests/test_misc_compat.py and tests/test_preprocess.py."""

import copy
import dataclasses
import filecmp
import gzip
import io
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from slimm_tpu import misc_compat as jmisc
from slimm_tpu.cli import main as jax_main
from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.engine.pipeline import \
    profile_files_batched as jax_profile_files_batched
from slimm_tpu.tools import preprocess as jpre
from slimm_tpu_torch import cli as tcli
from slimm_tpu_torch import misc_compat as tmisc
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.parallel import ShardedRunner
from slimm_tpu_torch.tools import preprocess as tpre

from tests.test_engine import assert_states_equal
from tests.test_torch_host import to_port
from tests.toy import build_toy_db, make_records, write_sam

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mix(d, k, n=150, seed=21):
    """File k of tests/test_engine.py's batched mix: its own read length
    (hence auto bin width), every 7th read multi-mapped."""
    rng = np.random.default_rng(seed + k)
    records = []
    for i in range(n + 40 * k):
        rid = int(rng.integers(0, 5))
        records.append((f"f{k}_r{i}", 0, rid, int(rng.integers(0, 2500)),
                        100 + 10 * k))
        if i % 7 == 0:
            records.append((f"f{k}_r{i}", 0, (rid + 2) % 5,
                            int(rng.integers(0, 2500)), 100 + 10 * k))
    return write_sam(d, records, name=f"batch{k}.sam")


def _empty(d):
    return write_sam(d, [(f"u{i}", 0x4, -1, -1, 100) for i in range(20)],
                     name="empty.sam")


def _other_header(d):
    """A toy SAM whose first contig is one base longer."""
    path = write_sam(d, make_records(n_extra=200, seed=4), name="other.sam")
    text = open(path).read()
    head, _, rest = text.partition("\tLN:")
    length, _, tail = rest.partition("\n")
    with open(path, "w") as f:
        f.write(f"{head}\tLN:{int(length) + 1}\n{tail}")
    return path


GROUPS = {
    "mix3": lambda d: [_mix(d, k) for k in range(3)],
    "with_empty": lambda d: [_mix(d, 0), _empty(d), _mix(d, 2)],
    "all_empty": lambda d: [_empty(d)],
    "headers_differ": lambda d: [_mix(d, 1), _other_header(d)],
    "one_file": lambda d: [_mix(d, 2)],
    "toy_and_mix": lambda d: [write_sam(d, make_records(n_extra=500, seed=3),
                                        name="toy.sam"), _mix(d, 1)],
    # one multi-mapped read, id 0, then a file whose first read is id 0 too:
    # the two must stay two reads
    "one_read_first": lambda d: [write_sam(d, [("solo", 0, 2, 100, 100),
                                               ("solo", 0, 3, 200, 100)],
                                           name="solo.sam"), _mix(d, 1)],
}


def _assert_equal(st_j, st_t, fetch_coverage):
    if fetch_coverage or st_j.hits_count == 0:
        assert_states_equal(st_j, st_t)
        return
    assert st_t.cov is None and st_t.uniq_cov2 is None
    for name in ("hits_count", "matches_count", "uniq_matches_count",
                 "uniq_matches_count2"):
        assert getattr(st_j, name) == getattr(st_t, name), name
    np.testing.assert_array_equal(st_j.reads_count, st_t.reads_count)
    np.testing.assert_array_equal(st_j.uniq_reads_count2,
                                  st_t.uniq_reads_count2)
    assert st_j.valid_ref_ids == st_t.valid_ref_ids
    assert st_j.taxon_id__read_count == st_t.taxon_id__read_count
    assert st_j.taxon_id__children == st_t.taxon_id__children
    assert st_j.abundance_rows() == st_t.abundance_rows()


@pytest.mark.parametrize("fetch_coverage", [True, False],
                         ids=["coverage", "no_coverage"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_batched_states_match_slimm_tpu(group, fetch_coverage, toy_dir,
                                        tmp_path, capsys):
    paths = GROUPS[group](str(tmp_path))
    db = build_toy_db(toy_dir)
    eng = EngineOptions(phase_log=False, fetch_coverage=fetch_coverage)
    capsys.readouterr()
    want = jax_profile_files_batched(ProfileOptions(), copy.deepcopy(db),
                                     paths, engine=eng)
    err_j = capsys.readouterr().err
    tp.reset_path_counts()
    got = tp.profile_files_batched(ProfileOptions(), to_port(db), paths,
                                   device=CPU, engine=to_port(eng))
    err_t = capsys.readouterr().err
    assert [p for p, _ in got] == [p for p, _ in want] == paths
    for (_, st_j), (_, st_t) in zip(want, got):
        _assert_equal(st_j, st_t, fetch_coverage)
    # the warnings, in the same order
    assert err_t == err_j
    differ = group == "headers_differ"
    assert tp.path_counts["batched_fallback_per_file"] == int(differ)
    assert tp.path_counts["batched_groups"] == int(
        not differ and group != "all_empty")


def test_batched_group_launches_each_histogram_once(toy_dir, tmp_path,
                                                    monkeypatch):
    # one pass A, one pass B and one pair presence for the whole group, over
    # the group's domains
    from slimm_tpu_torch.database import tensorize

    calls = []

    def recorder(name):
        fn = getattr(tp, name)

        def rec(*args):
            calls.append((name, args[-1]))
            return fn(*args)
        return rec

    for name in ("hist1", "hist2"):
        monkeypatch.setattr(tp, name, recorder(name))
    paths = GROUPS["mix3"](str(tmp_path))
    db = to_port(build_toy_db(toy_dir))
    states = [st for _, st in tp.profile_files_batched(
        ProfileOptions(), db, paths, device=CPU,
        engine=to_port(EngineOptions(phase_log=False, fetch_coverage=False)))]
    dense = tensorize(db, [c[0] for c in toy_dir.contigs])
    C, nd = len(dense.lineage), dense.n_dense
    assert len({int(st.options.bin_width) for st in states}) == 3
    assert calls == [
        ("hist2", sum(int(st.nbins.sum()) for st in states)),
        ("hist1", 3 * (C + nd)),
        ("hist1", tp._pad1024(3 * C * dense.n_pair_codes))]


def test_cli_directory_bytes_match_slimm_tpu(toy_dir, tmp_path):
    # -d batches in both packages; -ro/-co writes every report
    indir = tmp_path / "in"
    indir.mkdir()
    for k in range(3):
        _mix(str(indir), k)
    _empty(str(indir))
    db = str(tmp_path / "toy.sldb")
    build_toy_db(toy_dir).save_sldb(db)
    outs = {}
    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / tag) + "/"
        os.makedirs(out)
        tp.reset_path_counts()
        assert main(["profile", *dev, "-d", "-ro", "-co", "-o", out, db,
                     str(indir)]) == 0
        outs[tag] = out
    assert tp.path_counts["batched_groups"] == 1
    names = sorted(os.listdir(outs["jax"]))
    assert len(names) == 15
    assert names == sorted(os.listdir(outs["torch"]))
    for name in names:
        assert filecmp.cmp(outs["jax"] + name, outs["torch"] + name,
                           shallow=False), name


# -- a group's int32 domains --------------------------------------------------


@pytest.mark.parametrize("limit_of", ["reads", "bins", "records"])
def test_plan_subgroups_splits_at_each_limit(limit_of, monkeypatch):
    # sizes (reads, bins, records); one of the three sums reaches the limit
    # at file 2, and file 4 passes it alone
    monkeypatch.setattr(tp, "GROUP_LIMIT", 100)
    axis = ("reads", "bins", "records").index(limit_of)

    def size(x):
        s = [10, 10, 10]
        s[axis] = x
        return tuple(s)

    sizes = [size(40), size(60), size(1), size(20), size(101), size(5)]
    assert tp.plan_subgroups(sizes) == [[0, 1], [2, 3], [4], [5]]
    # at the limit exactly stays one group; the other two sums never cut
    assert tp.plan_subgroups([size(50), size(50)]) == [[0, 1]]
    assert tp.plan_subgroups([(10, 10, 10)] * 10) == [list(range(10))]
    assert tp.plan_subgroups([]) == []


def _stand_in_state(length, bin_width):
    """What group_tables reads of a ProfileState: one contig of `length`
    bases at `bin_width`."""
    return types.SimpleNamespace(
        lengths=np.array([length], np.int64), bin_offset=np.zeros(1, np.int64),
        nbins=np.array([length // bin_width + 1], np.int64),
        avg_read_length=100)


@pytest.mark.parametrize("files,past", [(1, 2**31), (2, 2**31), (3, 2**32)])
def test_group_tables_raise_instead_of_wrapping(files, past):
    # contigs of 4e9 bp at bin width 2 (one file: width 1), 2e9 + 1 bins a
    # file: the group's last bin end passes 2^31 or 2^32, where numpy's
    # int32 cast would wrap it to a negative end, or past 2^32 to a
    # positive, silently wrong one
    import re

    from slimm_tpu_torch.config import ProfileOptions as TProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase, tensorize
    from slimm_tpu_torch.tables import group_tables

    width = 1 if files == 1 else 2
    states = [_stand_in_state(4_000_000_000, width) for _ in range(files)]
    assert sum(int(st.nbins[0]) for st in states) > past
    db = SlimmDatabase()
    db.ac__taxid["c1"] = [9, 8, 7, 6, 5, 4, 3, 2]
    for lvl, tid in enumerate(db.ac__taxid["c1"]):
        db.taxid__name[tid] = (lvl, f"t{tid}")
    with pytest.raises(OverflowError, match="passes int32") as e:
        group_tables(states, [TProfileOptions(bin_width=width)] * files,
                     tensorize(db, ["c1"]), CPU)
    assert int(re.search(r"bin (\d+)", str(e.value)).group(1)) > 2**31 - 1


@pytest.mark.parametrize("limit,groups,alone", [(None, 1, 0), (720, 2, 0),
                                                (100, 0, 3)])
def test_cli_directory_splits_past_group_limit(limit, groups, alone, toy_dir,
                                               tmp_path, monkeypatch):
    # -d over the toy directory with GROUP_LIMIT lowered: at 720 the three
    # files (376, 339 and 313 bins) make two sub-groups, at 100 each file
    # passes it alone and is profiled by profile_file; the bytes stay
    # slimm_tpu's -d
    indir = tmp_path / "in"
    indir.mkdir()
    for k in range(3):
        _mix(str(indir), k)
    _empty(str(indir))
    db = str(tmp_path / "toy.sldb")
    build_toy_db(toy_dir).save_sldb(db)
    outs, alone_calls = {}, []
    profile_file = tp.profile_file

    def counted(*args, **kw):
        alone_calls.append(args[2])
        return profile_file(*args, **kw)

    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / tag) + "/"
        if tag == "torch":
            monkeypatch.setattr(tp, "profile_file", counted)
            if limit is not None:
                monkeypatch.setattr(tp, "GROUP_LIMIT", limit)
        tp.reset_path_counts()
        assert main(["profile", *dev, "-d", "-o", out, db, str(indir)]) == 0
        outs[tag] = out
    assert tp.path_counts["batched_groups"] == groups
    assert len(alone_calls) == alone
    names = sorted(os.listdir(outs["jax"]))
    assert len(names) == 3 and names == sorted(os.listdir(outs["torch"]))
    for name in names:
        assert filecmp.cmp(outs["jax"] + name, outs["torch"] + name,
                           shallow=False), name


@pytest.mark.parametrize("limit,points", [
    (None, ["cutoffs"]),
    (720, ["cutoffs"] * 2)])
def test_batched_host_marks_in_order(limit, points, toy_dir, tmp_path,
                                     monkeypatch):
    # the host clock after the cutoffs' sync, once per (sub-)group; off
    # (None) unless a caller sets a list
    paths = GROUPS["mix3"](str(tmp_path)) + [_empty(str(tmp_path))]
    db = to_port(build_toy_db(toy_dir))
    eng = to_port(EngineOptions(phase_log=False, fetch_coverage=False))
    if limit is not None:
        monkeypatch.setattr(tp, "GROUP_LIMIT", limit)
    assert tp.host_marks is None
    monkeypatch.setattr(tp, "host_marks", [])
    marks = tp.host_marks
    tp.profile_files_batched(ProfileOptions(), db, paths, device=CPU,
                             engine=eng)
    assert [p for p, _ in marks] == points
    times = [t for _, t in marks]
    assert times == sorted(times)


# -- the entry points run on the card unless asked ---------------------------


def test_entry_points_default_to_the_card(toy_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = to_port(build_toy_db(toy_dir))
    sam = toy_dir.sam_path
    af = tp.open_alignment_file(sam)
    b = af.load()
    calls = {
        "profile_file": lambda **kw: tp.profile_file(
            ProfileOptions(), db, sam, **kw),
        "profile_file_streaming": lambda **kw: tp.profile_file_streaming(
            ProfileOptions(), db, sam, **kw),
        "profile_files_batched": lambda **kw: tp.profile_files_batched(
            ProfileOptions(), db, [sam, sam], **kw)[0][1],
        "profile_arrays": lambda **kw: tp.profile_arrays(
            ProfileOptions(), db, af.contig_names, af.contig_lengths,
            b.read_id.astype(np.int32), b.rid, b.pos, b.n_reads,
            b.hits_count, b.avg_read_length, **kw),
    }
    eng = to_port(EngineOptions(phase_log=False))
    for name, call in calls.items():
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError,
                               match=r'no CUDA device is available \(pass '
                                     r'device="cpu"'):
                call(engine=eng, **kw)
        st = call(engine=eng, device="cpu")
        assert st.hits_count > 0 and st.abundance_rows(), name
    with pytest.raises(ValueError, match="exactly one"):
        tp.profile_file(ProfileOptions(), db, sam, device="cpu",
                        sharded_runner=ShardedRunner(devices=[["cpu"]]))


# -- misc_compat and tools/preprocess: the port's copies ---------------------


NODES = {1: (1, "no rank"), 2: (1, "superkingdom"), 1224: (2, "phylum"),
         1236: (1224, "class"), 543: (1236, "family"), 561: (543, "genus"),
         562: (561, "species"), 620: (543, "genus"), 622: (620, "species"),
         1239: (2, "phylum"), 1396: (1239, "species")}

MISC_CASES = [
    ("mean", ([1.0, 2.0, 3.0, 4.0],)), ("mean", ([1, 2, 3, 4],)),
    ("variance", ([1.0, 2.0, 3.0, 4.0], 2.5)), ("variance", ([1, 2, 3, 5],)),
    ("std_dev", ([1.0, 2.0, 3.0, 4.0],)),
    ("median", ([1.0, 2.0, 3.0, 4.0],)), ("median", ([1.0, 2.0, 10.0],)),
    ("median", ([5, 1, 3, 7],)), ("median", ([5, 1, 3],)),
    ("calculate_alignment_score", ("10M", 2, 10)),
    ("calculate_alignment_score", ("3M2I4M1D", 1, 10)),
    ("calculate_alignment_score", ([("M", 5), ("I", 3)], 0, 8)),
    ("get_lca_tree", ({562, 561}, NODES)), ("get_lca_tree", ({562, 622}, NODES)),
    ("get_lca_tree", ({562, 1396}, NODES)),
    ("get_lca_tree", ({10, 11}, {10: (99, "species"), 11: (98, "species")})),
    ("get_lca_tree", ({562, 622, 1396}, NODES, {562, 622})),
    ("get_lca_tree", (set(), NODES)),
    ("get_lca_tree_list", ([562, 562], NODES)),
    ("get_lca_tree_list", ([562, 622, 1396], NODES)),
    ("get_taxon_id", ("NC_1|kraken:taxid|562", "kraken:taxid")),
    ("get_taxon_id", ("gi|5|ti|1396|x", "ti")),
    ("get_taxon_id", ("plain_name", "ti")),
    ("get_taxon_id_pos", ("a|ti|7",)), ("get_taxon_id_pos", ("a|kraken:taxid|7",)),
]


@pytest.mark.parametrize("name,args", MISC_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(MISC_CASES)])
def test_misc_compat_equal(name, args):
    got = getattr(tmisc, name)(*copy.deepcopy(args))
    want = getattr(jmisc, name)(*copy.deepcopy(args))
    assert type(got) is type(want) and got == want


def test_misc_compat_exits_alike(capsys):
    errs = []
    for mod in (jmisc, tmisc):
        with pytest.raises(SystemExit) as e:
            mod.get_taxon_id_pos("no_marker_here")
        errs.append((e.value.code, capsys.readouterr().err))
    assert errs[0] == errs[1] and errs[0][0] == 1


def _cand(mod, level="Contig", category="na", taxid="7"):
    return mod.AssemblyCandidate(level=level, date="2020/01/01", url="u",
                                 taxid_str=taxid, category=category)


SELECT_CASES = [
    (7, [("Contig",), ("Complete Genome",),
         ("Scaffold", "representative genome"),
         ("Chromosome", "reference genome")]),
    (7, [("Contig",), ("Complete Genome",),
         ("Scaffold", "representative genome")]),
    (7, [("Chromosome",), ("Complete Genome",)]),
    (7, [("Chromosome",)]),
    (7, [("Scaffold", "na", "7"), ("Contig", "na", "8")]),
    (7, [("Contig", "na", "8"), ("Scaffold", "na", "7")]),
    (9, [("Scaffold", "na", "8")]),
    (9, []),
]

SUMMARY = ("\t".join(["GCF_1", "x", "x", "x", "reference genome", "101",
                      "101", "x", "x", "x", "latest", "Complete Genome", "x",
                      "2020", "x", "x", "x", "x", "x", "ftp://h/g/GCF_1"])
           + "\n")
NODES_DMP = ["7\t|\t6\t|\tspecies\t|\n", "6\t|\t1\t|\tgenus\t|\n",
             "9\t|\t8\t|\tspecies\t|\n", "101\t|\t100\t|\tspecies\t|\n",
             "100\t|\t1\t|\tgenus\t|\n"]
NAMES_DMP = ["7\t|\tEsch coli\t|\t\t|\tscientific name\t|\n",
             "6\t|\tEscherichia\t|\t\t|\tscientific name\t|\n",
             "101\t|\tSp one\t|\t\t|\tscientific name\t|\n"]


def test_preprocess_selection_and_parsing_equal():
    for taxid, cands in SELECT_CASES:
        got = tpre.select_genome(taxid, [_cand(tpre, *c) for c in cands])
        want = jpre.select_genome(taxid, [_cand(jpre, *c) for c in cands])
        assert (got is None and want is None) or (
            dataclasses.asdict(got) == dataclasses.asdict(want))
    cats = ["B\t100\t101\n", "V\t200\t201\n", "E\t300\t301\n"]
    for mod_args in (("AB", [300]), ("B", []), ("V", [101])):
        assert tpre.parse_categories(cats, *mod_args) == \
            jpre.parse_categories(cats, *mod_args)
    initial = jpre.parse_categories(cats, "AB", [300])
    lines = ["#header\n", SUMMARY, SUMMARY.replace("latest", "replaced")]
    for species_level in (False, True):
        got = tpre.parse_assembly_summary(lines, initial, species_level)
        want = jpre.parse_assembly_summary(lines, initial, species_level)
        assert {k: [dataclasses.asdict(c) for c in v] for k, v in got.items()} \
            == {k: [dataclasses.asdict(c) for c in v] for k, v in want.items()}
    got = tpre.build_plan(["B\t100\t101\n"], lines, NODES_DMP, NAMES_DMP, "B")
    want = jpre.build_plan(["B\t100\t101\n"], lines, NODES_DMP, NAMES_DMP, "B")
    assert 101 in got.selections
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_preprocess_taxonomy_and_merge_bytes_equal(tmp_path, capsys):
    outs = {}
    genomes = tmp_path / "genomes"
    genomes.mkdir()
    for taxid in (7, 42):
        with gzip.open(genomes / f"{taxid}.fna.gz", "wt") as f:
            f.write(f">ACC{taxid}.1 first contig\nACGTACGTAC\nGGGG\n")
            f.write(">ACC2.1 plasmid pXYZ\nTTTT\n")
            f.write(">ACC3.1 second contig\nCCCC\n")
    for tag, mod in (("jax", jpre), ("torch", tpre)):
        d = tmp_path / tag
        d.mkdir()
        parent, rank, names = mod.load_taxonomy_dmp(NODES_DMP, NAMES_DMP)
        keep = mod.reduce_taxonomy({7: 1, 9: 1, 101: 1}, parent, rank, names)
        mod.write_reduced_dmp(keep, parent, rank, names, str(d / "nodes.dmp"),
                              str(d / "names.dmp"))
        buf = io.StringIO()
        counts = mod.merge_genome_file(str(genomes / "42.fna.gz"), "42", buf)
        total = mod.merge_genomes(str(genomes), str(d / "combined.fna"))
        outs[tag] = (keep, counts, total, buf.getvalue(),
                     capsys.readouterr().err)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == (2, 1) and outs["torch"][2] == 4
    for name in ("nodes.dmp", "names.dmp", "combined.fna"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "torch" / name,
                           shallow=False), name


def test_preprocess_runs_as_a_module_without_jax():
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['slimm_tpu'] = None; "
            "sys.argv = ['preprocess', '--help']; "
            "runpy.run_module('slimm_tpu_torch.tools.preprocess', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "download" in proc.stdout and "merge" in proc.stdout
