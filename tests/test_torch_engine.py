"""The port's slice as a whole: slimm_tpu_torch's profile_file and CLI
against the scalar oracle, slimm_tpu's engine and slimm_tpu's CLI, on the
toy datasets, a few fuzz cases and the golden fixture.  States are compared
with tests.test_engine.assert_states_equal and reports byte for byte."""

import copy
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slimm_tpu.cli import main as jax_main
from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.engine import profile_file as jax_profile_file
from slimm_tpu.engine import reports as jax_reports
from slimm_tpu.io import AlignmentFile
from slimm_tpu.oracle import OracleProfiler
from slimm_tpu_torch import cli as tcli
from slimm_tpu_torch import oracle as toracle
from slimm_tpu_torch.config import EngineOptions as TEngineOptions
from slimm_tpu_torch.config import ProfileOptions as TProfileOptions
from slimm_tpu_torch.engine import reports as treports
from slimm_tpu_torch.engine.pipeline import profile_arrays, profile_file

from tests import golden_adeno as GA
from tests.test_engine import assert_states_equal
from tests.test_torch_host import _raw_stream, to_port
from tests.test_fuzz import gen_case
from tests.toy import build_toy_dataset, build_toy_db, make_records, write_sam

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _oracle(db, sam, options, profiler=OracleProfiler):
    af = AlignmentFile(sam)
    return profiler(copy.deepcopy(options), copy.deepcopy(db).ac__taxid,
                    copy.deepcopy(db).taxid__name,
                    list(zip(af.contig_names, af.contig_lengths.tolist()))
                    ).run(af.raw_records())


def _three_ways(db, sam, options=None, fetch_coverage=True):
    """(oracle, slimm_tpu engine, port) states of one SAM file."""
    options = options or ProfileOptions()
    eng = EngineOptions(phase_log=False, fetch_coverage=fetch_coverage)
    st_o = _oracle(db, sam, options)
    st_j = jax_profile_file(copy.deepcopy(options), copy.deepcopy(db), sam,
                            engine=eng)
    st_t = profile_file(to_port(options), to_port(db), sam, device=CPU,
                        engine=to_port(eng))
    return st_o, st_j, st_t


def _duplicate_heavy():
    rng = np.random.default_rng(5)
    records = []
    for k in range(200):
        rid = int(rng.integers(0, 5))
        for _ in range(int(rng.integers(1, 5))):
            records.append((f"r{k % 37}", 0, rid, int(rng.integers(0, 3000)),
                            100))
    return records


def _long_runs():
    # reads hitting all 6 contigs: the doubling-scan plan
    rng = np.random.default_rng(9)
    records = [(f"m{k}", 0, rid, int(rng.integers(0, 2500)), 100)
               for k in range(40) for rid in range(6)]
    records += [(f"u{k}", 0, k % 5, int(rng.integers(0, 2500)), 100)
                for k in range(150)]
    return records


def _no_agreeing_level():
    records = list(make_records())
    for k in range(12):
        records.append((f"m_noagree_{k}", 0, 0, 100 + 50 * k, 100))
        records.append((f"m_noagree_{k}", 0, 5, 30 + 20 * k, 100))
    return records


RECORD_CASES = {
    "toy": (None, ProfileOptions()),
    "toy_cc1": (None, ProfileOptions(cov_cut_off=1.0)),
    "toy_genus": (None, ProfileOptions(rank="genus")),
    "duplicate_heavy": (_duplicate_heavy, ProfileOptions()),
    "long_runs": (_long_runs, ProfileOptions()),
    "no_agreeing_level": (_no_agreeing_level, ProfileOptions()),
}


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_profile_file_matches_oracle_and_jax(case, toy_dir):
    make, options = RECORD_CASES[case]
    db = build_toy_db(toy_dir)
    sam = (toy_dir.sam_path if make is None
           else write_sam(toy_dir.dir, make(), name=f"torch_{case}.sam"))
    st_o, st_j, st_t = _three_ways(db, sam, options)
    assert_states_equal(st_o, st_t)
    assert_states_equal(st_j, st_t)


def test_profile_file_large_random(tmp_path):
    ds = build_toy_dataset(str(tmp_path), n_extra=3000, seed=123)
    st_o, st_j, st_t = _three_ways(build_toy_db(ds), ds.sam_path)
    assert_states_equal(st_o, st_t)
    assert_states_equal(st_j, st_t)


def test_profile_file_no_coverage_fetch(toy_dir):
    # the default CLI run: per-contig counters only, no bin histograms
    db = build_toy_db(toy_dir)
    st_o, st_j, st_t = _three_ways(db, toy_dir.sam_path, fetch_coverage=False)
    assert st_t.cov is None and st_t.uniq_cov2 is None
    for st in (st_o, st_j):
        np.testing.assert_array_equal(st.reads_count, st_t.reads_count)
        np.testing.assert_array_equal(st.uniq_reads_count2,
                                      st_t.uniq_reads_count2)
        assert st.valid_ref_ids == st_t.valid_ref_ids
        assert st.taxon_id__read_count == st_t.taxon_id__read_count
        assert st.taxon_id__children == st_t.taxon_id__children
        assert st.abundance_rows() == st_t.abundance_rows()


@pytest.mark.parametrize("records", ["window", "wide_span"])
def test_raw_records_device_and_host_dedup(records, toy_dir):
    # deduped=False: first-hit dedup on the device within the shift window,
    # on the host past it (pipeline.py:1102-1118)
    rng = np.random.default_rng(11 if records == "window" else 13)
    recs = []
    if records == "window":
        for k in range(120):
            rid = int(rng.integers(0, 5))
            recs.append((f"d{k}", 0, rid, int(rng.integers(0, 2500)), 100))
            if k % 3 == 0:
                recs.append((f"d{k}", 0, rid, int(rng.integers(0, 2500)), 100))
            if k % 4 == 0:
                recs.append((f"d{k}", 0, (rid + 1) % 5,
                             int(rng.integers(0, 2500)), 100))
    else:
        for k in range(60):
            for rid in [0, 1, 2, 3, 4, 0]:
                recs.append((f"w{k}", 0, rid, int(rng.integers(0, 2500)), 100))
        recs += [(f"u{k}", 0, k % 5, int(rng.integers(0, 2500)), 100)
                 for k in range(150)]
    db = build_toy_db(toy_dir)
    sam = write_sam(toy_dir.dir, recs, name=f"torch_raw_{records}.sam")
    af = AlignmentFile(sam)
    batch = af.load(dedup=False)
    st_t = profile_arrays(
        TProfileOptions(), to_port(db), af.contig_names,
        af.contig_lengths, batch.read_id.astype(np.int32), batch.rid,
        batch.pos, batch.n_reads, batch.hits_count, batch.avg_read_length,
        device=CPU, engine=TEngineOptions(phase_log=False), deduped=False)
    assert_states_equal(_oracle(db, sam, ProfileOptions()), st_t)


FUZZ_SEEDS = [10_000, 10_003, 10_006, 10_011, 10_017, 10_024]


@pytest.mark.parametrize("path", ["whole_file", "overlap", "stream_v2",
                                  "stream_v1", "sharded_2x2"])
@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_cases_match_oracle(seed, path, tmp_path, toy_dir, monkeypatch):
    # each case through the whole-file path, the overlap path (pieces of
    # 2,048 targets), chunk streaming (v2 pieces; v1 chunks of 64) and the
    # whole-file path over a (2, 2) grid of the CPU
    from slimm_tpu_torch.engine import pipeline as tp
    from slimm_tpu_torch.parallel import ShardedRunner

    records, options = gen_case(np.random.default_rng(seed))
    db = build_toy_db(toy_dir)
    sam = write_sam(str(tmp_path), records, name=f"fuzz_{seed}.sam")
    st_o = _oracle(db, sam, options)
    tp.reset_path_counts()
    if path.startswith("stream"):
        if path == "stream_v1":
            monkeypatch.setattr(tp, "V2_MAX_BIN", 0)
        st_t = tp.profile_file_streaming(
            to_port(options), to_port(db), sam, device=CPU,
            engine=TEngineOptions(phase_log=False), chunk_targets=64)
        assert tp.path_counts["stream_files"] == 1
    elif path == "sharded_2x2":
        st_t = profile_file(
            to_port(options), to_port(db), sam,
            engine=TEngineOptions(phase_log=False),
            sharded_runner=ShardedRunner(devices=[["cpu", "cpu"]] * 2))
        assert tp.path_counts["sharded_files"] == 1
    else:
        eng = TEngineOptions(phase_log=False,
                             overlap_min_bytes=int(path == "overlap"),
                             overlap_piece_targets=2048)
        st_t = profile_file(to_port(options), to_port(db), sam, device=CPU,
                            engine=eng)
        assert tp.path_counts["overlap_files"] == int(path == "overlap")
    if st_o.hits_count == 0:
        assert st_t.hits_count == 0
        return
    assert_states_equal(st_o, st_t)


def test_fuzz_cases_batched_match_oracle(tmp_path, toy_dir):
    # the six seeds' files as one group: one header, so one profile
    from slimm_tpu_torch.engine import pipeline as tp

    db = build_toy_db(toy_dir)
    paths = [write_sam(str(tmp_path), gen_case(np.random.default_rng(seed))[0],
                       name=f"fuzz_{seed}.sam") for seed in FUZZ_SEEDS]
    tp.reset_path_counts()
    got = tp.profile_files_batched(ProfileOptions(), to_port(db), paths,
                                   device=CPU,
                                   engine=TEngineOptions(phase_log=False))
    assert tp.path_counts["batched_groups"] == 1
    assert [p for p, _ in got] == paths
    for path, st_t in got:
        st_o = _oracle(db, path, ProfileOptions())
        if st_o.hits_count == 0:
            assert st_t.hits_count == 0
            continue
        assert_states_equal(st_o, st_t)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_cases_match_native_baseline(seed, tmp_path, toy_dir):
    # tests/test_fuzz.py's check_native_baseline over the port alone: the
    # port's counters on each case equal the port's own single-core C++
    # baseline (native.baseline_profile) on the raw mapped-record stream,
    # read keys interned in order of first appearance
    from slimm_tpu_torch.database import tensorize
    from slimm_tpu_torch.io import AlignmentFile as TAlignmentFile
    from slimm_tpu_torch.io import native

    records, options = gen_case(np.random.default_rng(seed))
    db = to_port(build_toy_db(toy_dir))
    sam = write_sam(str(tmp_path), records, name=f"fuzz_{seed}.sam")
    st = profile_file(to_port(options), copy.deepcopy(db), sam, device=CPU,
                      engine=TEngineOptions(phase_log=False))
    af = TAlignmentFile(sam)
    raw, n_reads = _raw_stream(sam, TAlignmentFile)
    if not len(raw):
        assert st.hits_count == 0
        return
    oracle = toracle.OracleProfiler(
        to_port(options), copy.deepcopy(db).ac__taxid,
        copy.deepcopy(db).taxid__name,
        list(zip(af.contig_names, af.contig_lengths.tolist())))
    oracle.run(af.raw_records())
    _, counters = native.baseline_profile(
        raw[:, 0], raw[:, 1], raw[:, 2], n_reads, af.contig_lengths,
        tensorize(copy.deepcopy(db), af.contig_names).lineage,
        st.avg_read_length, bin_width=options.bin_width or st.avg_read_length,
        cov_cut_off=options.cov_cut_off)
    assert counters == dict(
        hits=st.hits_count, matches=st.matches_count,
        uniq_matches=st.uniq_matches_count,
        uniq_matches2=st.uniq_matches_count2,
        n_valid_refs=len(st.valid_ref_ids),
        lca_total=sum(1 for t in oracle.reads.values() if len(t) > 1),
        cov_mass=int(st.cov.sum()), uniq_cov2_mass=int(st.uniq_cov2.sum()))


def test_deep_bin_counts_exact():
    # 70,000 reads centered in ONE bin: int32 counts, no 16-bit fields
    from slimm_tpu_torch.database import SlimmDatabase

    n = 70_000
    lineage = [9, 8, 7, 6, 5, 4, 3, 2]
    db = SlimmDatabase()
    db.ac__taxid["c1"] = list(lineage)
    for lvl, tid in enumerate(lineage):
        db.taxid__name.setdefault(tid, (lvl, f"t{tid}"))
    st = profile_arrays(TProfileOptions(), db, ["c1"],
                        np.array([500], np.int64),
                        np.arange(n, dtype=np.int32), np.zeros(n, np.int32),
                        np.zeros(n, np.int32), n, n, 100, device=CPU,
                        engine=TEngineOptions(phase_log=False))
    assert int(st.cov[0]) == n and int(st.cov.sum()) == n
    assert int(st.uniq_cov[0]) == n
    assert int(st.reads_count[0]) == n == st.uniq_matches_count


@pytest.mark.skipif(not os.path.exists(GA.REFERENCE_FASTA),
                    reason="reference example data not available")
def test_golden_bytes(tmp_path):
    ds = GA.write_inputs(str(tmp_path / "in"))
    db = GA.build_adeno_db(ds)
    opts = TProfileOptions(raw_output=True, coverage_output=True)
    st = profile_file(opts, to_port(db), ds.sam_path, device=CPU,
                      engine=TEngineOptions(phase_log=False))
    out = str(tmp_path / "out") + "/"
    treports.write_abundance(st, out, ds.sam_path)
    treports.write_raw_stat(st, out, ds.sam_path)
    treports.write_coverage(st, out, ds.sam_path)
    for name in ("adeno-reads_profile.tsv", "adeno-reads_raw.tsv",
                 "adeno-reads_coverage.tsv", "adeno-reads_uniq_coverage.tsv",
                 "adeno-reads_uniq_coverage2.tsv"):
        assert filecmp.cmp(out + name, os.path.join(GA.GOLDEN_DIR, name),
                           shallow=False), name


def test_report_writers_are_byte_identical(toy_dir, tmp_path):
    # each package's writers on its own oracle's state
    options = ProfileOptions(raw_output=True, coverage_output=True)
    db = build_toy_db(toy_dir)
    states = {"jax": _oracle(db, toy_dir.sam_path, options),
              "torch": _oracle(to_port(db), toy_dir.sam_path,
                               to_port(options), toracle.OracleProfiler)}
    for tag, mod in (("jax", jax_reports), ("torch", treports)):
        st = states[tag]
        out = str(tmp_path / tag) + "/"
        mod.write_abundance(st, out, toy_dir.sam_path)
        mod.write_raw_stat(st, out, toy_dir.sam_path)
        mod.write_coverage(st, out, toy_dir.sam_path)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 5 and names == sorted(os.listdir(tmp_path / "torch"))
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "torch" / name,
                           shallow=False), name


# -- CLI ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def built_db(toy_dir):
    out = os.path.join(toy_dir.dir, "torch_cli.sldb")
    assert tcli.main(["build", "-nm", toy_dir.names_path, "-nd",
                      toy_dir.nodes_path, "-o", out, toy_dir.fasta_path,
                      toy_dir.acc2taxid_path]) == 0
    return out


def test_build_matches_slimm_tpu_build(built_db, toy_dir, tmp_path):
    ref = str(tmp_path / "jax.sldb")
    assert jax_main(["build", "-nm", toy_dir.names_path, "-nd",
                     toy_dir.nodes_path, "-o", ref, toy_dir.fasta_path,
                     toy_dir.acc2taxid_path]) == 0
    assert filecmp.cmp(built_db, ref, shallow=False)


CLI_CASES = {"default": [], "raw_and_coverage": ["-ro", "-co"],
             "verbose_json": ["-v", "--json-stats", "{out}stats.jsonl"]}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_tsv_bytes_match_slimm_tpu(case, built_db, toy_dir, tmp_path):
    outs = {}
    for tag, main in (("jax", jax_main), ("torch", tcli.main)):
        out = str(tmp_path / tag) + "/"
        os.makedirs(out)
        extra = [a.format(out=out) for a in CLI_CASES[case]]
        argv = ["profile", *extra, "-o", out, built_db, toy_dir.sam_path]
        if tag == "torch":
            argv.insert(1, "--device=cpu")
        assert main(argv) == 0
        outs[tag] = out
    names = sorted(os.listdir(outs["jax"]))
    assert "toy-reads_profile.tsv" in names
    assert names == sorted(os.listdir(outs["torch"]))
    for name in names:
        assert filecmp.cmp(outs["jax"] + name, outs["torch"] + name,
                           shallow=False), name


@pytest.mark.parametrize("extra", [[], ["-ro", "-co"], ["-d"]],
                         ids=["default", "ro_co", "directory"])
def test_cli_stream_tsv_bytes_match_slimm_tpu(extra, built_db, toy_dir,
                                              tmp_path):
    import shutil

    from slimm_tpu_torch.engine import pipeline as tp

    src = toy_dir.sam_path
    if "-d" in extra:
        src = str(tmp_path / "in")
        os.makedirs(src)
        shutil.copy(toy_dir.sam_path, os.path.join(src, "s1.sam"))
        write_sam(src, _duplicate_heavy(), name="s2.sam")
    outs = {}
    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / tag) + "/"
        os.makedirs(out)
        tp.reset_path_counts()
        assert main(["profile", *dev, "--stream", "600", *extra, "-o", out,
                     built_db, src]) == 0
        outs[tag] = out
    assert tp.path_counts["stream_files"] == (2 if "-d" in extra else 1)
    names = sorted(os.listdir(outs["jax"]))
    # one profile per input, and with -ro/-co four more reports
    assert len(names) == (2 if "-d" in extra else 5 if "-ro" in extra else 1)
    assert names == sorted(os.listdir(outs["torch"]))
    for name in names:
        assert filecmp.cmp(outs["jax"] + name, outs["torch"] + name,
                           shallow=False), name


def test_cli_directory_mode(built_db, toy_dir, tmp_path):
    import shutil

    indir = tmp_path / "in"
    indir.mkdir()
    shutil.copy(toy_dir.sam_path, indir / "s1.sam")
    write_sam(str(indir), _duplicate_heavy(), name="s2.sam")
    outs = {}
    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / tag) + "/"
        os.makedirs(out)
        assert main(["profile", *dev, "-d", "-o", out, built_db,
                     str(indir)]) == 0
        outs[tag] = out
    for name in ("s1_profile.tsv", "s2_profile.tsv"):
        assert filecmp.cmp(outs["jax"] + name, outs["torch"] + name,
                           shallow=False), name


def test_cli_no_device_runs_oracle(built_db, toy_dir, tmp_path):
    for tag, dev in (("oracle", ["--no-device"]), ("cpu", ["--device=cpu"])):
        assert tcli.main(["profile", *dev, "-o", str(tmp_path / tag) + "/",
                          built_db, toy_dir.sam_path]) == 0
    assert filecmp.cmp(tmp_path / "oracle" / "toy-reads_profile.tsv",
                       tmp_path / "cpu" / "toy-reads_profile.tsv",
                       shallow=False)


def test_cli_cuda_without_gpu_exits_1(built_db, toy_dir, tmp_path, capsys,
                                      monkeypatch):
    # the default device is cuda; with no GPU the run stops, nothing is
    # written and nothing runs on the CPU instead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o"
    assert tcli.main(["profile", "-o", str(out) + "/", built_db,
                      toy_dir.sam_path]) == 1
    assert "[ERROR] --device cuda" in capsys.readouterr().err
    assert not out.exists()


TRACE_CASES = {"alone": [], "shards_2": ["--shards", "2"],
               "model_shards_2": ["--model-shards", "2"],
               "stream": ["--stream", "600"], "directory": ["-d"]}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_cli_trace_dir(case, built_db, toy_dir, tmp_path):
    # each input's profile runs inside torch.profiler and leaves a Chrome
    # trace named after it; the profile bytes are those of the run without
    # --trace-dir.  Under -d the files are profiled one by one.
    import json
    import shutil

    from slimm_tpu_torch.engine import pipeline as tp

    src = toy_dir.sam_path
    if case == "directory":
        src = str(tmp_path / "in")
        os.makedirs(src)
        shutil.copy(toy_dir.sam_path, os.path.join(src, "s1.sam"))
        write_sam(src, _duplicate_heavy(), name="s2.sam")
    inputs = sorted(os.listdir(src)) if case == "directory" else [
        os.path.basename(src)]
    extra = TRACE_CASES[case]
    outs = {}
    for tag, trace in (("plain", []),
                       ("traced", ["--trace-dir", str(tmp_path / "tr")])):
        outs[tag] = str(tmp_path / tag) + "/"
        tp.reset_path_counts()
        assert tcli.main(["profile", "--device", "cpu", *extra, *trace,
                          "-o", outs[tag], built_db, src]) == 0
        assert tp.path_counts["batched_groups"] == int(
            case == "directory" and tag == "plain")
    names = sorted(os.listdir(outs["plain"]))
    assert len(names) == len(inputs) and names == sorted(
        os.listdir(outs["traced"]))
    for name in names:
        assert filecmp.cmp(outs["plain"] + name, outs["traced"] + name,
                           shallow=False), name
    traces = sorted(os.listdir(tmp_path / "tr"))
    assert traces == [f"{name}.pt.trace.json" for name in inputs]
    for name in traces:
        events = json.load(open(tmp_path / "tr" / name))["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)


def test_cli_trace_dir_not_writable_is_an_error(built_db, toy_dir, tmp_path,
                                                capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert tcli.main(["profile", "--device", "cpu", "--trace-dir",
                      str(blocker / "tr"), "-o", str(tmp_path / "o") + "/",
                      built_db, toy_dir.sam_path]) == 1
    assert "[ERROR]" in capsys.readouterr().err


def test_cli_collect(built_db, toy_dir, tmp_path):
    out = str(tmp_path) + "/"
    assert tcli.main(["profile", "--device", "cpu", "-o", out, built_db,
                      toy_dir.sam_path]) == 0
    import shutil
    p1, p2 = str(tmp_path / "s1_profile.tsv"), str(tmp_path / "s2_profile.tsv")
    shutil.copy(out + "toy-reads_profile.tsv", p1)
    shutil.copy(out + "toy-reads_profile.tsv", p2)
    assert tcli.main(["collect", "-o", str(tmp_path / "m.tsv"), p1, p2]) == 0
    assert jax_main(["collect", "-o", str(tmp_path / "j.tsv"), p1, p2]) == 0
    assert filecmp.cmp(tmp_path / "m.tsv", tmp_path / "j.tsv", shallow=False)


# -- nothing of JAX or of slimm_tpu on the card's machine ---------------------


def test_port_sources_import_no_jax_or_engine():
    # the port keeps its own copies of slimm_tpu's host modules: no import
    # of jax, slimm_tpu (any module) or bench.py, which imports slimm_tpu
    import re

    forbidden = re.compile(
        r"^\s*(import|from)\s+(jax|slimm_tpu|bench)\b(?!_)", re.M)
    pkg = os.path.join(REPO, "slimm_tpu_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")]
    assert len(sources) >= 20
    for module in ("misc_compat.py", "tools/preprocess.py", "cli.py",
                   "engine/pipeline.py", "tables.py",
                   "tools/profile_finalize.py", "io/native.py",
                   "utils/workload.py", "parallel/multihost.py"):
        assert os.path.join(pkg, module) in sources, module
    for path in sources + [os.path.join(REPO, "chip_smoke.py")]:
        text = open(path).read()
        assert not forbidden.search(text), path
        assert "import_module(" not in text, path
    assert forbidden.search("from slimm_tpu.io import native")
    assert forbidden.search("import slimm_tpu")
    assert not forbidden.search("from slimm_tpu_torch.io import native")


def test_toy_profile_runs_without_jax(built_db, toy_dir, tmp_path):
    # the card's machine has no JAX: with jax and slimm_tpu made
    # unimportable, the port's CLI builds the DB, profiles whole-file,
    # on the overlap path (overlap_min_bytes lowered), with --stream, a
    # directory with -d (batched) and a file with --trace-dir, and
    # collects; every file's bytes equal slimm_tpu's CLI
    ds = toy_dir
    out = str(tmp_path / "nojax") + "/"
    code = f"""
import functools, os, shutil, sys
sys.modules['jax'] = None
sys.modules['slimm_tpu'] = None
from slimm_tpu_torch import cli
from slimm_tpu_torch.engine import pipeline
out = {out!r}
db = out + 'toy.sldb'
assert cli.main(['build', '-nm', {ds.names_path!r}, '-nd', {ds.nodes_path!r},
                 '-o', db, {ds.fasta_path!r}, {ds.acc2taxid_path!r}]) == 0
runs = {{'whole': ([], 'overlap_files', 0), 'stream': (['--stream', '600'],
         'stream_files', 1), 'overlap': ([], 'overlap_files', 1)}}
for tag, (extra, counter, want) in runs.items():
    if tag == 'overlap':
        cli.EngineOptions = functools.partial(
            cli.EngineOptions, overlap_min_bytes=1, overlap_piece_targets=2048)
    pipeline.reset_path_counts()
    assert cli.main(['profile', '--device', 'cpu', *extra, '-o', out + tag,
                     db, {ds.sam_path!r}]) == 0
    assert pipeline.path_counts[counter] == want, (tag, pipeline.path_counts)
os.makedirs(out + 'dir')
for name in ('a.sam', 'b.sam'):
    shutil.copy({ds.sam_path!r}, out + 'dir/' + name)
pipeline.reset_path_counts()
assert cli.main(['profile', '--device', 'cpu', '-d', '-o', out + 'd/', db,
                 out + 'dir']) == 0
assert pipeline.path_counts['batched_groups'] == 1, pipeline.path_counts
assert cli.main(['profile', '--device', 'cpu', '--trace-dir', out + 'tr',
                 '-o', out + 'traced', db, {ds.sam_path!r}]) == 0
assert os.listdir(out + 'tr') == [
    os.path.basename({ds.sam_path!r}) + '.pt.trace.json']
assert cli.main(['collect', '-o', out + 'merged.tsv', out + 'whole_profile.tsv',
                 out + 'stream_profile.tsv']) == 0
assert not any(m in ('jax', 'slimm_tpu') or m.startswith(('jax.', 'slimm_tpu.'))
               for m in sys.modules if sys.modules[m] is not None)
"""
    os.makedirs(out)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = str(tmp_path / "ref") + "/"
    os.makedirs(ref)
    assert jax_main(["build", "-nm", ds.names_path, "-nd", ds.nodes_path,
                     "-o", ref + "toy.sldb", ds.fasta_path,
                     ds.acc2taxid_path]) == 0
    assert filecmp.cmp(out + "toy.sldb", ref + "toy.sldb", shallow=False)
    for tag, extra in (("whole", []), ("stream", ["--stream", "600"])):
        assert jax_main(["profile", *extra, "-o", ref + tag, ref + "toy.sldb",
                         ds.sam_path]) == 0
    assert jax_main(["collect", "-o", ref + "merged.tsv",
                     ref + "whole_profile.tsv",
                     ref + "stream_profile.tsv"]) == 0
    for got, want in (("whole", "whole"), ("stream", "stream"),
                      ("overlap", "whole"), ("d/a", "whole"),
                      ("d/b", "whole"), ("traced", "whole")):
        assert filecmp.cmp(out + got + "_profile.tsv",
                           ref + want + "_profile.tsv", shallow=False), got
    assert filecmp.cmp(out + "merged.tsv", ref + "merged.tsv", shallow=False)
