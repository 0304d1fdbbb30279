"""slimm_tpu_torch's own host layer against slimm_tpu's, on the same inputs.

The port keeps copies of slimm_tpu's jax-free modules (config, database,
state, oracle, io with the native decoder, tools/collect without pandas,
the bench workload of utils/workload.py) so that it imports nothing of
slimm_tpu.  Each copy is held to its original here, exactly: equal
dictionaries and arrays, and equal file bytes.  `to_port` turns slimm_tpu's
options and databases into the port's own, for the other test_torch_*
files."""

import copy
import dataclasses
import filecmp
import os

import numpy as np
import pytest

import bench
from slimm_tpu import config as jconfig
from slimm_tpu import database as jdatabase
from slimm_tpu import oracle as joracle
from slimm_tpu import state as jstate
from slimm_tpu.engine import reports as jreports
from slimm_tpu.io import AlignmentFile as JAlignmentFile
from slimm_tpu.io import native as jnative
from slimm_tpu.tools.collect import collect_profiles as jcollect
from slimm_tpu_torch import config as tconfig
from slimm_tpu_torch import database as tdatabase
from slimm_tpu_torch import oracle as toracle
from slimm_tpu_torch import state as tstate
from slimm_tpu_torch.engine import reports as treports
from slimm_tpu_torch.io import AlignmentFile as TAlignmentFile
from slimm_tpu_torch.io import native as tnative
from slimm_tpu_torch.tools.collect import collect_profiles as tcollect
from slimm_tpu_torch.utils import workload

from tests.toy import build_toy_db, make_records, write_bam, write_sam

_PORT_TYPES = {cls.__name__: cls for cls in (
    tconfig.ProfileOptions, tconfig.EngineOptions, tconfig.BuildOptions,
    tdatabase.SlimmDatabase)}


def to_port(obj):
    """The port's own counterpart of a slimm_tpu ProfileOptions,
    EngineOptions, BuildOptions or SlimmDatabase: every field deep-copied."""
    cls = _PORT_TYPES[type(obj).__name__]
    return cls(**{f.name: copy.deepcopy(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def _build_options(mod, ds, out, use_native):
    return mod.BuildOptions(
        fasta_path=ds.fasta_path, ac__taxid_paths=[ds.acc2taxid_path],
        names_path=ds.names_path, nodes_path=ds.nodes_path, output_path=out,
        use_native=use_native)


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["python_scan", "native_scan"])
def test_build_database_sldb_bytes(use_native, toy_dir, tmp_path):
    paths = {}
    for tag, db_mod, cfg in (("jax", jdatabase, jconfig),
                             ("torch", tdatabase, tconfig)):
        paths[tag] = str(tmp_path / f"{tag}.sldb")
        db = db_mod.build_database(
            _build_options(cfg, toy_dir, paths[tag], use_native))
        db.save_sldb(paths[tag])
        db.save_npz(paths[tag] + ".npz")
        assert len(db.ac__taxid) >= 5
    assert filecmp.cmp(paths["jax"], paths["torch"], shallow=False)


@pytest.mark.parametrize("fmt", ["sldb", "npz"])
def test_database_load_equal(fmt, toy_dir, tmp_path):
    path = str(tmp_path / "toy.sldb")
    build_toy_db(toy_dir).save_sldb(path)
    if fmt == "npz":
        jdatabase.SlimmDatabase.load(path).save_npz(path + ".npz")
    j = jdatabase.SlimmDatabase.load(path)
    t = tdatabase.SlimmDatabase.load(path)
    assert type(t) is tdatabase.SlimmDatabase
    assert t.ac__taxid == j.ac__taxid and t.taxid__name == j.taxid__name
    assert list(t.ac__taxid) == list(j.ac__taxid)


def test_tensorize_equal(toy_dir):
    db = build_toy_db(toy_dir)
    names = [c[0] for c in toy_dir.contigs] + ["unknown_contig.1"]
    dbs = {"jax": copy.deepcopy(db), "torch": to_port(db)}
    j = jdatabase.tensorize(dbs["jax"], names)
    t = tdatabase.tensorize(dbs["torch"], names)
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (t.n_dense, t.n_pair_codes) == (j.n_dense, j.n_pair_codes)
    # the unknown accession is inserted into the live map in both
    assert dbs["torch"].ac__taxid == dbs["jax"].ac__taxid


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 1.0])
@pytest.mark.parametrize("case", ["random", "zeros", "ties", "empty"])
def test_quantile_cut_off_equal(case, q):
    rng = np.random.default_rng(int(100 * q) + 7 * len(case))
    values = {"random": rng.gamma(0.5, 3.0, 997).astype(np.float32),
              "zeros": np.zeros(40, np.float32),
              "ties": rng.integers(0, 4, 300).astype(np.float32),
              "empty": np.zeros(0, np.float32)}[case]
    got = tstate.quantile_cut_off(values, np.float32(q))
    want = jstate.quantile_cut_off(values, np.float32(q))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert tstate.fmt_float(got) == jstate.fmt_float(want)


@pytest.fixture(scope="module")
def align_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("host_align"))
    records = make_records(n_extra=3000, seed=7)
    return {"sam": write_sam(d, records), "bam": write_bam(d, records)}


def _batch_fields(batch):
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}


def _assert_batches_equal(a, b):
    fa, fb = _batch_fields(a), _batch_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("decoder", ["python", "native"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_alignment_file_equal(fmt, decoder, align_files):
    path = align_files[fmt]
    if decoder == "python":
        j, t = JAlignmentFile(path), TAlignmentFile(path)
        assert list(t.raw_records()) == list(j.raw_records())
        for dedup in (True, False):
            _assert_batches_equal(j.load(dedup=dedup), t.load(dedup=dedup))
    else:
        j = jnative.NativeAlignmentFile(path)
        t = tnative.NativeAlignmentFile(path)
        _assert_batches_equal(j.load(), t.load())
    assert t.contig_names == j.contig_names
    np.testing.assert_array_equal(t.contig_lengths, j.contig_lengths)


@pytest.mark.parametrize("reader", ["v2_pieces", "v1_chunks"])
def test_native_stream_reader_equal(reader, align_files):
    path = align_files["sam"]
    readers = [jnative.NativeStreamReader(path),
               tnative.NativeStreamReader(path)]
    lengths = np.asarray(readers[0].contig_lengths, np.uint32)
    outs = [[], []]
    for sr, out in zip(readers, outs):
        while True:
            if reader == "v2_pieces":
                p = sr.next_piece_v2(1024, 1024, lengths, 50, 100, np.uint8,
                                     with_plan=True)
            else:
                p = sr.next_chunk(700)
            if p is None:
                break
            out.append(p)
        out.append((sr.totals(), sr.avg_read_length, sr.max_targets))
        sr.close()
    # (the first v1 chunk holds the reader's 100k-record sample: one here)
    assert len(outs[1]) == len(outs[0]) >= (3 if reader == "v2_pieces" else 2)
    for a, b in zip(*outs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


def test_native_library_is_the_ports_own():
    # built from native/slimm_native.cpp into slimm_tpu_torch/_build/, never
    # slimm_tpu/native/libslimm_native.so
    path = tnative.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tnative.__file__)))
    assert os.path.dirname(path) == os.path.join(pkg, "_build")
    assert path == tnative.library_path() and os.path.exists(path)
    assert tnative.available()


def _oracle_state(oracle_mod, options, db, sam):
    af = JAlignmentFile(sam)
    return oracle_mod.OracleProfiler(
        options, copy.deepcopy(db.ac__taxid), copy.deepcopy(db.taxid__name),
        list(zip(af.contig_names, af.contig_lengths.tolist()))
    ).run(af.raw_records())


ORACLE_CASES = {"default": {}, "raw_and_coverage": dict(raw_output=True,
                                                        coverage_output=True),
                "genus_verbose": dict(rank="genus", verbose=True)}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_tsv_bytes_equal(case, toy_dir, tmp_path, capsys):
    db = build_toy_db(toy_dir)
    capsys.readouterr()
    outs = {}
    for tag, mod, cfg, rep in (("jax", joracle, jconfig, jreports),
                               ("torch", toracle, tconfig, treports)):
        options = cfg.ProfileOptions(**ORACLE_CASES[case])
        st = _oracle_state(mod, options, db if tag == "jax" else to_port(db),
                           toy_dir.sam_path)
        assert type(st).__module__ == (
            "slimm_tpu.state" if tag == "jax" else "slimm_tpu_torch.state")
        out = str(tmp_path / tag) + "/"
        rep.write_abundance(st, out, toy_dir.sam_path)
        if options.raw_output:
            rep.write_raw_stat(st, out, toy_dir.sam_path)
            rep.write_coverage(st, out, toy_dir.sam_path)
        outs[tag] = (out, capsys.readouterr().err)
    names = sorted(os.listdir(outs["jax"][0]))
    assert len(names) == (5 if case == "raw_and_coverage" else 1)
    assert names == sorted(os.listdir(outs["torch"][0]))
    for name in names:
        assert filecmp.cmp(outs["jax"][0] + name, outs["torch"][0] + name,
                           shallow=False), name
    assert outs["jax"][1] == outs["torch"][1]


def test_collect_bytes_equal(toy_dir, tmp_path):
    # three samples; the second lacks the reads of two contigs, so some taxa
    # appear in one sample and not in another
    db = build_toy_db(toy_dir)
    profiles = []
    for k, records in enumerate((
            toy_dir.records,
            [r for r in toy_dir.records if r[2] not in (1, 4)],
            make_records(n_extra=500, seed=11))):
        d = str(tmp_path / f"s{k}")
        os.makedirs(d)
        sam = write_sam(d, records, name=f"sample{k}.sam")
        st = _oracle_state(joracle, jconfig.ProfileOptions(), db, sam)
        jreports.write_abundance(st, d + "/", sam)
        profiles.append(os.path.join(d, f"sample{k}_profile.tsv"))
    rows = [set(open(p).read().splitlines()[1:]) for p in profiles]
    assert rows[0] != rows[1]
    out_j, out_t = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    assert jcollect(profiles, out_j) == out_j
    assert tcollect(profiles, out_t) == out_t
    got = open(out_t, "rb").read()
    assert got == open(out_j, "rb").read()
    assert got.count(b"\n") >= 5 and b"\t0.0\t" in got


def test_workload_equals_bench(tmp_path):
    w_t = workload.make_workload(20_000, 7, seed=3)
    w_j = bench.make_workload(20_000, 7, seed=3)
    assert w_t.keys() == w_j.keys()
    for k in w_j:
        if isinstance(w_j[k], np.ndarray):
            assert w_t[k].dtype == w_j[k].dtype, k
            np.testing.assert_array_equal(w_t[k], w_j[k], err_msg=k)
        else:
            assert w_t[k] == w_j[k], k
    assert workload.bench_names(7) == bench.bench_names(7)
    sams = {}
    for tag, mod in (("jax", bench), ("torch", workload)):
        sams[tag] = str(tmp_path / f"{tag}.sam")
        assert mod.write_bench_sam(sams[tag], w_j, 7, block=4096) > 0
        mod.make_bench_db(w_j, 7).save_sldb(sams[tag] + ".sldb")
    assert type(workload.make_bench_db(w_j, 7)) is tdatabase.SlimmDatabase
    for suffix in ("", ".sldb"):
        assert filecmp.cmp(sams["jax"] + suffix, sams["torch"] + suffix,
                           shallow=False)


def test_to_port_gives_the_ports_types(toy_dir):
    db = build_toy_db(toy_dir)
    for obj in (jconfig.ProfileOptions(rank="genus", bin_width=7),
                jconfig.EngineOptions(phase_log=False, stream_chunk=64),
                jconfig.BuildOptions(ac__taxid_paths=["a", "b"]), db):
        got = to_port(obj)
        assert type(got).__module__.startswith("slimm_tpu_torch.")
        assert dataclasses.asdict(got) == dataclasses.asdict(obj)
