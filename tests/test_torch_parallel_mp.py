"""slimm_tpu_torch across processes: two processes over torch.distributed
(gloo, on the CPU) against one process of the port and of slimm_tpu.

Each process profiles a SAM of its own reads (split by read as
tests/_mp_child.py does) through MultiHostRunner, whole-file and by chunk
streaming, with and without -ro/-co; the merges are all_reduce sums, so
every process holds the profile of the whole input, exactly, and the
collective payload each process counts is the one the tables give.  The
child is `child` below, run through `python -c`.  The CLI launcher
(`python -m slimm_tpu_torch.parallel.multihost`) is run the same way: with
-d each process profiles its own share of a directory."""

import copy
import os
import pickle
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def child(init_method, world, rank, work_dir, local_shards):
    """One process of the group: its states and collective byte counts,
    pickled for the parent."""
    world, rank, local_shards = int(world), int(rank), int(local_shards)
    import torch.distributed as dist

    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.engine import pipeline as tp
    from slimm_tpu_torch.parallel import MultiHostRunner, initialize

    # the defaults are NCCL on the GPU: the CPU run asks for gloo
    initialize("gloo", init_method, world, rank)
    try:
        assert dist.get_backend() == "gloo"
        db = SlimmDatabase.load(os.path.join(work_dir, "toy.sldb"))
        sam = os.path.join(work_dir, f"rank{rank}.sam")
        runner = MultiHostRunner(devices=["cpu"] * local_shards)
        assert runner.distributed and runner.data_shards == local_shards
        states, sent = {}, {}
        for fc in (True, False):
            eng = EngineOptions(phase_log=False, fetch_coverage=fc)
            for label, fn, kw in (
                    ("whole", tp.profile_file, {}),
                    ("stream", tp.profile_file_streaming,
                     dict(chunk_targets=512))):
                # the runner's counts accumulate: one file's, cleared before
                for issued in runner.collective_bytes.values():
                    issued.clear()
                states[label, fc] = fn(
                    ProfileOptions(), copy.deepcopy(db), sam, engine=eng,
                    sharded_runner=runner, **kw)
                sent[label, fc] = copy.deepcopy(runner.collective_bytes)
        with open(os.path.join(work_dir, f"states{rank}.pkl"), "wb") as f:
            pickle.dump((states, sent), f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(work_dir, world, local_shards):
    init = f"tcp://127.0.0.1:{_free_port()}"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_parallel_mp import child; "
            "child(*sys.argv[2:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, REPO, init, str(world), str(rank),
         work_dir, str(local_shards[rank])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the processes did not finish in 300 s:\n"
                    + "\n".join(outs))
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(f"rank {r}:\n{out[-3000:]}" for r, out in enumerate(outs))
    runs = []
    for rank in range(world):
        with open(os.path.join(work_dir, f"states{rank}.pkl"), "rb") as f:
            runs.append(pickle.load(f))
    return runs


def _rank_records(records, case, rank):
    """Process `rank`'s records.  "no_hits_rank": process 1 holds only the
    unmapped reads, made shorter, so it has no record to profile and
    another average read length: its bin width must be process 0's
    (broadcast), and it takes part in every merge with zeros."""
    if case == "no_hits_rank":
        unmapped = [r for r in records if r[2] < 0]
        if rank == 1:
            return [r[:4] + (r[4] // 2,) for r in unmapped]
        return [r for r in records if r[2] >= 0]
    first: dict = {}
    for rec in records:
        first.setdefault(rec[0], len(first))
    return [r for r in records if first[r[0]] % 2 == rank]


def _collective_bytes(n_bins, n_contigs, n_dense, pair_slots,
                      fetch_coverage):
    """The payload one file's profile sends, per collective: the summed
    totals (reads and hits, int64), then in _core_after_a's order the int32
    cov and uniq_cov (n_bins each), uniq_matches, uniq_cov2 (n_bins) or the
    per-contig u2 counts, the taxon counts, uniq_matches2 and the pair
    presence; and process 0's average read length (int64) broadcast."""
    i32, i64 = 4, 8
    merged = [n_bins, n_bins, 1, n_bins if fetch_coverage else n_contigs,
              n_dense, 1, pair_slots]
    return {"all_reduce": [2 * i64] + [i32 * n for n in merged],
            "broadcast": [i64]}


@pytest.mark.parametrize("case", ["split", "two_local_shards",
                                  "no_hits_rank"])
def test_two_processes_match_one(case, toy_dir, tmp_path):
    import numpy as np

    from slimm_tpu.config import EngineOptions, ProfileOptions
    from slimm_tpu.engine import pipeline as jp
    from slimm_tpu_torch.database import tensorize
    from slimm_tpu_torch.engine import pipeline as tp
    from tests.test_engine import assert_states_equal
    from tests.test_torch_host import to_port
    from tests.toy import build_toy_db, write_sam

    db = build_toy_db(toy_dir)
    db.save_sldb(str(tmp_path / "toy.sldb"))
    for rank in range(2):
        write_sam(str(tmp_path), _rank_records(toy_dir.records, case, rank),
                  name=f"rank{rank}.sam")
    runs = _run_group(str(tmp_path), 2,
                      [2, 1] if case == "two_local_shards" else [1, 1])
    dense = tensorize(to_port(db), [c[0] for c in toy_dir.contigs])
    C = len(dense.lineage)

    for fc in (True, False):
        eng = EngineOptions(phase_log=False, fetch_coverage=fc)
        one_j = jp.profile_file(ProfileOptions(), copy.deepcopy(db),
                                toy_dir.sam_path, engine=eng)
        one_t = tp.profile_file(to_port(ProfileOptions()), to_port(db),
                                toy_dir.sam_path, device=torch.device("cpu"),
                                engine=to_port(eng))
        want_sent = _collective_bytes(
            int(one_t.nbins.sum()), C, dense.n_dense,
            tp._pad1024(C * dense.n_pair_codes), fc)
        for rank, path in ((r, p) for r in range(2)
                           for p in ("whole", "stream")):
            states, sent = runs[rank]
            assert sent[path, fc] == want_sent, (rank, path, fc)
            got = states[path, fc]
            for want in (one_j, one_t):
                if fc:
                    assert_states_equal(want, got)
                else:
                    assert got.cov is None
                    assert want.abundance_rows() == got.abundance_rows()
                    assert (want.taxon_id__read_count
                            == got.taxon_id__read_count)
                    assert want.taxon_id__children == got.taxon_id__children
                    np.testing.assert_array_equal(want.uniq_reads_count2,
                                                  got.uniq_reads_count2)


@pytest.mark.parametrize("inputs", ["directory", "single_file"])
def test_launcher_profiles_each_input_once(inputs, toy_dir, tmp_path):
    # two gloo processes through the CLI launcher, each writing into its own
    # directory: with -d every input is written by exactly one process, the
    # one shard_paths gives it, with the bytes of a one-process -d run; a
    # single input file is written by process 0, and process 1 writes
    # nothing and exits 0
    from slimm_tpu_torch import cli
    from slimm_tpu_torch.io import collect_bam_files
    from slimm_tpu_torch.parallel import shard_paths
    from tests.toy import build_toy_db, make_records, write_sam

    db = str(tmp_path / "toy.sldb")
    build_toy_db(toy_dir).save_sldb(db)
    indir = tmp_path / "in"
    indir.mkdir()
    for k in range(5):
        write_sam(str(indir), make_records(n_extra=100 * k, seed=k),
                  name=f"s{k}.sam")
    d = ["-d"] if inputs == "directory" else []
    src = str(indir) if d else str(indir / "s3.sam")
    one = str(tmp_path / "one") + "/"
    assert cli.main(["profile", "--device", "cpu", *d, "-o", one, db,
                     src]) == 0
    want = {name: open(one + name, "rb").read() for name in os.listdir(one)}
    assert len(want) == (5 if d else 1)

    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slimm_tpu_torch.parallel.multihost",
         "--backend", "gloo", "--init-method", init, "--world-size", "2",
         "--rank", str(rank), "--", "profile", "--device", "cpu", *d, "-o",
         str(tmp_path / f"rank{rank}") + "/", db, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    paths = (collect_bam_files(src, True) if d else [src])
    written = {}
    for rank in range(2):
        out = tmp_path / f"rank{rank}"
        names = sorted(os.listdir(out)) if out.exists() else []
        mine = shard_paths(paths, rank, 2) if d else paths[:1 - rank]
        assert names == sorted(os.path.basename(p)[:-4] + "_profile.tsv"
                               for p in mine), (rank, names)
        assert f"[MSG] process {rank} of 2: profiling {len(mine)} of the " \
               "input files" in outs[rank]
        for name in names:
            assert name not in written
            written[name] = (out / name).read_bytes()
    assert written == want


def test_defaults_are_the_gpu(monkeypatch):
    # initialize() and MultiHostRunner() default to NCCL and cuda:LOCAL_RANK;
    # without a GPU and without asking for gloo or the CPU they raise
    import torch.distributed as dist

    from slimm_tpu_torch.parallel import MultiHostRunner, initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(init_method=f"tcp://127.0.0.1:{_free_port()}",
                   world_size=1, rank=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiHostRunner()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    initialize(init_method="tcp://h:1", world_size=4, rank=1)
    assert calls == [torch.device("cuda", 3),
                     (("nccl",), dict(init_method="tcp://h:1", world_size=4,
                                      rank=1))]


def test_gloo_and_cpu_when_asked():
    # a world of one over gloo, the runner on the CPU: both as asked
    import torch.distributed as dist

    from slimm_tpu_torch.parallel import MultiHostRunner, initialize

    initialize("gloo", f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "gloo"
        runner = MultiHostRunner(devices=["cpu", "cpu"])
        assert runner.distributed and runner.data_shards == 2
        assert runner.devices == [[torch.device("cpu")]] * 2
        assert runner.sum_totals(3, 4) == (3, 4) and runner.broadcast(9) == 9
    finally:
        dist.destroy_process_group()
