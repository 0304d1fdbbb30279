"""slimm_tpu_torch across processes: two processes over torch.distributed
(gloo, on the CPU) against one process of the port and of slimm_tpu.

Each process profiles a SAM of its own reads (split by read as
tests/_mp_child.py does) through MultiHostRunner, whole-file and by chunk
streaming, with and without -ro/-co; the merges are all_reduce sums, so
every process holds the profile of the whole input, exactly.  The child is
`child` below, run through `python -c`."""

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
    """One process of the group: its states, pickled for the parent."""
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
        states = {}
        for fc in (True, False):
            eng = EngineOptions(phase_log=False, fetch_coverage=fc)
            states["whole", fc] = tp.profile_file(
                ProfileOptions(), copy.deepcopy(db), sam, engine=eng,
                sharded_runner=runner)
            states["stream", fc] = tp.profile_file_streaming(
                ProfileOptions(), copy.deepcopy(db), sam, engine=eng,
                chunk_targets=512, sharded_runner=runner)
        with open(os.path.join(work_dir, f"states{rank}.pkl"), "wb") as f:
            pickle.dump(states, f)
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
    states = []
    for rank in range(world):
        with open(os.path.join(work_dir, f"states{rank}.pkl"), "rb") as f:
            states.append(pickle.load(f))
    return states


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


@pytest.mark.parametrize("case", ["split", "two_local_shards",
                                  "no_hits_rank"])
def test_two_processes_match_one(case, toy_dir, tmp_path):
    import numpy as np

    from slimm_tpu.config import EngineOptions, ProfileOptions
    from slimm_tpu.engine import pipeline as jp
    from slimm_tpu_torch.engine import pipeline as tp
    from tests.test_engine import assert_states_equal
    from tests.test_torch_host import to_port
    from tests.toy import build_toy_db, write_sam

    db = build_toy_db(toy_dir)
    db.save_sldb(str(tmp_path / "toy.sldb"))
    for rank in range(2):
        write_sam(str(tmp_path), _rank_records(toy_dir.records, case, rank),
                  name=f"rank{rank}.sam")
    states = _run_group(str(tmp_path), 2,
                        [2, 1] if case == "two_local_shards" else [1, 1])

    for fc in (True, False):
        eng = EngineOptions(phase_log=False, fetch_coverage=fc)
        one_j = jp.profile_file(ProfileOptions(), copy.deepcopy(db),
                                toy_dir.sam_path, engine=eng)
        one_t = tp.profile_file(to_port(ProfileOptions()), to_port(db),
                                toy_dir.sam_path, device=torch.device("cpu"),
                                engine=to_port(eng))
        for rank, path in ((r, p) for r in range(2)
                           for p in ("whole", "stream")):
            got = states[rank][path, fc]
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
