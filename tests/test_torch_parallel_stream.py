"""slimm_tpu_torch's sharded chunk streaming and sharded CLI against
slimm_tpu's, on the CPU: profile_file_streaming with a ShardedRunner
(v2 pieces, v1 chunks, no device cache, non-grouped input, each fall back),
and `profile --shards/--model-shards` with and without `--stream`.  JAX
runs on its 8 virtual CPU devices; every comparison is exact."""

import copy
import filecmp
import os

import numpy as np
import pytest
import torch

from slimm_tpu.cli import main as jax_main
from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.parallel import ShardedRunner as JaxShardedRunner
from slimm_tpu.parallel.streaming import profile_file_streaming_sharded
from slimm_tpu_torch import cli as tcli
from slimm_tpu_torch.config import EngineOptions as TEngineOptions
from slimm_tpu_torch.config import ProfileOptions as TProfileOptions
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.io import native
from slimm_tpu_torch.parallel import ShardedRunner
from slimm_tpu_torch.parallel.multihost import main as multihost_main
from slimm_tpu_torch.parallel.streaming import (
    profile_file_streaming_sharded as t_streaming_sharded)

from tests.test_engine import assert_states_equal
from tests.test_torch_host import to_port
from tests.test_torch_stream import _fallback_bin_widths
from tests.toy import build_toy_dataset, build_toy_db, write_sam

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRIDS = [(2, 2), (4, 1), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def ensure_native_built():
    # the port's own decoder, built from native/ into slimm_tpu_torch/_build/
    native.build()


@pytest.fixture(autouse=True)
def fresh_counts():
    tp.reset_path_counts()


def _eng(**kw):
    return EngineOptions(phase_log=False, **kw)


def _teng(**kw):
    return TEngineOptions(phase_log=False, **kw)


@pytest.fixture(scope="module")
def big_ds(tmp_path_factory):
    # past the stream reader's 100k-record sample, so v1 streaming makes
    # several chunks
    d = tmp_path_factory.mktemp("sharded_stream_big")
    ds = build_toy_dataset(str(d), n_extra=105_000, seed=43)
    return ds, build_toy_db(ds)


def _non_grouped_records(n=200, stride=3):
    # coordinate-sorted-style input: reads reappear non-consecutively
    records = [(f"r{k}", 0, k % 5, 10 * k % 2500, 100) for k in range(n)]
    records += [(f"r{k}", 0, (k + 1) % 5, 7 * k % 2500, 100)
                for k in range(0, n, stride)]
    return records


def _both(db, path, data, model, eng, chunk):
    st_j = profile_file_streaming_sharded(
        ProfileOptions(), copy.deepcopy(db), path,
        JaxShardedRunner(num_shards=data, model_shards=model), engine=eng,
        chunk_targets=chunk)
    # the port's entry point of the same name: profile_file_streaming with
    # a sharded_runner
    st_t = t_streaming_sharded(
        TProfileOptions(), to_port(db), path,
        ShardedRunner(num_shards=data, model_shards=model, device="cpu"),
        engine=to_port(eng), chunk_targets=chunk)
    return st_j, st_t


@pytest.mark.parametrize("case", ["v2", "v1", "no_device_cache",
                                  "non_grouped"])
@pytest.mark.parametrize("data,model", GRIDS)
def test_sharded_streaming_matches_jax(data, model, case, big_ds, toy_dir,
                                       tmp_path, monkeypatch):
    ds, db = big_ds
    path, chunk, eng = ds.sam_path, 4096, _eng()
    if case == "v1":
        # bins past V2_MAX_BIN: v1 chunks from the decode-ahead thread
        monkeypatch.setattr(tp, "V2_MAX_BIN", 0)
    elif case == "no_device_cache":
        eng = _eng(stream_device_cache_bytes=0)
    elif case == "non_grouped":
        db = build_toy_db(toy_dir)
        path = write_sam(str(tmp_path), _non_grouped_records(),
                         name="nongrouped.sam")
        chunk = 64
    st_j, st_t = _both(db, path, data, model, eng, chunk)
    counts = tp.path_counts
    assert counts["stream_files"] == counts["sharded_files"] == 1
    pieces = counts["stream_chunks_v1" if case == "v1"
                    else "stream_chunks_v2"]
    assert pieces >= (1 if case == "non_grouped" else 2)
    if case == "no_device_cache":
        # every shard's part of every piece was uploaded again for pass B
        assert counts["pass_b_reuploads"] >= pieces * min(data, 2)
    else:
        assert counts["pass_b_reuploads"] == 0
    assert_states_equal(st_j, st_t)
    st_w = tp.profile_file(TProfileOptions(), to_port(db), path,
                           device=CPU, engine=_teng(overlap_min_bytes=0))
    assert_states_equal(st_w, st_t)


def test_sharded_streaming_no_coverage(big_ds):
    ds, db = big_ds
    eng = _eng(fetch_coverage=False)
    st_j, st_t = _both(db, ds.sam_path, 2, 2, eng, 4096)
    assert st_t.cov is None and st_t.uniq_cov2 is None
    assert st_j.abundance_rows() == st_t.abundance_rows()
    assert st_j.taxon_id__read_count == st_t.taxon_id__read_count
    assert st_j.taxon_id__children == st_t.taxon_id__children
    np.testing.assert_array_equal(st_j.uniq_reads_count2,
                                  st_t.uniq_reads_count2)


@pytest.mark.parametrize("cause", ["open", "not_grouped", "overflow"])
def test_sharded_streaming_gives_way(cause, toy_dir, monkeypatch):
    # each cause is counted, bin_width is restored, and the file is profiled
    # whole over the same grid
    db = build_toy_db(toy_dir)
    st_w = tp.profile_file(TProfileOptions(), to_port(db),
                           toy_dir.sam_path, device=CPU, engine=_teng())
    if cause == "open":
        def refuse(self, path, *args, **kw):
            raise ValueError(f"{path}: the stream reader cannot take it")

        monkeypatch.setattr(native.NativeStreamReader, "__init__", refuse)
    else:
        def fail(*args, **kw):
            if cause == "overflow":
                raise OverflowError("single read exceeds the piece cap")
            raise ValueError("input is not qname-grouped")

        monkeypatch.setattr(native.NativeStreamReader, "next_piece_v2", fail)
    seen = _fallback_bin_widths(monkeypatch)
    options = TProfileOptions()
    st = tp.profile_file_streaming(
        options, to_port(db), toy_dir.sam_path, engine=_teng(),
        chunk_targets=512,
        sharded_runner=ShardedRunner(num_shards=2, model_shards=2,
                                     device="cpu"))
    assert seen == [0]
    assert tp.path_counts["stream_fallback_" + cause] == 1
    assert tp.path_counts["stream_files"] == 0
    assert tp.path_counts["sharded_files"] >= 1
    assert_states_equal(st_w, st)
    if cause == "open":
        st_j = profile_file_streaming_sharded(
            ProfileOptions(), copy.deepcopy(db), toy_dir.sam_path,
            JaxShardedRunner(num_shards=2, model_shards=2), engine=_eng(),
            chunk_targets=512)
        assert_states_equal(st_j, st)


def test_streaming_across_processes_raises_instead_of_falling_back(
        toy_dir, monkeypatch):
    class Distributed(ShardedRunner):
        distributed = True

    def overflow(*args, **kw):
        raise OverflowError("single read exceeds the piece cap")

    monkeypatch.setattr(native.NativeStreamReader, "next_piece_v2", overflow)
    options = TProfileOptions()
    with pytest.raises(ValueError, match="across processes.*overflow"):
        tp.profile_file_streaming(
            options, to_port(build_toy_db(toy_dir)),
            toy_dir.sam_path, engine=_teng(),
            sharded_runner=Distributed(num_shards=2, device="cpu"))
    assert tp.path_counts["stream_fallback_overflow"] == 1
    assert options.bin_width == 0


# -- CLI -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built_db(toy_dir):
    out = os.path.join(toy_dir.dir, "torch_parallel_cli.sldb")
    assert tcli.main(["build", "-nm", toy_dir.names_path, "-nd",
                      toy_dir.nodes_path, "-o", out, toy_dir.fasta_path,
                      toy_dir.acc2taxid_path]) == 0
    return out


@pytest.mark.parametrize("extra", [[], ["--stream", "600"], ["-ro", "-co"]],
                         ids=["whole_file", "stream", "ro_co"])
def test_cli_sharded_tsv_bytes_match_slimm_tpu(extra, built_db, toy_dir,
                                               tmp_path):
    outs = {}
    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / tag) + "/"
        os.makedirs(out)
        tp.reset_path_counts()
        assert main(["profile", *dev, "--shards", "2", "--model-shards", "2",
                     *extra, "-o", out, built_db, toy_dir.sam_path]) == 0
        outs[tag] = out
    assert tp.path_counts["sharded_files"] == 1
    assert tp.path_counts["stream_files"] == int("--stream" in extra)
    names = sorted(os.listdir(outs["jax"]))
    assert len(names) == (5 if "-ro" in extra else 1)
    assert names == sorted(os.listdir(outs["torch"]))
    for name in names:
        assert filecmp.cmp(outs["jax"] + name, outs["torch"] + name,
                           shallow=False), name


def test_multihost_launcher_runs_the_cli(built_db, toy_dir, tmp_path):
    # a world of one initialises nothing and runs the ordinary CLI
    outs = []
    for tag in ("launcher", "cli"):
        out = str(tmp_path / tag) + "/"
        argv = ["profile", "--device", "cpu", "-o", out, built_db,
                toy_dir.sam_path]
        if tag == "launcher":
            with pytest.raises(SystemExit) as e:
                multihost_main(["--world-size", "1", "--", *argv])
            assert e.value.code == 0
        else:
            assert tcli.main(argv) == 0
        outs.append(open(out + "toy-reads_profile.tsv", "rb").read())
    assert outs[0] == outs[1]
    assert not torch.distributed.is_initialized()


def test_cli_cuda_shards_need_the_devices(built_db, toy_dir, tmp_path, capsys,
                                          monkeypatch):
    # no GPU: exit 1 before anything runs; one GPU: two shards are one
    # device too many
    out = tmp_path / "o"
    argv = ["profile", "--device", "cuda", "--shards", "2", "-o",
            str(out) + "/", built_db, toy_dir.sam_path]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(argv) == 1
    assert "[ERROR] --device cuda" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcli.main(argv) == 1
    assert "requested 2 devices (2 data x 1 model shards), have 1" in \
        capsys.readouterr().err
    assert not out.exists()
