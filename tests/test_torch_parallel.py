"""slimm_tpu_torch.parallel's whole-file sharded profiles against
slimm_tpu.parallel's, on the CPU: read routing, device grids, the model
shards' bin windows of pass A and pass B, and ShardedRunner over every
(data x model) factorisation of 8 devices, with and without -ro/-co.  JAX
runs on its 8 virtual CPU devices (tests/conftest.py) without Pallas; the
port puts every shard on the CPU.  Every comparison is exact."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from __graft_entry__ import _example_tables
from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.engine import pipeline as jp
from slimm_tpu.parallel import ShardedRunner as JaxShardedRunner
from slimm_tpu.parallel.mesh import route_shard as jax_route_shard
from slimm_tpu_torch.config import EngineOptions as TEngineOptions
from slimm_tpu_torch.config import ProfileOptions as TProfileOptions
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.parallel import (MultiHostRunner, ShardedRunner,
                                      device_grid, route_shard, shard_paths)
from slimm_tpu_torch.parallel.runner import model_slices, route_piece
from slimm_tpu_torch.tables import DeviceTables

from tests.test_engine import assert_states_equal
from tests.test_torch_host import to_port
from tests.toy import build_toy_dataset, build_toy_db

torch.set_num_threads(1)

CPU = torch.device("cpu")
FACTORISATIONS = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 1), (1, 2)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eng(**kw):
    return EngineOptions(phase_log=False, **kw)


def _teng(**kw):
    return TEngineOptions(phase_log=False, **kw)


# -- routing and grids --------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_route_shard_matches_jax(S):
    rng = np.random.default_rng(S)
    read_id = np.concatenate([
        rng.integers(0, 2**31 - 1, 5000), np.arange(100),
        [0, 1, 2**31 - 2, 2**31 - 1], np.full(7, -1)]).astype(np.int32)
    got = route_shard(_t(read_id), S)
    assert got.dtype == torch.int64
    got = got.numpy()
    np.testing.assert_array_equal(got, jax_route_shard(read_id, S))
    assert got.min() >= 0 and got.max() < S


@pytest.mark.parametrize("D", [2, 3, 8])
def test_route_piece_keeps_reads_whole_and_in_order(D):
    # v1 chunks by read id; v2 pieces by piece-local read index, with each
    # shard's boundary bits packed again; against the JAX package's hash
    # and a stable numpy argsort
    rng = np.random.default_rng(D)
    runs = rng.integers(1, 5, 700)
    read_id = np.repeat(np.arange(len(runs), dtype=np.int32) * 3, runs)
    n = len(read_id)
    rid = rng.integers(0, 40, n).astype(np.uint8)
    lbin = rng.integers(-2**15, 2**15, n).astype(np.int16)
    bits = np.r_[1, read_id[1:] != read_id[:-1]].astype(np.uint8)
    bnd = np.packbits(bits, bitorder="little")
    v2 = route_piece("v2", (_t(bnd), _t(rid), _t(lbin)), n, D)
    v1 = route_piece("v1", (_t(read_id), _t(rid.astype(np.int32)),
                            _t(lbin.astype(np.int32))), n, D)
    assert len(v2) == len(v1) == D
    assert sum(k for _, k in v2) == sum(k for _, k in v1) == n
    want = jax_route_shard(np.cumsum(bits) - 1, D)
    for d, ((b, r, lb), k) in enumerate(v2):
        sel = np.flatnonzero(want == d)
        assert k == len(sel) and b.dtype == torch.uint8
        np.testing.assert_array_equal(r.numpy(), rid[sel])
        np.testing.assert_array_equal(lb.numpy(), lbin[sel])
        np.testing.assert_array_equal(
            b.numpy(), np.packbits(bits[sel], bitorder="little"))
        got_read = tp._unpack_read_groups(b, k, k).numpy()
        np.testing.assert_array_equal(got_read,
                                      np.cumsum(bits[sel]) - 1)
    for d, ((r_id, r, _), k) in enumerate(v1):
        sel = np.flatnonzero(jax_route_shard(read_id, D) == d)
        np.testing.assert_array_equal(r_id.numpy(), read_id[sel])
        np.testing.assert_array_equal(r.numpy(), rid[sel])
        assert k == len(sel)


def test_device_grid():
    assert device_grid(2, 3, "cpu") == [[CPU] * 3] * 2
    for bad in [(0, 1), (1, 0)]:
        with pytest.raises(ValueError):
            device_grid(*bad, "cpu")
    with pytest.raises(ValueError):
        device_grid(1, 1, "meta")


def test_device_grid_past_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    grid = device_grid(1, 2, "cuda")
    assert grid == [[torch.device("cuda", 0), torch.device("cuda", 1)]]
    with pytest.raises(ValueError, match="requested 4 devices .* have 2"):
        device_grid(2, 2, "cuda")
    with pytest.raises(ValueError, match="requested 3 devices"):
        ShardedRunner(num_shards=3)


def test_explicit_grids():
    r = ShardedRunner(devices=[["cpu"] * 3] * 2)
    assert (r.data_shards, r.model_shards) == (2, 3)
    assert r.devices == [[CPU] * 3] * 2
    r = ShardedRunner(devices=[["cpu", "cpu"]])
    assert (r.data_shards, r.model_shards) == (1, 2)
    for bad in ([], [[]], [["cpu"], ["cpu", "cpu"]]):
        with pytest.raises(ValueError):
            ShardedRunner(devices=bad)
    assert shard_paths(["a", "b", "c"], 0, 2) == ["a", "c"]
    assert shard_paths(["a", "b", "c"], 1, 2) == ["b"]
    assert shard_paths(["a", "b"]) == ["a", "b"]     # no process group


@pytest.mark.parametrize("n_bins,M", [(176, 8), (1000, 3), (5, 8), (7, 1)])
def test_model_slices_tile_the_bins(n_bins, M):
    # the per-model-shard histogram lengths: equal slices of ceil(n / M),
    # the last ones short or empty, together exactly [0, n_bins)
    s = model_slices(n_bins, M)
    assert len(s) == M and s[0][0] == 0 and s[-1][1] == n_bins
    assert all(a[1] == b[0] for a, b in zip(s, s[1:]))
    assert max(hi - lo for lo, hi in s) == -(-n_bins // M)


# -- the bin windows of pass A and pass B ------------------------------------


def _example(n_contigs=8):
    (lengths, boff, bends, tbp, read_id, rid, pos, lineage, sk_code,
     n_codes) = _example_tables(n_contigs=n_contigs, n_records=600,
                                n_reads=250)
    t = DeviceTables.from_numpy(lengths, boff, bends, lineage, sk_code,
                                n_dense=32, n_codes=n_codes, half=50,
                                bin_width=100, q=0.95, device="cpu")
    return (lengths, boff, bends, tbp, read_id, rid, pos, lineage, sk_code,
            n_codes, t)


# (bin_lo, hist_bins) inside the 8 x 16 = 128 bins: contigs straddle them
WINDOWS = [(0, 32), (40, 50), (96, 32)]


@pytest.mark.parametrize("lo,hb", WINDOWS)
def test_pass_a_bin_window_matches_jax(lo, hb):
    (lengths, boff, _, tbp, read_id, rid, pos, *_, t) = _example()
    _, k_steps, window = jp.seg_plan(read_id)
    j = jp._pass_a_local(
        jnp.asarray(read_id), jnp.asarray(rid), jnp.asarray(pos),
        jnp.asarray(lengths), jnp.asarray(boff), np.int32(50), np.int32(100),
        n_contigs=8, total_bins_pad=tbp, dedup_window=2, k_steps=k_steps,
        window=window, bin_lo=jnp.int32(lo), hist_bins=hb)
    a = tp._pass_a_local(_t(read_id), _t(rid), _t(pos), t, dedup_window=2,
                         k_steps=k_steps, window=window, bin_lo=lo,
                         hist_bins=hb)
    for key in ("cov", "uniq_cov"):
        assert a[key].shape == (hb,)
        np.testing.assert_array_equal(a[key].numpy(), np.asarray(j[key]))
    full = tp._pass_a_local(_t(read_id), _t(rid), _t(pos), t, dedup_window=2,
                            k_steps=k_steps, window=window)
    np.testing.assert_array_equal(a["cov"].numpy(),
                                  full["cov"].numpy()[lo:lo + hb])
    assert int(a["uniq_matches"]) == int(j["uniq_matches"]) > 0


@pytest.mark.parametrize("lo,hb", WINDOWS)
def test_pass_b_bin_window_matches_jax(lo, hb):
    (lengths, boff, _, tbp, read_id, rid, pos, lineage, sk_code, n_codes,
     t) = _example()
    _, k_steps, window = jp.seg_plan(read_id)
    a = tp._pass_a_local(_t(read_id), _t(rid), _t(pos), t, dedup_window=2,
                         k_steps=k_steps, window=window)
    valid = np.random.default_rng(lo).random(8) < 0.75
    j = jp._pass_b_local(
        jnp.asarray(read_id), jnp.asarray(rid), jnp.asarray(a["t_gbin"]),
        jnp.asarray(a["nondup"]), jnp.asarray(valid), jnp.asarray(lineage),
        jnp.asarray(sk_code), n_contigs=8, total_bins_pad=tbp, n_dense=32,
        n_codes=n_codes, k_steps=k_steps, window=window, emit_coverage=True,
        bin_lo=jnp.int32(lo), hist_bins=hb)
    b = tp._pass_b_local(_t(read_id), _t(rid), a["t_gbin"], a["nondup"],
                         _t(valid), t, k_steps=k_steps, window=window,
                         emit_coverage=True, slices=[(lo, lo + hb)])
    assert len(b["uniq_cov2"]) == 1 and b["uniq_cov2"][0].shape == (hb,)
    np.testing.assert_array_equal(b["uniq_cov2"][0].numpy(),
                                  np.asarray(j["uniq_cov2"]))
    np.testing.assert_array_equal(b["taxon_counts"].numpy(),
                                  np.asarray(j["taxon_counts"]))
    np.testing.assert_array_equal(b["pair_levels"].numpy(),
                                  np.asarray(j["pair_levels"]) > 0)
    assert int(b["uniq_matches2"]) == int(j["uniq_matches2"])
    # the slices of a tiling add up to the unsharded histogram
    whole = tp._pass_b_local(_t(read_id), _t(rid), a["t_gbin"], a["nondup"],
                             _t(valid), t, k_steps=k_steps, window=window,
                             emit_coverage=True)
    tiled = tp._pass_b_local(_t(read_id), _t(rid), a["t_gbin"], a["nondup"],
                             _t(valid), t, k_steps=k_steps, window=window,
                             emit_coverage=True,
                             slices=model_slices(t.n_bins, 5))
    np.testing.assert_array_equal(torch.cat(tiled["uniq_cov2"]).numpy(),
                                  whole["uniq_cov2"][0].numpy())
    np.testing.assert_array_equal(tiled["taxon_counts"].numpy(),
                                  whole["taxon_counts"].numpy())


# -- the packed vector of a sharded core --------------------------------------


@pytest.fixture(scope="module")
def workload():
    # 50 contigs of bench lengths: every slice boundary cuts a contig
    w = bench.make_workload(20_000, 50, seed=4)
    bw = w["avg_read_len"]
    nbins = w["lengths"] // np.uint32(bw) + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    read_id, rid, pos, dedup_window, k_steps, window = tp.plan_records(
        w["read_id"], w["rid"], w["pos"], 50, deduped=False)
    plan = dict(dedup_window=dedup_window, k_steps=k_steps, window=window)
    return w, bw, boff, (boff + nbins).astype(np.int32), \
        (read_id, rid, pos), plan


@pytest.mark.parametrize("emit_coverage", [False, True])
@pytest.mark.parametrize("data,model", [(2, 1), (2, 2), (1, 4), (4, 2)])
def test_sharded_packed_matches_jax_runner(data, model, emit_coverage,
                                           workload):
    w, bw, boff, bends, records, plan = workload

    def tables(dev):
        return DeviceTables.from_numpy(
            w["lengths"], boff, bends, w["lineage"], w["sk_code"],
            n_dense=w["n_dense"], n_codes=w["n_codes"], half=bw // 2,
            bin_width=bw, q=0.95, device=dev)

    got = ShardedRunner(num_shards=data, model_shards=model,
                        device="cpu").fused(*records, tables,
                                            emit_coverage=emit_coverage,
                                            **plan)
    one = tp.fused_profile(*(_t(np.asarray(a, np.int32)) for a in records),
                           tables(CPU), emit_coverage=emit_coverage, **plan)
    n = len(records[0])
    n_pad = -(-n // 2048) * 2048

    def pad(a, fill):
        out = np.full(n_pad, fill, np.int32)
        out[:n] = a
        return out

    n_bins = int(bends[-1])
    j = JaxShardedRunner(num_shards=data, model_shards=model).fused(
        pad(records[0], -1), pad(records[1], 0), pad(records[2], 0),
        w["lengths"].astype(np.uint32), boff, bends, np.int32(bw // 2),
        np.int32(bw), w["lineage"], w["sk_code"], np.float32(0.95),
        emit_coverage=emit_coverage, n_contigs=50,
        total_bins_pad=-(-n_bins // 1024) * 1024, n_dense=w["n_dense"],
        n_codes=w["n_codes"], **plan)
    np.testing.assert_array_equal(got["packed"].numpy(),
                                  np.asarray(j["packed"]))
    np.testing.assert_array_equal(got["packed"].numpy(),
                                  one["packed"].numpy())
    if emit_coverage:
        for key in ("cov", "uniq_cov", "uniq_cov2"):
            assert got[key].shape == (n_bins,)
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(j[key])[:n_bins])
            np.testing.assert_array_equal(got[key].numpy(),
                                          one[key].numpy())
    else:
        assert set(got) == {"packed"}


def test_empty_data_shards():
    # 8 data shards over 3 reads: most shards get no records
    (lengths, boff, bends, _, _, _, _, lineage, sk_code, n_codes,
     t) = _example()
    read_id = np.array([0, 0, 1, 2, 2, 2], np.int32)
    rid = np.array([0, 3, 1, 2, 5, 6], np.int32)
    pos = np.array([10, 200, 30, 500, 900, 1400], np.int32)
    plan = dict(dedup_window=2, k_steps=2, window=2)
    got = ShardedRunner(num_shards=8, model_shards=2, device="cpu").fused(
        read_id, rid, pos, lambda dev: t, emit_coverage=True, **plan)
    one = tp.fused_profile(_t(read_id), _t(rid), _t(pos), t,
                           emit_coverage=True, **plan)
    for key in ("packed", "cov", "uniq_cov", "uniq_cov2"):
        np.testing.assert_array_equal(got[key].numpy(), one[key].numpy())


# -- whole files ---------------------------------------------------------------


@pytest.fixture(scope="module")
def random_ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_random")
    ds = build_toy_dataset(str(d), n_extra=3000, seed=77)
    return ds, build_toy_db(ds)


@pytest.mark.parametrize("fetch_coverage", [True, False])
@pytest.mark.parametrize("data,model", FACTORISATIONS)
@pytest.mark.parametrize("dataset", ["toy", "random"])
def test_sharded_profile_file_matches_jax(dataset, data, model,
                                          fetch_coverage, toy_dir, random_ds):
    if dataset == "toy":
        ds, db = toy_dir, build_toy_db(toy_dir)
    else:
        ds, db = random_ds
    eng = _eng(fetch_coverage=fetch_coverage)
    tp.reset_path_counts()
    st_j = jp.profile_file(ProfileOptions(), copy.deepcopy(db), ds.sam_path,
                           engine=eng,
                           sharded_runner=JaxShardedRunner(
                               num_shards=data, model_shards=model))
    st_t = tp.profile_file(TProfileOptions(), to_port(db), ds.sam_path,
                           engine=_teng(fetch_coverage=fetch_coverage,
                                        overlap_min_bytes=1),
                           sharded_runner=ShardedRunner(
                               num_shards=data, model_shards=model,
                               device="cpu"))
    # a sharded profile_file never takes the overlap path
    assert tp.path_counts["sharded_files"] == 1
    assert tp.path_counts["overlap_files"] == 0
    st_w = tp.profile_file(TProfileOptions(), to_port(db), ds.sam_path,
                           device=CPU, engine=to_port(eng))
    if fetch_coverage:
        assert_states_equal(st_j, st_t)
        assert_states_equal(st_w, st_t)
    else:
        assert st_t.cov is None and st_t.uniq_cov2 is None
        for st in (st_j, st_w):
            assert st.abundance_rows() == st_t.abundance_rows()
            assert st.taxon_id__read_count == st_t.taxon_id__read_count
            assert st.taxon_id__children == st_t.taxon_id__children
            np.testing.assert_array_equal(st.uniq_reads_count2,
                                          st_t.uniq_reads_count2)


def test_multihost_runner_single_process(toy_dir):
    # without a process group MultiHostRunner is a one-shard runner, here
    # on the CPU as asked; equal to the single-device engine
    db = build_toy_db(toy_dir)
    r = MultiHostRunner(devices=["cpu"])
    assert not r.distributed and r.devices == [[CPU]]
    assert r.broadcast(7) == 7 and r.sum_totals(3, 4) == (3, 4)
    st_m = tp.profile_file(TProfileOptions(), to_port(db),
                           toy_dir.sam_path, engine=_teng(), sharded_runner=r)
    st_w = tp.profile_file(TProfileOptions(), to_port(db),
                           toy_dir.sam_path, device=CPU, engine=_teng())
    assert_states_equal(st_w, st_m)


def test_profile_arrays_needs_one_target(toy_dir):
    with pytest.raises(ValueError, match="exactly one"):
        tp.profile_arrays(TProfileOptions(), to_port(build_toy_db(toy_dir)),
                          ["c"],
                          np.array([100]), [0], [0], [0], 1, 1, 100,
                          device=CPU, sharded_runner=ShardedRunner(
                              num_shards=2, device="cpu"))
