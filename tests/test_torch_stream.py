"""slimm_tpu_torch's streamed paths against slimm_tpu's, on the CPU: the
overlap path of profile_file (pass A per decoded piece, pass B after EOF)
and chunk streaming (profile_file_streaming, v2 pieces and v1 chunks), with
their helpers.  States are compared with tests.test_engine.
assert_states_equal and packed vectors with np.array_equal: every
comparison is exact.  JAX runs on the CPU without Pallas, as its own CPU
tests run it."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.engine import pipeline as jp
from slimm_tpu_torch.config import EngineOptions as TEngineOptions
from slimm_tpu_torch.config import ProfileOptions as TProfileOptions
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.io import native
from slimm_tpu_torch.state import ProfileState
from slimm_tpu_torch.tables import DeviceTables

from tests.test_engine import assert_states_equal
from tests.test_torch_host import to_port
from tests.toy import build_toy_dataset, build_toy_db, write_bam, write_sam

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="session", autouse=True)
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


def _jax_and_port(jax_fn, port_fn, db, path, options=None, **kw):
    options = options or ProfileOptions()
    st_j = jax_fn(copy.deepcopy(options), copy.deepcopy(db), path, **kw)
    st_t = port_fn(to_port(options), to_port(db), path, device=CPU,
                   **{k: to_port(v) if k == "engine" else v
                      for k, v in kw.items()})
    return st_j, st_t


def _fallback_bin_widths(monkeypatch):
    """The options.bin_width that each call of profile_file is given: a
    streamed path that gives way hands on the caller's options as they
    were."""
    seen = []
    whole = tp.profile_file

    def record(options, *args, **kw):
        seen.append(options.bin_width)
        return whole(options, *args, **kw)

    monkeypatch.setattr(tp, "profile_file", record)
    return seen


def _port_whole(db, path, options=None):
    return tp.profile_file(to_port(options or ProfileOptions()),
                           to_port(db), path, device=CPU,
                           engine=_teng(overlap_min_bytes=0))


def _assert_abundance_equal(st_a, st_b):
    """The abundance path's results, for states without bin histograms."""
    assert st_a.abundance_rows() == st_b.abundance_rows()
    assert st_a.taxon_id__read_count == st_b.taxon_id__read_count
    assert st_a.taxon_id__children == st_b.taxon_id__children
    assert st_a.valid_ref_ids == st_b.valid_ref_ids
    for name in ("reads_count", "uniq_reads_count", "uniq_reads_count2"):
        np.testing.assert_array_equal(getattr(st_a, name),
                                      getattr(st_b, name), err_msg=name)


@pytest.fixture(scope="module")
def big_ds(tmp_path_factory):
    # several v2 pieces (8,192 targets) and, past the stream reader's
    # 100k-record sample that the first v1 chunk holds, several v1 chunks
    d = tmp_path_factory.mktemp("stream_big")
    ds = build_toy_dataset(str(d), n_extra=105_000, seed=41)
    return ds, build_toy_db(ds)


def _long_read_records(rng, n_reads):
    # one-target reads, and in the first third of the file every 50th read
    # hits all 6 contigs: its run of 6 exceeds MAX_WINDOW + 1, so pieces
    # holding one use the doubling scans (window 0), later pieces a shift
    # window
    records = []
    for k in range(n_reads):
        long = k % 50 == 7 and k < n_reads // 3
        rids = range(6) if long else [int(rng.integers(0, 5))]
        for rid in rids:
            records.append((f"L{k}", 0, rid, int(rng.integers(0, 2500)), 100))
    return records


def _non_grouped_records(n=200, stride=3):
    # coordinate-sorted-style input: reads reappear non-consecutively
    records = [(f"r{k}", 0, k % 5, 10 * k % 2500, 100) for k in range(n)]
    records += [(f"r{k}", 0, (k + 1) % 5, 7 * k % 2500, 100)
                for k in range(0, n, stride)]
    return records


# -- helpers -----------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [0, 1, 777, 2047, 2048])
def test_unpack_read_groups_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    n_pad = 2048
    read_id = np.repeat(np.arange(n_pad), rng.integers(1, 4, n_pad))[:n_valid]
    bnd = jp.pack_records_compact2(read_id, np.zeros(n_valid, np.int32),
                                   np.zeros(n_valid, np.int32), n_pad, 1,
                                   np.array([1], np.uint32), 0, 1)[0]
    want = np.asarray(jp._unpack_read_groups(jnp.asarray(bnd), n_pad,
                                             n_valid))
    got = tp._unpack_read_groups(torch.from_numpy(bnd), n_pad, n_valid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a piece cut to its valid records, as the streamed paths decode it
    short = tp._unpack_read_groups(
        torch.from_numpy(bnd[:-(-n_valid // 8)]), n_valid, n_valid)
    np.testing.assert_array_equal(short.numpy(), want[:n_valid])


@pytest.mark.parametrize("n_contigs,rid_dtype", [(40, np.uint8),
                                                 (300, np.int16),
                                                 (33_000, np.int32)])
def test_v2_piece_decode(n_contigs, rid_dtype):
    # contig 0 has 65,536 bins, so local bins reach 32768 and above
    rng = np.random.default_rng(n_contigs)
    bw = 3
    lengths = np.full(n_contigs, 50, np.uint32)
    lengths[0] = 65_535 * bw
    nbins = lengths // bw + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    n, n_pad = 5000, 6144
    read_id = np.sort(rng.integers(0, 2000, n)).astype(np.int32)
    rid = np.where(rng.random(n) < 0.5, 0,
                   rng.integers(0, n_contigs, n)).astype(np.int32)
    pos = rng.integers(0, lengths[rid].astype(np.int64) + 40).astype(np.int32)
    assert tp._rid_dtype(n_contigs) is rid_dtype
    bnd, rid_p, bin_p, nv = jp.pack_records_compact2(
        read_id, rid, pos, n_pad, n_contigs, lengths, 1, bw)
    assert rid_p.dtype == rid_dtype and bin_p[:n].max() >= 32768
    t = DeviceTables.from_numpy(lengths, boff, boff + nbins,
                                np.zeros((n_contigs, 8)), np.zeros(n_contigs),
                                n_dense=1, n_codes=9, half=1, bin_width=bw,
                                q=0.95, device="cpu")
    arrays = tp._upload(tp._v2_host(bnd, rid_p, bin_p, int(nv)), CPU)
    got_read, got_rid, got_gbin = tp._decode_v2(arrays, int(nv), t)
    want_read = np.asarray(jp._unpack_read_groups(jnp.asarray(bnd), n_pad,
                                                  nv))[:n]
    np.testing.assert_array_equal(got_read.numpy(), want_read)
    np.testing.assert_array_equal(got_rid.numpy(), rid)
    want_gbin = boff[rid] + bin_p[:n].astype(np.int32)
    np.testing.assert_array_equal(got_gbin.numpy(), want_gbin)
    # the same bins as the whole-file path's center binning of pos
    np.testing.assert_array_equal(
        got_gbin.numpy(),
        tp._center_gbin(torch.from_numpy(rid), torch.from_numpy(pos),
                        t).numpy())


def test_piece_pass_a_acc_matches_jax():
    rng = np.random.default_rng(3)
    n_contigs, bw, half = 8, 100, 50
    lengths = rng.integers(3000, 20000, n_contigs).astype(np.uint32)
    nbins = lengths // bw + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    tbp = -(-int(nbins.sum()) // 1024) * 1024
    t = DeviceTables.from_numpy(lengths, boff, boff + nbins,
                                np.zeros((n_contigs, 8)), np.zeros(n_contigs),
                                n_dense=1, n_codes=9, half=half, bin_width=bw,
                                q=0.95, device="cpu")
    acc = dict(cov=torch.zeros(t.n_bins, dtype=torch.int32),
               uniq_cov=torch.zeros(t.n_bins, dtype=torch.int32),
               uniq_matches=torch.zeros((), dtype=torch.int32))
    j_acc = (jnp.zeros(tbp, jnp.int32), jnp.zeros(tbp, jnp.int32),
             jnp.int32(0))
    windows = set()
    for piece in range(4):
        # deduped reads of 1-3 targets, and in two pieces some of 7-8
        runs = rng.integers(1, 4, 400)
        if piece % 2:
            runs[::37] = rng.integers(7, 9, len(runs[::37]))
        read_id = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
        rid = np.concatenate([rng.choice(n_contigs, r, replace=False)
                              for r in runs]).astype(np.int32)
        pos = rng.integers(0, lengths[rid]).astype(np.int32)
        n = len(read_id)
        n_pad = -(-n // 2048) * 2048
        _, k_steps, window = jp.seg_plan(read_id)
        windows.add(window)
        bnd, rid_p, bin_p, nv = jp.pack_records_compact2(
            read_id, rid, pos, n_pad, n_contigs, lengths, half, bw)
        j_out = jp.piece_pass_a_acc(
            *j_acc, jnp.asarray(bnd), jnp.asarray(rid_p), jnp.asarray(bin_p),
            nv, jnp.asarray(lengths), jnp.asarray(boff), np.int32(half),
            np.int32(bw), n_contigs=n_contigs, total_bins_pad=tbp,
            k_steps=k_steps, window=window)
        j_acc = j_out[:3]
        dec = tp._decode_v2(tp._upload(tp._v2_host(bnd, rid_p, bin_p, n),
                                       CPU), n, t)
        tp.piece_pass_a_acc(acc, *dec, t, k_steps=k_steps, window=window)
    assert windows == {0, 2}
    n_bins = t.n_bins
    np.testing.assert_array_equal(acc["cov"].numpy(),
                                  np.asarray(j_acc[0])[:n_bins])
    np.testing.assert_array_equal(acc["uniq_cov"].numpy(),
                                  np.asarray(j_acc[1])[:n_bins])
    assert int(acc["uniq_matches"]) == int(j_acc[2]) > 0
    assert acc["uniq_matches"].dtype == torch.int32


# -- the overlap path ---------------------------------------------------------


def _overlap_input(case, tmp_path, rng):
    if case == "grouped":
        ds = build_toy_dataset(str(tmp_path), n_extra=4000, seed=13)
        return build_toy_db(ds), ds.sam_path
    if case == "bam":
        ds = build_toy_dataset(str(tmp_path), n_extra=4000, seed=9)
        return build_toy_db(ds), write_bam(str(tmp_path), ds.records)
    ds = build_toy_dataset(str(tmp_path))
    if case == "long_reads":
        return build_toy_db(ds), write_sam(str(tmp_path),
                                           _long_read_records(rng, 3000),
                                           name="long.sam")
    return build_toy_db(ds), write_sam(
        str(tmp_path), _non_grouped_records(3000, 2), name="nongrouped2.sam")


@pytest.mark.parametrize("case", ["grouped", "non_grouped", "bam",
                                  "long_reads"])
def test_overlap_matches_jax_and_whole_file(case, tmp_path, monkeypatch):
    db, path = _overlap_input(case, tmp_path, np.random.default_rng(17))
    windows = []
    piece_pass_a = tp.piece_pass_a_acc

    def record_plan(*args, window, **kw):
        windows.append(window)
        return piece_pass_a(*args, window=window, **kw)

    monkeypatch.setattr(tp, "piece_pass_a_acc", record_plan)
    eng = _eng(overlap_min_bytes=1, overlap_piece_targets=2048)
    st_j = jp._profile_file_overlap(ProfileOptions(), copy.deepcopy(db), path,
                                    eng)
    st_t = tp.profile_file(TProfileOptions(), to_port(db), path,
                           device=CPU, engine=to_port(eng))
    assert st_j is not None
    assert tp.path_counts["overlap_files"] == 1
    assert tp.path_counts["overlap_pieces"] == len(windows) >= 2
    assert_states_equal(st_j, st_t)
    assert_states_equal(_port_whole(db, path), st_t)
    if case == "long_reads":
        assert 0 in windows and max(windows) > 0


def test_overlap_default_piece_size_and_small_files(toy_dir):
    # below overlap_min_bytes the whole-file path runs; at the default piece
    # cap a toy file is one piece
    db = build_toy_db(toy_dir)
    st_w = tp.profile_file(TProfileOptions(), to_port(db),
                           toy_dir.sam_path, device=CPU, engine=_teng())
    assert tp.path_counts["overlap_files"] == 0
    st_o = tp.profile_file(TProfileOptions(), to_port(db),
                           toy_dir.sam_path, device=CPU,
                           engine=_teng(overlap_min_bytes=1))
    assert tp.path_counts["overlap_files"] == 1
    assert tp.path_counts["overlap_pieces"] == 1
    assert_states_equal(st_w, st_o)


def test_overlap_gives_way_past_uint16(toy_dir, monkeypatch):
    # bins past V2_MAX_BIN: the overlap path returns None with bin_width as
    # it was, and profile_file takes the whole-file path
    db = build_toy_db(toy_dir)
    monkeypatch.setattr(tp, "V2_MAX_BIN", 0)
    options = TProfileOptions()
    assert tp._profile_file_overlap(options, to_port(db),
                                    toy_dir.sam_path, device=CPU,
                                    engine=_teng()) is None
    assert options.bin_width == 0
    st = tp.profile_file(TProfileOptions(), to_port(db),
                         toy_dir.sam_path, device=CPU,
                         engine=_teng(overlap_min_bytes=1))
    assert tp.path_counts["overlap_fallback_bins_past_uint16"] == 2
    assert tp.path_counts["overlap_files"] == 0
    assert_states_equal(_port_whole(db, toy_dir.sam_path), st)


# -- chunk streaming ----------------------------------------------------------


@pytest.mark.parametrize("fetch_coverage", [True, False])
@pytest.mark.parametrize("chunk", [512, 4096])
def test_streaming_matches_jax(chunk, fetch_coverage, big_ds):
    ds, db = big_ds
    eng = _eng(fetch_coverage=fetch_coverage)
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, ds.sam_path,
                               engine=eng, chunk_targets=chunk)
    assert tp.path_counts["stream_files"] == 1
    assert tp.path_counts["stream_chunks_v2"] >= 2
    assert tp.path_counts["pass_b_reuploads"] == 0
    if fetch_coverage:
        assert_states_equal(st_j, st_t)
    else:
        assert st_t.cov is None and st_t.uniq_cov2 is None
        _assert_abundance_equal(st_j, st_t)
        _assert_abundance_equal(_port_whole(db, ds.sam_path), st_t)


def test_streaming_device_cache_zero(big_ds):
    # every piece is kept as a host copy and uploaded again for pass B
    ds, db = big_ds
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, ds.sam_path,
                               engine=_eng(stream_device_cache_bytes=0),
                               chunk_targets=512)
    n = tp.path_counts["stream_chunks_v2"]
    assert n >= 2 and tp.path_counts["pass_b_reuploads"] == n
    assert_states_equal(st_j, st_t)


@pytest.mark.parametrize("fetch_coverage", [True, False])
def test_streaming_v1_chunks(fetch_coverage, big_ds, monkeypatch):
    # bins past V2_MAX_BIN (forced in both packages): int32 chunks from
    # the decode-ahead thread; the device cache holds the first chunk only
    ds, db = big_ds
    monkeypatch.setattr(jp, "V2_MAX_BIN", 0)
    monkeypatch.setattr(tp, "V2_MAX_BIN", 0)
    eng = _eng(fetch_coverage=fetch_coverage, stream_device_cache_bytes=10000)
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, ds.sam_path,
                               engine=eng, chunk_targets=512)
    n = tp.path_counts["stream_chunks_v1"]
    assert n >= 2 and tp.path_counts["stream_chunks_v2"] == 0
    assert 0 < tp.path_counts["pass_b_reuploads"] < n
    if fetch_coverage:
        assert_states_equal(st_j, st_t)
    else:
        _assert_abundance_equal(st_j, st_t)


def test_streaming_avg_read_length_matches_whole(toy_dir, tmp_path):
    # varying read lengths: the stream's sampled average (hence the auto
    # bin_width) equals the whole-file decode's
    records = [(f"v{k}", 0, k % 5, (37 * k) % 2000, 60 if k < 500 else 180)
               for k in range(3000)]
    sam = write_sam(str(tmp_path), records, name="varlen.sam")
    db = build_toy_db(toy_dir)
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, sam,
                               engine=_eng(), chunk_targets=128)
    st_w = _port_whole(db, sam)
    assert st_w.options.bin_width == st_t.options.bin_width \
        == st_j.options.bin_width
    assert_states_equal(st_j, st_t)
    assert_states_equal(st_w, st_t)


@pytest.fixture(scope="module")
def long_sam(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_long")
    return write_sam(str(d), _long_read_records(np.random.default_rng(23),
                                                110_000), name="long.sam")


@pytest.mark.parametrize("v1", [False, True])
def test_streaming_long_reads_over_pieces(v1, long_sam, toy_dir,
                                          monkeypatch):
    # pieces with and without reads past the shift window, past the
    # reader's 100k-record sample
    db = build_toy_db(toy_dir)
    if v1:
        monkeypatch.setattr(jp, "V2_MAX_BIN", 0)
        monkeypatch.setattr(tp, "V2_MAX_BIN", 0)
    windows = []
    piece_pass_a = tp.piece_pass_a_acc

    def record_plan(*args, window, **kw):
        windows.append(window)
        return piece_pass_a(*args, window=window, **kw)

    monkeypatch.setattr(tp, "piece_pass_a_acc", record_plan)
    st_t = tp.profile_file_streaming(TProfileOptions(), to_port(db),
                                     long_sam, device=CPU, engine=_teng(),
                                     chunk_targets=300)
    assert tp.path_counts["stream_chunks_v1" if v1 else
                          "stream_chunks_v2"] == len(windows) >= 2
    assert 0 in windows and max(windows) > 0
    st_w = jp.profile_file(ProfileOptions(), copy.deepcopy(db), long_sam,
                           engine=_eng())
    assert_states_equal(st_w, st_t)
    assert_states_equal(_port_whole(db, long_sam), st_t)
    if v1:
        st_j = jp.profile_file_streaming(ProfileOptions(), copy.deepcopy(db),
                                         long_sam, engine=_eng(),
                                         chunk_targets=300)
        assert_states_equal(st_j, st_t)


def test_stream_max_targets_is_final_only_at_eof(long_sam, toy_dir):
    # ROADMAP C1: slimm_tpu's v2 chunk streaming plans every piece from
    # sr.max_targets, which the reader gives as 0 until EOF, so pieces with
    # reads of 3+ targets get a window of 1; the port plans each piece from
    # the max run its own C++ take reports
    sr = native.NativeStreamReader(long_sam)
    lengths = np.full(6, 3000, np.uint32)
    seen = []
    while (p := sr.next_piece_v2(8192, 8192, lengths, 50, 100, np.uint8,
                                 with_plan=True)) is not None:
        seen.append((sr.eof, sr.max_targets, p[5]))
    assert (False, 0, 6) in seen and seen[-1][:2] == (True, 6)
    db = build_toy_db(toy_dir)
    st_w = jp.profile_file(ProfileOptions(), copy.deepcopy(db), long_sam,
                           engine=_eng())
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, long_sam,
                               engine=_eng(), chunk_targets=8192)
    assert st_t.uniq_matches_count2 == st_w.uniq_matches_count2
    assert st_j.uniq_matches_count2 != st_w.uniq_matches_count2


def test_streaming_non_grouped(toy_dir, tmp_path):
    sam = write_sam(str(tmp_path), _non_grouped_records(),
                    name="nongrouped.sam")
    db = build_toy_db(toy_dir)
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, sam,
                               engine=_eng(), chunk_targets=64)
    assert tp.path_counts["stream_files"] == 1
    assert_states_equal(st_j, st_t)


def test_late_regroup_falls_back(tmp_path, monkeypatch):
    # a read reappearing far away, seen only after pieces went out: both
    # streamed paths give way to the whole-file decode, with bin_width
    # restored (the parallel decoder's probe is forced on a small file)
    monkeypatch.setenv("SLIMM_PARALLEL_MIN_BYTES", "65536")
    monkeypatch.setenv("SLIMM_DECODE_THREADS", "3")
    records = [(f"a{k:06d}", 0, k % 5, (13 * k) % 2500, 8)
               for k in range(300000)]
    records.append(("a000050", 0, 2, 99, 8))
    sam = write_sam(str(tmp_path), records, name="lateshuffle.sam")
    db = build_toy_db(build_toy_dataset(str(tmp_path)))
    seen = _fallback_bin_widths(monkeypatch)
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db, sam,
                               engine=_eng(), chunk_targets=8192)
    assert tp.path_counts["stream_files"] == 0
    assert tp.path_counts["stream_fallback_not_grouped"] == 1
    assert seen == [0]
    assert_states_equal(st_j, st_t)
    options = TProfileOptions()
    assert tp._profile_file_overlap(
        options, to_port(db), sam, device=CPU,
        engine=_teng(overlap_piece_targets=8192)) is None
    assert options.bin_width == 0
    assert tp.path_counts["overlap_fallback_not_grouped"] == 1


@pytest.mark.parametrize("path", ["overlap", "stream"])
def test_streamed_paths_zero_mapped(path, toy_dir, tmp_path):
    # no mapped record: both packages warn and return the early state
    sam = write_sam(str(tmp_path), [(f"u{k}", 0x4, -1, -1, 80)
                                    for k in range(40)], name="unmapped.sam")
    db = build_toy_db(toy_dir)
    if path == "overlap":
        st_j = jp._profile_file_overlap(ProfileOptions(), copy.deepcopy(db),
                                        sam, _eng())
        st_t = tp._profile_file_overlap(TProfileOptions(), to_port(db),
                                        sam, device=CPU, engine=_teng())
    else:
        st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                                   tp.profile_file_streaming, db, sam,
                                   engine=_eng())
    assert st_j.hits_count == st_t.hits_count == 0
    assert st_j.matches_count == st_t.matches_count
    assert tp.path_counts[f"{path}_files"] == 1


@pytest.mark.parametrize("entry", ["overlap", "streaming", "propagate"])
def test_failed_native_build_raises(entry, toy_dir, monkeypatch):
    # no silent fallback: where the native library cannot be built, the
    # streamed paths and the native propagation raise
    db = to_port(build_toy_db(toy_dir))

    def fail():
        raise RuntimeError("g++ failed on native/slimm_native.cpp")

    monkeypatch.setattr(native, "load_library", fail)
    if entry == "overlap":
        def call():
            return tp.profile_file(TProfileOptions(), db, toy_dir.sam_path,
                                   device=CPU,
                                   engine=_teng(overlap_min_bytes=1))
    elif entry == "streaming":
        def call():
            return tp.profile_file_streaming(TProfileOptions(), db,
                                             toy_dir.sam_path, device=CPU,
                                             engine=_teng())
    else:
        # the Python decoder, then propagate_counts past its native bound
        monkeypatch.setattr(ProfileState, "NATIVE_PROPAGATE_MIN", 0)

        def call():
            return tp.profile_file(TProfileOptions(), db, toy_dir.sam_path,
                                   device=CPU,
                                   engine=_teng(use_native=False,
                                                overlap_min_bytes=0))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as raised:
        call()
    if entry == "propagate":
        assert "_propagate_native" in [e.name for e in raised.traceback]
        assert tp.work_counts["python_propagations"] == 0
    assert not any(n for key, n in tp.path_counts.items()
                   if "fallback" in key)
    assert tp.path_counts["overlap_files"] == tp.path_counts[
        "stream_files"] == 0


def test_give_way_where_the_reader_cannot_open(toy_dir, monkeypatch):
    # the stream reader refuses the file: both streamed paths give way
    # before anything is set up, with the caller's bin_width as it was
    db = build_toy_db(toy_dir)
    st_w = _port_whole(db, toy_dir.sam_path)

    def refuse(self, path, *args, **kw):
        raise ValueError(f"{path}: the stream reader cannot take it")

    monkeypatch.setattr(native.NativeStreamReader, "__init__", refuse)
    options = TProfileOptions()
    assert tp._profile_file_overlap(options, to_port(db),
                                    toy_dir.sam_path, device=CPU,
                                    engine=_teng()) is None
    assert options.bin_width == 0
    assert tp.path_counts["overlap_fallback_open"] == 1
    seen = _fallback_bin_widths(monkeypatch)
    st_s = tp.profile_file_streaming(TProfileOptions(), to_port(db),
                                     toy_dir.sam_path, device=CPU,
                                     engine=_teng(overlap_min_bytes=1))
    # streaming gives way to profile_file, whose overlap path gives way too
    assert seen == [0]
    assert tp.path_counts["stream_fallback_open"] == 1
    assert tp.path_counts["overlap_fallback_open"] == 2
    assert tp.path_counts["stream_files"] == 0
    assert_states_equal(st_w, st_s)


def test_give_way_on_overflow(toy_dir, monkeypatch):
    # one read's targets past a piece: the reader raises OverflowError and
    # both streamed paths give way, with bin_width restored
    db = build_toy_db(toy_dir)
    st_w = _port_whole(db, toy_dir.sam_path)

    def overflow(*args, **kw):
        raise OverflowError("single read exceeds the piece cap")

    monkeypatch.setattr(native.NativeStreamReader, "next_piece_v2", overflow)
    options = TProfileOptions()
    assert tp._profile_file_overlap(options, to_port(db),
                                    toy_dir.sam_path, device=CPU,
                                    engine=_teng()) is None
    assert options.bin_width == 0
    assert tp.path_counts["overlap_fallback_overflow"] == 1
    seen = _fallback_bin_widths(monkeypatch)
    st_j, st_t = _jax_and_port(jp.profile_file_streaming,
                               tp.profile_file_streaming, db,
                               toy_dir.sam_path, engine=_eng())
    assert seen == [0]
    assert tp.path_counts["stream_fallback_overflow"] == 1
    assert tp.path_counts["stream_files"] == 0
    assert_states_equal(st_j, st_t)
    assert_states_equal(st_w, st_t)


def test_streamed_paths_run_without_jax(toy_dir, tmp_path):
    # the card's machine has no JAX: both streamed paths with jax made
    # unimportable, against slimm_tpu's streaming in this process
    db_path = str(tmp_path / "toy.sldb")
    build_toy_db(toy_dir).save_sldb(db_path)
    code = (
        "import copy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['slimm_tpu'] = None\n"
        "import torch\n"
        "from slimm_tpu_torch.config import EngineOptions, ProfileOptions\n"
        "from slimm_tpu_torch.database import SlimmDatabase\n"
        "from slimm_tpu_torch.engine import pipeline as tp\n"
        f"db = SlimmDatabase.load({db_path!r})\n"
        "cpu = torch.device('cpu')\n"
        "eng = EngineOptions(phase_log=False, overlap_min_bytes=1,\n"
        "                    overlap_piece_targets=2048)\n"
        "a = tp.profile_file(ProfileOptions(), copy.deepcopy(db), "
        f"{toy_dir.sam_path!r}, device=cpu, engine=eng)\n"
        "b = tp.profile_file_streaming(ProfileOptions(), copy.deepcopy(db), "
        f"{toy_dir.sam_path!r}, device=cpu, engine=eng, chunk_targets=512)\n"
        "assert tp.path_counts['overlap_files'] == 1\n"
        "assert tp.path_counts['stream_files'] == 1\n"
        "assert not any(m in ('jax', 'slimm_tpu') or m.startswith(('jax.', "
        "'slimm_tpu.')) for m in sys.modules if sys.modules[m] is not None)\n"
        "print(repr(a.abundance_rows()))\n"
        "print(repr(b.abundance_rows()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    st_j = jp.profile_file_streaming(
        ProfileOptions(), build_toy_db(toy_dir), toy_dir.sam_path,
        engine=_eng(), chunk_targets=512)
    want = repr(st_j.abundance_rows())
    assert proc.stdout.splitlines() == [want, want]
