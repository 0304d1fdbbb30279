"""slimm_tpu_torch's profile core against slimm_tpu's, function by function,
on the same numpy inputs: the segment helpers, pass A, the cutoffs and the
whole fused profile (its packed int32 vector and coverage histograms).  JAX
runs on the CPU with use_pallas=False, as its own CPU tests run it.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from __graft_entry__ import _example_tables
from slimm_tpu.engine import pipeline as jp
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.tables import DeviceTables

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grouped_read_ids(rng, n_reads, max_run):
    runs = rng.integers(1, max_run + 1, n_reads)
    return np.repeat(np.arange(n_reads, dtype=np.int32), runs)


# -- segment helpers ---------------------------------------------------------

SEG_COMBINES = [
    ("add", jnp.add, torch.add, 0),
    ("max", jnp.maximum, torch.maximum, -1),
    ("or", jnp.bitwise_or, torch.bitwise_or, 0),
]


@pytest.mark.parametrize("max_run", [1, 3, 5, 13, 20])
@pytest.mark.parametrize("name,jcomb,tcomb,identity", SEG_COMBINES,
                         ids=[c[0] for c in SEG_COMBINES])
def test_seg_end_reduce_and_backfill(max_run, name, jcomb, tcomb, identity):
    rng = np.random.default_rng(max_run)
    read_id = _grouped_read_ids(rng, 300, max_run)
    _, k_steps, window = jp.seg_plan(read_id)
    assert (window > 0) == (max_run <= 5)
    vals = rng.integers(0, 64, len(read_id)).astype(np.int32)
    j = jp._seg_end_reduce(jnp.asarray(read_id), jnp.asarray(vals), jcomb,
                           jnp.int32(identity), k_steps=k_steps,
                           window=window)
    t = tp._seg_end_reduce(_t(read_id), _t(vals), tcomb, identity,
                           k_steps=k_steps, window=window)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    end_mask = read_id != np.r_[read_id[1:], -3]
    jb = jp._backfill_from_ends(jnp.asarray(read_id), j, jnp.asarray(end_mask),
                                jnp.int32(-1), k_steps=k_steps, window=window)
    tb = tp._backfill_from_ends(_t(read_id), t, _t(end_mask), -1,
                                k_steps=k_steps, window=window)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# -- pass A ------------------------------------------------------------------


def _tables(lengths, bin_offset, bin_ends, lineage, sk_code, n_dense, n_codes,
            half, bin_width, q=0.95):
    return DeviceTables.from_numpy(lengths, bin_offset, bin_ends, lineage,
                                   sk_code, n_dense=n_dense, n_codes=n_codes,
                                   half=half, bin_width=bin_width, q=q,
                                   device="cpu")


def _compare_pass_a(j, t, n_bins):
    for key in ("t_gbin", "nondup"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]),
                                      err_msg=key)
    for key in ("cov", "uniq_cov"):
        jh = np.asarray(j[key])
        np.testing.assert_array_equal(t[key].numpy(), jh[:n_bins], err_msg=key)
        assert not jh[n_bins:].any()
    assert int(t["uniq_matches"]) == int(j["uniq_matches"])
    assert t["uniq_matches"].dtype == torch.int32


@pytest.mark.parametrize("dedup_window", [0, 2])
def test_pass_a_matches_jax(dedup_window):
    (lengths, boff, bends, tbp, read_id, rid, pos, lineage, sk_code,
     n_codes) = _example_tables(n_contigs=8, n_records=512, n_reads=300)
    _, k_steps, window = jp.seg_plan(read_id)
    j = jp._pass_a_local(
        jnp.asarray(read_id), jnp.asarray(rid), jnp.asarray(pos),
        jnp.asarray(lengths), jnp.asarray(boff), np.int32(50), np.int32(100),
        n_contigs=8, total_bins_pad=tbp, dedup_window=dedup_window,
        k_steps=k_steps, window=window)
    t = tp._pass_a_local(_t(read_id), _t(rid), _t(pos),
                         _tables(lengths, boff, bends, lineage, sk_code, 32,
                                 n_codes, 50, 100),
                         dedup_window=dedup_window, k_steps=k_steps,
                         window=window)
    _compare_pass_a(j, t, int(bends[-1]))


def test_pass_a_chromosome_scale_binning():
    # lengths and bin offsets above 2^24, and positions that wrap uint32
    # when the half read length is added (slimm.hpp:200-201)
    rng = np.random.default_rng(5)
    n_contigs = 5
    lengths = np.array([700_000_000, 650_000_001, 700_000_000,
                        700_000_000, 120_000_000], np.uint32)
    bw, half = 150, 75
    nbins = lengths // np.uint32(bw) + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    bends = (boff + nbins).astype(np.int32)
    assert int(lengths.max()) > (1 << 24) and int(boff.max()) > (1 << 24)
    n = 4096
    read_id = np.arange(n, dtype=np.int32)
    rid = rng.integers(0, n_contigs, n).astype(np.int32)
    pos = (rng.random(n) * (lengths[rid] - 150)).astype(np.int64).astype(
        np.int32)
    pos[:4] = [-1, -75, -76, np.iinfo(np.int32).min]
    tbp = -(-int(nbins.sum()) // 1024) * 1024
    lineage = np.zeros((n_contigs, 8), np.int32)
    sk_code = np.zeros(n_contigs, np.int32)
    j = jp._pass_a_local(
        jnp.asarray(read_id), jnp.asarray(rid), jnp.asarray(pos),
        jnp.asarray(lengths), jnp.asarray(boff), np.int32(half), np.int32(bw),
        n_contigs=n_contigs, total_bins_pad=tbp, dedup_window=0, k_steps=2,
        window=1)
    t = tp._pass_a_local(_t(read_id), _t(rid), _t(pos),
                         _tables(lengths, boff, bends, lineage, sk_code, 1, 9,
                                 half, bw),
                         dedup_window=0, k_steps=2, window=1)
    _compare_pass_a(j, t, int(bends[-1]))
    center = np.minimum(pos.astype(np.uint32) + np.uint32(half), lengths[rid])
    expect = boff[rid] + (center // np.uint32(bw)).astype(np.int32)
    np.testing.assert_array_equal(t["t_gbin"].numpy(), expect)


# -- cutoffs -----------------------------------------------------------------


def _cutoff_case(kind):
    rng = np.random.default_rng(7)
    C = 40
    nbins = rng.integers(1, 60, C)
    nzc = (rng.random(C) * (nbins + 1)).astype(np.int32)
    nzu = np.minimum(nzc, (rng.random(C) * (nbins + 1)).astype(np.int32))
    rc = nzc * rng.integers(1, 4, C).astype(np.int32)
    urc = np.where(rng.random(C) < 0.7, nzu, 0).astype(np.int32)
    q = 0.95
    if kind == "zero_total":       # selected contigs all at 0 % coverage
        nzc[urc > 0] = 0
    elif kind == "empty_selection":
        urc[:] = 0
    elif kind == "q_one":
        q = 1.0
    elif kind == "q_half":
        q = 0.5
    return nbins, rc, nzc, urc, nzu, q


@pytest.mark.parametrize("kind", ["random", "zero_total", "empty_selection",
                                  "q_one", "q_half"])
def test_cutoffs_match_quantile2_dev(kind):
    nbins, rc, nzc, urc, nzu, q = _cutoff_case(kind)
    nbins_f = nbins.astype(np.float32)
    covp = nzc.astype(np.float32) / nbins_f
    ucovp = nzu.astype(np.float32) / nbins_f
    cc_q, ucc_q = jp._quantile2_dev(jnp.asarray(covp), jnp.asarray(ucovp),
                                    jnp.asarray(urc > 0), jnp.float32(q))
    use_cut = np.float32(q) < np.float32(1.0)
    want_cc = np.float32(cc_q) if use_cut else np.float32(0.0)
    want_ucc = np.float32(ucc_q) if use_cut else np.float32(0.0)
    want_valid = (rc > 0) & (covp >= want_cc) & (ucovp >= want_ucc)

    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    t = _tables(nbins * 10, boff, boff + nbins, np.zeros((len(nbins), 8)),
                np.zeros(len(nbins)), 1, 9, 5, 10, q=q)
    cc, ucc, valid = tp._cutoffs(_t(rc), _t(nzc), _t(urc), _t(nzu), t)
    assert np.float32(cc).view(np.int32) == want_cc.view(np.int32)
    assert np.float32(ucc).view(np.int32) == want_ucc.view(np.int32)
    np.testing.assert_array_equal(valid.numpy(), want_valid)


def test_contig_sums_nz():
    rng = np.random.default_rng(8)
    nbins = rng.integers(1, 300, 30)
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    bends = (boff + nbins).astype(np.int32)
    vals = np.where(rng.random(int(nbins.sum())) < 0.3,
                    rng.integers(1, 100_000, int(nbins.sum())), 0
                    ).astype(np.int32)
    t = _tables(nbins * 10, boff, bends, np.zeros((30, 8)), np.zeros(30),
                1, 9, 5, 10)
    s, nz = tp._contig_sums_nz(_t(vals), t)
    assert s.dtype == nz.dtype == torch.int32
    np.testing.assert_array_equal(
        s.numpy(), [vals[a:b].sum() for a, b in zip(boff, bends)])
    np.testing.assert_array_equal(
        nz.numpy(), [(vals[a:b] > 0).sum() for a, b in zip(boff, bends)])


def test_pack_bits_words_matches_packbits():
    rng = np.random.default_rng(9)
    bits = rng.random(32 * 64) < 0.5
    bits[31::32] = True             # bit 31 set: the int32 words wrap
    words = tp._pack_bits_words(_t(bits))
    assert words.dtype == torch.int32 and (words < 0).all()
    assert words.numpy().tobytes() == np.packbits(
        bits, bitorder="little").tobytes()


# -- the whole fused profile -------------------------------------------------


def _example_inputs():
    (lengths, boff, bends, tbp, read_id, rid, pos, lineage, sk_code,
     n_codes) = _example_tables(n_contigs=8)
    return dict(lengths=lengths, boff=boff, bends=bends, tbp=tbp,
                read_id=read_id, rid=rid, pos=pos, lineage=lineage,
                sk_code=sk_code, n_dense=32, n_codes=n_codes, half=50, bw=100)


def _workload_inputs():
    w = bench.make_workload(20_000, 50, seed=4)
    bw = w["avg_read_len"]
    nbins = w["lengths"] // np.uint32(bw) + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    return dict(lengths=w["lengths"], boff=boff,
                bends=(boff + nbins).astype(np.int32),
                tbp=-(-int(nbins.sum()) // 1024) * 1024,
                read_id=w["read_id"], rid=w["rid"], pos=w["pos"],
                lineage=w["lineage"], sk_code=w["sk_code"],
                n_dense=w["n_dense"], n_codes=w["n_codes"], half=bw // 2,
                bw=bw)


def _host_dedup(x):
    key = x["read_id"].astype(np.int64) * len(x["lengths"]) + x["rid"]
    _, first = np.unique(key, return_index=True)
    first.sort()
    return dict(x, read_id=x["read_id"][first], rid=x["rid"][first],
                pos=x["pos"][first])


# (inputs, plan): device dedup over the shift window, device dedup with the
# doubling scans, and host dedup (dedup_window 0) under either plan
CORE_CASES = {
    "example_host_dedup": lambda: (_host_dedup(_example_inputs()), None),
    "workload_window": lambda: (_workload_inputs(), (2, 2, 2)),
    "workload_doubling": lambda: (_workload_inputs(), (2, 4, 0)),
    "workload_host_dedup": lambda: (_host_dedup(_workload_inputs()), None),
}


@pytest.mark.parametrize("emit_coverage", [True, False])
@pytest.mark.parametrize("case", list(CORE_CASES))
def test_fused_profile_matches_jax(case, emit_coverage):
    x, plan = CORE_CASES[case]()
    if plan is None:
        _, k_steps, window = jp.seg_plan(x["read_id"])
        plan = (0, k_steps, window)
    dedup_window, k_steps, window = plan
    C = len(x["lengths"])
    q = np.float32(0.95)
    j = jp.fused_profile(
        x["read_id"], x["rid"], x["pos"], x["lengths"].astype(np.uint32),
        x["boff"], x["bends"], np.int32(x["half"]), np.int32(x["bw"]),
        x["lineage"], x["sk_code"], q, n_contigs=C, total_bins_pad=x["tbp"],
        n_dense=x["n_dense"], n_codes=x["n_codes"],
        dedup_window=dedup_window, k_steps=k_steps, window=window,
        use_pallas=False, emit_coverage=emit_coverage)
    tables = _tables(x["lengths"], x["boff"], x["bends"], x["lineage"],
                     x["sk_code"], x["n_dense"], x["n_codes"], x["half"],
                     x["bw"], q=q)
    t = tp.fused_profile(_t(x["read_id"]), _t(x["rid"]), _t(x["pos"]), tables,
                         dedup_window=dedup_window, k_steps=k_steps,
                         window=window, emit_coverage=emit_coverage)
    assert t["packed"].dtype == torch.int32
    np.testing.assert_array_equal(t["packed"].numpy(), np.asarray(j["packed"]))
    stats = tp.unpack_stats(t["packed"].numpy(), C, x["n_dense"])
    assert stats["reads_count"].sum() > 0 and stats["taxon_counts"].sum() > 0
    if emit_coverage:
        n_bins = int(x["bends"][-1])
        for key in ("cov", "uniq_cov", "uniq_cov2"):
            np.testing.assert_array_equal(t[key].numpy(),
                                          np.asarray(j[key])[:n_bins],
                                          err_msg=key)
    else:
        assert set(t) == {"packed"}
