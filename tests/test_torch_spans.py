"""slimm_tpu_torch's spans and work counters, on the CPU.

Under torch.profiler every entry point's outermost call is one
`slimm.profile` span whose children name the stages in the order they run
(utils/timer.py `span`, engine/pipeline.py); the spans add no mark to
`pipeline.host_marks` and change no output.  `pipeline.work_counts` counts
calls, host-to-device bytes, minor faults and CPU seconds, and
`reset_path_counts` zeroes it beside `path_counts`."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slimm_tpu_torch.config import BuildOptions, EngineOptions, ProfileOptions
from slimm_tpu_torch.database import build_database
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.engine import reports
from slimm_tpu_torch.io import native

from tests.toy import build_toy_dataset, make_records, write_sam

torch.set_num_threads(1)

CPU = torch.device("cpu")

# the keys of path_counts before the work counters came: they stay exactly
PATH_KEYS = {
    "overlap_files", "overlap_pieces",
    "overlap_fallback_open", "overlap_fallback_bins_past_uint16",
    "overlap_fallback_overflow", "overlap_fallback_not_grouped",
    "stream_files", "stream_chunks_v2", "stream_chunks_v1",
    "stream_fallback_open",
    "stream_fallback_not_grouped", "stream_fallback_overflow",
    "pass_b_reuploads", "sharded_files", "batched_groups",
    "batched_fallback_per_file"}

CORE = "upload plan pass_a cutoffs pass_b fetch finalize"
PIECES = ("(decode_wait upload pass_a )+decode_wait cutoffs pass_b fetch "
          "finalize")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    native.build()
    d = str(tmp_path_factory.mktemp("spans"))
    ds = build_toy_dataset(d, n_extra=4000)
    db = build_database(BuildOptions(
        fasta_path=ds.fasta_path, ac__taxid_paths=[ds.acc2taxid_path],
        names_path=ds.names_path, nodes_path=ds.nodes_path,
        output_path=os.path.join(d, "toy.sldb")))
    group = [write_sam(d, make_records(n_extra=200, seed=k), name=f"g{k}.sam")
             for k in range(3)]
    other = os.path.join(d, "other.sam")
    with open(group[1]) as f, open(other, "w") as g:
        g.write(f.read().replace("LN:9000", "LN:9001", 1))
    af = native.NativeAlignmentFile(ds.sam_path)
    try:
        b = af.load()
        arrays = dict(read_id=b.read_id.astype(np.int32), rid=b.rid,
                      pos=b.pos, n_reads=b.n_reads, hits_count=b.hits_count,
                      avg=b.avg_read_length, max_targets=b.max_targets)
    finally:
        af.close()
    return dict(dir=d, sam=ds.sam_path, db=db, group=group,
                mixed=[group[0], other], arrays=arrays)


def _eng(**kw):
    return EngineOptions(phase_log=False, **kw)


def _arrays(toy, deduped):
    a = toy["arrays"]
    read_id, rid, pos = a["read_id"], a["rid"], a["pos"]
    if not deduped:
        # raw records in no order: the plan sorts them and dedups
        order = np.random.default_rng(3).permutation(len(read_id))
        read_id, rid, pos = read_id[order], rid[order], pos[order]
    return tp.profile_arrays(
        ProfileOptions(), toy["db"], *_header(toy), read_id, rid, pos,
        a["n_reads"], a["hits_count"], a["avg"], device=CPU, engine=_eng(),
        deduped=deduped, max_targets=a["max_targets"] if deduped else 0)


def _header(toy):
    sr = native.NativeStreamReader(toy["sam"])
    try:
        return list(sr.contig_names), np.asarray(sr.contig_lengths)
    finally:
        sr.close()


# entry point -> (call(toy) -> [ProfileState], the stages under its
# slimm.profile as a pattern, the host_marks it gives)
ENTRIES = {
    "arrays_raw": (
        lambda toy: [_arrays(toy, deduped=False)],
        f"init init {CORE}", ["cutoffs"]),
    "arrays_deduped": (
        lambda toy: [_arrays(toy, deduped=True)],
        f"init init {CORE}", ["cutoffs"]),
    "file_whole": (
        lambda toy: [tp.profile_file(ProfileOptions(), toy["db"], toy["sam"],
                                     device=CPU,
                                     engine=_eng(overlap_min_bytes=0))],
        f"decode_wait init init {CORE}", ["cutoffs"]),
    "file_overlap": (
        lambda toy: [tp.profile_file(
            ProfileOptions(), toy["db"], toy["sam"], device=CPU,
            engine=_eng(overlap_min_bytes=1, overlap_piece_targets=2048))],
        f"decode_wait init init {PIECES}", ["cutoffs"]),
    "streaming": (
        lambda toy: [tp.profile_file_streaming(
            ProfileOptions(), toy["db"], toy["sam"], device=CPU,
            engine=_eng(batch_pad=2048), chunk_targets=2048)],
        f"decode_wait init init {PIECES}", ["cutoffs"]),
    "batched": (
        lambda toy: [st for _, st in tp.profile_files_batched(
            ProfileOptions(), toy["db"], toy["group"], device=CPU,
            engine=_eng())],
        "decode_wait init plan plan init upload pass_a cutoffs pass_b fetch"
        "( fetch finalize){3}",
        ["cutoffs"]),
    "batched_per_file": (
        lambda toy: [st for _, st in tp.profile_files_batched(
            ProfileOptions(), toy["db"], toy["mixed"], device=CPU,
            engine=_eng(overlap_min_bytes=0))],
        f"decode_wait( decode_wait init init {CORE}){{2}}",
        ["cutoffs", "cutoffs"]),
}


def _traced(call):
    """call() inside torch.profiler: (its result, the trace's events as
    (name, start ns, end ns), parents before children)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, sorted(events, key=lambda e: (e[1], -e[2]))


def _inside(e, outer):
    return outer[1] <= e[1] and e[2] <= outer[2] and e is not outer


def _children(parent, events):
    """The events right under `parent`: inside it, and inside no other
    event of `events` that is inside it."""
    within = [e for e in events if _inside(e, parent)]
    return [e for e in within if not any(_inside(e, o) for o in within)]


@pytest.fixture(autouse=True)
def fresh_counts():
    tp.reset_path_counts()
    yield
    tp.host_marks = None


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_stages_are_spans_under_one_profile_in_order(toy, entry):
    call, stages, marks = ENTRIES[entry]
    tp.host_marks = []
    states, events = _traced(lambda: call(toy))
    assert [p for p, _ in tp.host_marks] == marks

    assert not [e for e in events if e[0].startswith("pb.")]
    ours = [e for e in events if e[0].startswith("slimm.")]
    profiles = [e for e in ours if e[0] == "slimm.profile"]
    assert len(profiles) == 1 and tp.work_counts["calls"] == 1
    assert all(_inside(e, profiles[0]) for e in ours if e is not profiles[0])
    for e in ours:
        assert not [o for o in ours if o[0] == e[0] and _inside(e, o)], e
    names = " ".join(e[0][len("slimm."):] for e in
                     _children(profiles[0], ours))
    assert re.fullmatch(stages, names), names
    if "overlap" in entry or "streaming" in entry:
        pieces = (tp.path_counts["overlap_pieces"]
                  + tp.path_counts["stream_chunks_v2"])
        assert pieces >= 2 and names.count("upload") == pieces

    _, written = _traced(lambda: [reports.write_abundance(
        st, os.path.join(toy["dir"], entry) + "/", toy["sam"])
        for st in states])
    reps = [e for e in written if e[0].startswith("slimm.")]
    assert [e[0] for e in reps] == ["slimm.report"] * len(states)


def _equal(x, y, name):
    if isinstance(x, dict) and isinstance(y, dict):
        assert x.keys() == y.keys(), name
        for k in x:
            _equal(x[k], y[k], f"{name}[{k!r}]")
    elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        assert type(x) is type(y) and x.dtype == y.dtype, name
        assert np.array_equal(x, y), name
    else:
        assert x == y, name


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        _equal(getattr(a, f.name), getattr(b, f.name), f.name)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_outputs_are_the_same_with_a_profiler_running(toy, entry, tmp_path):
    call = ENTRIES[entry][0]
    plain = call(toy)
    traced, _ = _traced(lambda: call(toy))
    assert len(plain) == len(traced)
    for k, (a, b) in enumerate(zip(plain, traced)):
        _fields_equal(a, b)
        tsv = [reports.write_abundance(st, str(tmp_path / side) + "/",
                                       f"s{k}.sam")
               for st, side in ((a, "plain"), (b, "traced"))]
        with open(tsv[0], "rb") as f, open(tsv[1], "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("entry", list(ENTRIES) + ["streaming_fallback"])
def test_calls_counts_outermost_calls(toy, entry, monkeypatch):
    if entry == "streaming_fallback":
        # one read's targets past a piece: profile_file_streaming gives way
        # to profile_file, which calls profile_arrays: one request
        def overflow(*args, **kw):
            raise OverflowError("single read exceeds the piece cap")

        monkeypatch.setattr(native.NativeStreamReader, "next_piece_v2",
                            overflow)

        def call(toy):
            return [tp.profile_file_streaming(
                ProfileOptions(), toy["db"], toy["sam"], device=CPU,
                engine=_eng())]
    else:
        call = ENTRIES[entry][0]
    call(toy)
    assert tp.work_counts["calls"] == 1
    call(toy)
    assert tp.work_counts["calls"] == 2
    assert tp.work_counts["h2d_bytes"] > 0
    assert tp.work_counts["minor_faults"] >= 0
    assert tp.work_counts["cpu_s"] > 0
    if entry == "streaming_fallback":
        assert tp.path_counts["stream_fallback_overflow"] == 2
        assert tp.path_counts["stream_files"] == 0


@pytest.mark.parametrize("deduped", [False, True], ids=["raw", "deduped"])
def test_h2d_bytes_of_profile_arrays(toy, deduped):
    """Records as three int32 arrays, the tables (int64 lengths; int32
    offsets, ends, 8 lineage levels and superkingdom codes per contig; the
    256-entry first-level table), the validity mask (a byte per contig)
    and the two float32 cutoffs."""
    st = _arrays(toy, deduped)
    C = len(st.accessions)
    records = len(toy["arrays"]["read_id"])
    tables = C * (8 + 4 + 4 + 8 * 4 + 4) + 256 * 4
    assert tp.work_counts["h2d_bytes"] == records * 12 + tables + C + 8


def test_reset_path_counts_zeroes_both_dicts(toy):
    ENTRIES["file_overlap"][0](toy)
    assert tp.path_counts["overlap_files"] == 1
    assert tp.work_counts["calls"] == 1 and tp.work_counts["h2d_bytes"] > 0
    tp.reset_path_counts()
    assert not any(tp.path_counts.values())
    assert tp.work_counts == {"calls": 0, "h2d_bytes": 0, "minor_faults": 0,
                              "cpu_s": 0.0, "device_plans": 0,
                              "host_plans": 0, "native_propagations": 0,
                              "python_propagations": 0, "lca_taxa": 0,
                              "quantile_walks": 0, "quantile_values": 0,
                              "lca_pairs": 0, "children_sets": 0}
    assert set(tp.path_counts) == PATH_KEYS


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_pairs_and_propagate_nest_once_in_each_finalize(toy, entry):
    """`slimm.pairs`, then `slimm.propagate`, once inside every
    `slimm.finalize`, after the two coverage-quantile walks of
    `compute_valid_refs`: a file's finalize holds both, and neither stands
    outside one."""
    states, events = _traced(lambda: ENTRIES[entry][0](toy))
    ours = [e for e in events if e[0].startswith("slimm.")]
    finalizes = [e for e in ours if e[0] == "slimm.finalize"]
    assert len(finalizes) == len(states) >= 1
    for f in finalizes:
        inner = [e[0] for e in ours if _inside(e, f)]
        assert inner == ["slimm.quantile", "slimm.quantile", "slimm.pairs",
                         "slimm.propagate"], inner
    nested = [e for e in ours if e[0] in ("slimm.pairs", "slimm.propagate")]
    assert len(nested) == 2 * len(finalizes)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_propagations_are_counted_by_path(toy, entry):
    """One propagation a profiled file, in Python below
    NATIVE_PROPAGATE_MIN LCA taxa (the toy's few), with the taxa summed;
    the decoded (LCA, contig) pairs are counted, and the Python route fills
    one children set from them for each LCA taxon."""
    states = ENTRIES[entry][0](toy)
    counts = tp.work_counts
    assert counts["python_propagations"] == len(states)
    assert counts["native_propagations"] == 0
    assert 0 < counts["lca_taxa"] < (
        len(states) * states[0].NATIVE_PROPAGATE_MIN)
    assert counts["children_sets"] == counts["lca_taxa"]
    assert counts["lca_pairs"] >= counts["children_sets"]
    assert all(st.lca_pairs is None for st in states)
    tp.reset_path_counts()
    assert counts["python_propagations"] == 0
    assert counts["lca_taxa"] == counts["lca_pairs"] == 0
    assert counts["children_sets"] == 0


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_quantile_walks_nest_in_cutoffs_and_finalize(toy, entry):
    """Each `slimm.quantile` lies right under a `slimm.cutoffs` (two for
    each file the cutoffs cover: cc and ucc) or a `slimm.finalize` (two in
    each, `compute_valid_refs`), and nowhere else."""
    states, events = _traced(lambda: ENTRIES[entry][0](toy))
    ours = [e for e in events if e[0].startswith("slimm.")]
    walks = [e for e in ours if e[0] == "slimm.quantile"]
    parents = []
    for w in walks:
        around = [o for o in ours if _inside(w, o)]
        parents.append(min(around, key=lambda o: o[2] - o[1])[0])
    assert set(parents) == {"slimm.cutoffs", "slimm.finalize"}, parents
    assert parents.count("slimm.finalize") == 2 * len(states)
    assert parents.count("slimm.cutoffs") == 2 * len(states)
    for f in (e for e in ours if e[0] == "slimm.finalize"):
        assert sum(_inside(w, f) for w in walks) == 2
    cutoffs = [sum(_inside(w, c) for w in walks)
               for c in ours if c[0] == "slimm.cutoffs"]
    assert cutoffs == ([2 * len(states)] if entry == "batched"
                       else [2] * len(states)), cutoffs


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_quantile_walks_are_counted(toy, entry):
    """Four walks a profiled file (cc and ucc in the cutoffs, again in its
    finalize), each over the file's contigs with unique reads; a batched
    group's cutoffs walk each of its files."""
    states = ENTRIES[entry][0](toy)
    active = sum(int((st.uniq_reads_count > 0).sum()) for st in states)
    assert active > 0
    assert tp.work_counts["quantile_walks"] == 4 * len(states)
    assert tp.work_counts["quantile_values"] == 4 * active
    tp.reset_path_counts()
    assert tp.work_counts["quantile_walks"] == 0
    assert tp.work_counts["quantile_values"] == 0
