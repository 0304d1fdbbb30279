#!/usr/bin/env python3
"""Smoke run of slimm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root, one CUDA card)

Phases, each timed; any failure raises and the script exits non-zero:

  device   the card's name and power limit, as nvidia-smi reports them
  build    the CUDA kernels of slimm_tpu_torch/csrc/ (nvcc, sm_90a) and the
           native SAM/BAM decoder (g++ from native/ into
           slimm_tpu_torch/_build/, slimm_tpu_torch/io/native.py)
  kernels  each kernel against its plain PyTorch version on the card: the
           main path's real inputs, captured from fused_profile on the 8M x
           50 workload (pass A's bins and weights, pass B's combined index,
           the pair index; and pass B's -ro/-co index), and uniform indices
           at the profile's bin domains (among them a model shard's slice of
           the bins, most records outside it), each at full size and cut to
           a 2^18-record piece, the overlap path's piece; and pass A at the
           full-RefSeq database's size (perfbench/configs/refseq50k.json:
           20M records over 1,333,360,000 bins, past 2^30, hits up to the
           domain's last bin), full size only: bit-equal, one launch a call;
           the kernel, the plain version and one PyTorch call computing the
           same histogram (index_add_, the library yardstick) timed, beside
           the least time the card could take (bytes at 3.35 TB/s); last,
           hist2 over 2^31 - 1 bins, the most the wrapper takes, held to the
           records' own (bin, count) pairs (not timed)
  core     fused_profile (emit_coverage=False, the default CLI path) on the
           bench workloads, 8M records x 50 contigs and 10M x 1000, on cuda
           and on cpu: the packed stats vectors must be equal; then the
           sharded core (slimm_tpu_torch.parallel) on the card at (data,
           model) = (2, 1), (2, 2), (1, 4) and (1, 4), (4, 2): packed
           vectors equal to the unsharded cuda run's, pass A of every shard
           without a host sync, the -ro/-co histograms equal at (2, 2);
           the single-core C++ baseline (io.native.baseline_profile) on the
           same arrays, median of 5, its counters equal to the port's
           unpacked stats, its seconds and the card's ratio to them
  stream   the streamed paths on a 4M-record bench SAM (about 1.3 GB):
           the overlap path (profile_file's default at this size), the
           whole-file path, chunk streaming (v2 pieces, with and without the
           device cache), and at bin widths 40 and 20 the v2 pieces with
           local bins of 32768 and above, v1 chunks and the overlap path's
           fallback past uint16 bins; the path and launch counters of each
           run are read, the abundance TSVs must be equal per bin width and
           to a whole-file run on the CPU; pass A of the pieces must run
           without a host sync (torch's sync debug mode "error"); file
           seconds are the median of 3 beside a decode-only floor.  The
           sharded runs of the same SAM at (data, model) = (2, 2), cuda:0
           in every cell of the grid: profile_file, and chunk streaming
           with the device cache on and at 0 bytes, TSVs equal to the
           overlap run's; the routing of the pieces on the card is timed
           with its one sync per piece, and a 2^19-record piece is routed
           both on the host (numpy) and on the card: parts equal, both
           timed
  bam      the stream phase's workload written as a BAM (BGZF, zlib level
           1): profile_file on it (the path its size gives, read from the
           path counters) and the CLI, both kernels launched, TSVs equal
           to the SAM's; the file's seconds, a decode-only floor and the
           single-thread C++ end to end (single-thread decode +
           baseline_profile, counters equal to the port's), each a median
           of 3 in turns after a warm run; the histogram inputs of
           profile_file's run (with -ro/-co's histograms) and of the CLI's
           captured and each kernel held against its plain version on
           them, as in the kernel phase
  cli      `python -m slimm_tpu_torch profile` on a toy SAM against the
           oracle (--no-device); then the profile CLI on a 1M-record bench
           SAM (which takes the overlap path) with the kernel launch and
           path counts reset and read around it, against the same command
           with --device cpu; `--shards 2`, which on a one-GPU machine must
           exit 1 with the device count, and elsewhere equal the TSV
  dir      `profile -d` on a directory of 16 SAMs of 100,000 records (seeds
           100-115, one header: the bench's 50-contig database), batched in
           groups of 8 (engine.pipeline.profile_files_batched: each group one
           profile, one launch per histogram) and as a per-file loop
           (files_per_dispatch=1): the TSVs equal, and equal to a --device
           cpu run of two of the files; the launch and group counters of
           each run read; seconds of both ways, median of 3 after a warm
           run, in turns, beside a decode-only floor.  The histogram
           inputs of one group of 8 are captured and each kernel held
           against its plain version on them.  One more run of each way
           splits its host time per file into decode, tables, pass A to the
           cutoff sync, pass B and the fetch, _finalize_state and TSV
           writes, read at the pipeline's fixed points (host_marks)
  trace    `profile --trace-dir` on the 1M-record SAM: the TSV equal to the
           untraced run's, and the Chrome trace names both kernels'
           __global__ functions (torch.profiler sees the kernels launched
           through ctypes); the device events' time over the traced
           window (the device's busy share) and the traced run's seconds
  multi    processes over torch.distributed on the 1M-record SAM split by
           read into one SAM per process: a one-process NCCL world on the
           whole SAM and a two-process gloo world on cuda:0 tensors (NCCL
           refuses two ranks on one GPU), each whole-file and streamed; the
           TSV of every process equal to a one-process run's, and the
           payload bytes of every collective each process issued
           (MultiHostRunner.collective_bytes), equal across the processes

With several shards on one card, the sharded numbers measure the cost of
routing and merging, not scale-out.  Nothing of JAX or of slimm_tpu is
imported: both are made unimportable in this process.  The line before the
last is a JSON object describing each kernel, its launches summed over the
path runs of every phase; the last line is {"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}.  The card's numbers come
from this run alone.
"""

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the port runs without JAX and without the JAX package: make any import of
# either fail in this process
sys.modules["jax"] = None
sys.modules["slimm_tpu"] = None

RECORDS = 8_000_000
PIECE = 1 << 18                 # records of an overlap-path piece
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
CORE_WORKLOADS = [(8_000_000, 50, 0), (10_000_000, 1000, 2)]
CLI_RECORDS = 1_000_000
STREAM_RECORDS = 4_000_000
STREAM_CHUNK = 1 << 19
# (data, model) grids of the sharded core, per contig count
SHARDED_CORE = {50: [(2, 1), (2, 2), (1, 4)], 1000: [(1, 4), (4, 2)]}
SHARDED_FILES = (2, 2)
ROUTE_PIECE = 1 << 19
ROUTE_REPS = 10
CHILD_TIMEOUT = 300
DIR_SEEDS = range(100, 116)
DIR_RECORDS = 100_000
DIR_REPS = 3
BAM_REPS = 3
BASELINE_REPS = 5               # the C++ baseline of the cores (bench.py)
# pass A of the full-RefSeq database (perfbench/configs/refseq50k.json): its
# bins, the sum over 50,000 genomes of length // 150 + 1, and a sample's
# records
WIDE_BINS = 1_333_360_000
WIDE_RECORDS = 20_000_000

# kernel launches of the path runs (not of the kernel comparisons), summed
# over the phases: each run resets the counts before it and adds them after
PATH_LAUNCHES = {"slimm_hist1": 0, "slimm_hist2": 0}


def add_launches(hist):
    PATH_LAUNCHES["slimm_hist1"] += hist.hist1_launches
    PATH_LAUNCHES["slimm_hist2"] += hist.hist2_launches
    return hist.hist1_launches, hist.hist2_launches


def grid_of(device, data, model):
    """A (data, model) grid with `device` (cuda: cuda:0) in every cell."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return [[device] * model for _ in range(data)]


def log(msg):
    print(msg, flush=True)


def phase(name, t0):
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def run(cmd, **kw):
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, **kw)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc


def geometry(n_contigs, seed, bin_width=150):
    """Bin-domain sizes of workload.make_workload(n, n_contigs, seed)."""
    import numpy as np

    from slimm_tpu_torch.utils import workload

    w = workload.make_workload(2_000, n_contigs, seed=seed)
    nbins = w["lengths"] // np.uint32(bin_width) + 1
    pair = -(-(n_contigs * w["n_codes"]) // 1024) * 1024
    return int(nbins.sum()), n_contigs + w["n_dense"], pair


def core_inputs(torch, np, pipeline, w, n_contigs, device):
    """fused_profile's record tensors, tables and segment plan for the
    bench workload `w` on `device`."""
    from slimm_tpu_torch.tables import DeviceTables

    bw = w["avg_read_len"]
    nbins = w["lengths"] // np.uint32(bw) + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]])
    read_id, rid, pos, dedup_window, k_steps, window = \
        pipeline.plan_records(w["read_id"], w["rid"], w["pos"], n_contigs,
                              deduped=False)
    tables = DeviceTables.from_numpy(
        w["lengths"], boff, boff + nbins, w["lineage"], w["sk_code"],
        n_dense=w["n_dense"], n_codes=w["n_codes"], half=bw // 2,
        bin_width=bw, q=0.95, device=device)
    records = (read_id, rid, pos)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in records]
    plan = dict(dedup_window=dedup_window, k_steps=k_steps, window=window)
    return args, tables, plan, records


def _load_toy():
    """tests/toy.py, the repository's toy dataset writer, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "slimm_toy", os.path.join(ROOT, "tests", "toy.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def recorded_hists(pipeline):
    """The pipeline's histogram calls while the body runs, as (kernel, idx,
    w1, w2, n_bins) with the tensors cloned; each call still runs."""
    calls = []
    hist1, hist2 = pipeline.hist1, pipeline.hist2

    def rec1(idx, w, n_bins):
        calls.append(("hist1", idx.clone(), w.clone(), None, n_bins))
        return hist1(idx, w, n_bins)

    def rec2(idx, w1, w2, n_bins):
        calls.append(("hist2", idx.clone(), w1.clone(), w2.clone(), n_bins))
        return hist2(idx, w1, w2, n_bins)

    pipeline.hist1, pipeline.hist2 = rec1, rec2
    try:
        yield calls
    finally:
        pipeline.hist1, pipeline.hist2 = hist1, hist2


def capture_main_path(torch, np, pipeline, device):
    """The histogram inputs of fused_profile on the 8M x 50 workload, as the
    main path hands them to the kernels: pass A's (bins, nondup, unique),
    pass B's combined index (pipeline.py _pass_b_local) and the pair index,
    and with -ro/-co pass B's [uniq_cov2 | taxa] index."""
    from slimm_tpu_torch.utils import workload

    args, tables, plan, _ = core_inputs(
        torch, np, pipeline, workload.make_workload(RECORDS, 50, seed=0), 50,
        device)
    with recorded_hists(pipeline) as calls:
        for emit_coverage in (False, True):
            pipeline.fused_profile(*args, tables, emit_coverage=emit_coverage,
                                   **plan)
    kinds = [c[0] for c in calls]
    require(kinds == ["hist2", "hist1", "hist1"] * 2,
            f"fused_profile called the histograms as {kinds}")
    return {"passA_real": calls[0], "passB_real": calls[1],
            "pairs_real": calls[2], "cov2_real": calls[4]}


def library_call(torch, kernel, idx, w1, w2, n_bins):
    """One PyTorch call per histogram computing it: index_add_ of ones into
    n_bins + 1 counters, dropped and zero-weight records sent to the last
    one (the index is made here, outside the timed call)."""
    ones = torch.ones(idx.numel(), dtype=torch.int32, device=idx.device)
    targets = [torch.where(w & (idx >= 0) & (idx < n_bins), idx,
                           n_bins).long()
               for w in ((w1,) if kernel == "hist1" else (w1, w2))]

    def run():
        return [torch.zeros(n_bins + 1, dtype=torch.int32,
                            device=idx.device).index_add_(0, t, ones)[:n_bins]
                for t in targets]
    return run


def kernel_case(torch, hist, batch_time, name, kernel, idx, w1, w2, n_bins):
    """The kernel, its plain version and the library call on one input:
    bit-equal, each timed (batch_time); returns the case's row."""
    hists = 1 if kernel == "hist1" else 2
    if kernel == "hist2":
        run_k = lambda: hist.hist2(idx, w1, w2, n_bins)  # noqa: E731
        run_p = lambda: hist.hist2_plain(idx, w1, w2, n_bins)  # noqa: E731
    else:
        run_k = lambda: (hist.hist1(idx, w1, n_bins),)  # noqa: E731
        run_p = lambda: (hist.hist1_plain(idx, w1, n_bins),)  # noqa: E731
    run_l = library_call(torch, kernel, idx, w1, w2, n_bins)
    before = hist.hist1_launches + hist.hist2_launches
    got = run_k()
    launches = hist.hist1_launches + hist.hist2_launches - before
    require(launches == int(idx.numel() > 0 and n_bins > 0),
            f"{name}: {kernel} took {launches} launches")
    want, lib = run_p(), run_l()
    torch.cuda.synchronize()
    err = max(int((g.long() - p.long()).abs().max()) for g, p in
              zip(got, want))
    for g, p, q in zip(got, want, lib):
        require(torch.equal(g, p), f"{name}: {kernel} != plain version")
        require(torch.equal(q, p), f"{name}: library call != plain version")
    n = idx.numel()
    plan = hist.plan_for(idx, n_bins, hists)
    nbytes = n * (4 + hists) + hists * n_bins * 4
    row = dict(case=name, kernel=kernel, n=n, n_bins=n_bins,
               kept=int((w1 & (idx >= 0) & (idx < n_bins)).sum()),
               variant=hist.VARIANT_NAMES[plan.variant], blocks=plan.blocks,
               launches=launches, max_abs_err=err, ms=batch_time(run_k) * 1e3,
               plain_ms=batch_time(run_p) * 1e3,
               library_ms=batch_time(run_l) * 1e3, bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    row["share"] = row["bound_ms"] / row["ms"]
    log(f"  {name:28s} {kernel} n={n:>8d} bins={n_bins:>9d} "
        f"{row['variant']:6s} x{plan.blocks:<4d} equal  kernel "
        f"{row['ms']:.4f}  library {row['library_ms']:.4f}  plain "
        f"{row['plain_ms']:.4f}  bound {row['bound_ms']:.4f} ms "
        f"({nbytes} B, {row['share']:.1%})")
    return row


def kernel_phase(torch, np, pipeline, hist, batch_time, device):
    """Each kernel against its plain version and the library call, on the
    main path's real inputs and on uniform indices at the profile's
    domains, at full size and cut to an overlap-path piece, then pass A at
    the full-RefSeq database's size; one row per case."""
    from slimm_tpu_torch.parallel.runner import model_slices

    a50, b50, p50 = geometry(50, 0)
    a1k, b1k, p1k = geometry(1000, 2)
    real = capture_main_path(torch, np, pipeline, device)
    rng = np.random.default_rng(1)

    def uniform(n_bins, density, n=RECORDS):
        idx = rng.integers(0, n_bins, n).astype(np.int32)
        idx[:70_000] = n_bins // 3              # one bin with 70,000 hits
        oor = rng.choice(n, 2_000, replace=False)
        idx[oor] = np.where(np.arange(2_000) % 2 == 0, -1 - oor % 100,
                            n_bins + oor % 100)  # dropped, weight or not
        w1 = rng.random(n) < density
        w2 = rng.random(n) < 0.85 * density
        return [torch.from_numpy(a).to(device) for a in (idx, w1, w2)]

    def model_shard(kernel, idx, w1, w2, n_bins, shards):
        # model shard 1's slice of the domain, as pass A and the -ro/-co
        # uniq_cov2 of a model-sharded profile see it: records outside it
        # weighted 0
        lo, hi = model_slices(n_bins, shards)[1]
        idx = idx - lo
        inside = (idx >= 0) & (idx < hi - lo)
        return kernel, idx, w1 & inside, w2 & inside, hi - lo

    pa = real["passA_real"]
    cases = dict(real)
    cases.update({
        "passA_d0": ("hist2", *uniform(a50, 0.0), a50),
        "passA_d0.9": ("hist2", *uniform(a50, 0.9), a50),
        "passA_d1": ("hist2", *uniform(a50, 1.0), a50),
        "passA_1000ctg": ("hist2", *uniform(a1k, 0.9), a1k),
        "passA_12.6M": ("hist2", *uniform(12_600_000, 0.9), 12_600_000),
        "hist2_shared_16384": ("hist2", *uniform(16_384, 0.9), 16_384),
        "passA_model2_50ctg_real": model_shard(*pa, 2),
        "passA_model4_1000ctg": model_shard("hist2", *uniform(a1k, 0.9),
                                            a1k, 4),
        "passB_taxa_50ctg": ("hist1", *uniform(b50, 0.9), b50),
        "passB_taxa_1000ctg": ("hist1", *uniform(b1k, 0.9), b1k),
        "passB_pairs_50ctg": ("hist1", *uniform(p50, 0.9), p50),
        "passB_pairs_1000ctg": ("hist1", *uniform(p1k, 0.9), p1k),
        "passB_cov2_50ctg": ("hist1", *uniform(a50 + b50 - 50, 0.9),
                             a50 + b50 - 50),
    })
    rows = []
    for name, (kernel, idx, w1, w2, n_bins) in cases.items():
        for size in ("full", "piece"):
            cut = slice(None) if size == "full" else slice(0, PIECE)
            rows.append(kernel_case(
                torch, hist, batch_time, name + ("" if size == "full" else
                                                 "_piece"), kernel,
                idx[cut].contiguous(), w1[cut].contiguous(),
                None if w2 is None else w2[cut].contiguous(), n_bins))
    del cases, real, pa

    # pass A over the full-RefSeq domain: the grid-stride index of the
    # split passes int32 here; a hot bin past 2^30, the domain's last 1,000
    # bins hit, records on the int32 maximum dropped
    idx, w1, w2 = uniform(WIDE_BINS, 0.9, WIDE_RECORDS)
    idx[80_000:150_000] = WIDE_BINS - 2
    idx[150_000:160_000] = WIDE_BINS - 1 - torch.arange(
        10_000, dtype=torch.int32, device=idx.device) % 1_000
    idx[160_000:160_100] = 2**31 - 1
    require(int(idx.max()) == 2**31 - 1 and WIDE_BINS > 2**30,
            "the wide case's index")
    rows.append(kernel_case(torch, hist, batch_time, "passA_refseq50k",
                            "hist2", idx, w1, w2, WIDE_BINS))
    del idx, w1, w2
    torch.cuda.empty_cache()
    int32_edge_case(torch, hist, device)
    return rows


def int32_edge_case(torch, hist, device):
    """hist2 over the largest domain the wrapper takes, 2^31 - 1 bins, with
    hits on its last bins: the split's block count passes int32 there.
    Checked against the records' own (bin, count) pairs, since the plain
    version's int64 counts of the whole domain would not fit beside the
    kernel's outputs: equal counts at every hit bin and equal totals, so
    zeros elsewhere (counts are never negative)."""
    n, n_bins = 1 << 20, 2**31 - 1
    gen = torch.Generator().manual_seed(3)
    idx = torch.randint(0, n_bins, (n,), generator=gen, dtype=torch.int32)
    idx[:1_000] = n_bins - 1 - torch.arange(1_000, dtype=torch.int32) % 10
    idx[1_000:1_100] = -1
    w1 = torch.rand(n, generator=gen) < 0.9
    w2 = torch.rand(n, generator=gen) < 0.8
    idx, w1, w2 = (t.to(device) for t in (idx, w1, w2))
    before = hist.hist2_launches
    got = hist.hist2(idx, w1, w2, n_bins)
    require(hist.hist2_launches - before == 1, "int32_max: hist2 launches")
    for out, w in zip(got, (w1, w2)):
        bins, counts = torch.unique(idx[w & (idx >= 0)].long(),
                                    return_counts=True)
        require(torch.equal(out[bins].long(), counts)
                and int(out.sum(dtype=torch.int64)) == int(counts.sum()),
                "int32_max: hist2 != the records' counts")
    log(f"  {'hist2_int32_max':28s} hist2 n={n:>8d} bins={n_bins} equal, "
        f"last bin {int(got[0][-1])} / {int(got[1][-1])}")
    del got
    torch.cuda.empty_cache()


def core_phase(torch, np, pipeline, cuda_time, hist, device):
    """fused_profile on `device` and on the CPU; packed vectors equal."""
    from slimm_tpu_torch.utils import workload

    for n, n_contigs, seed in CORE_WORKLOADS:
        t0 = time.perf_counter()
        w = workload.make_workload(n, n_contigs, seed=seed)
        packed = {}
        for dev in (device, "cpu"):
            args, tables, plan, records = core_inputs(torch, np, pipeline, w,
                                                      n_contigs, dev)
            read_id = records[0]

            def core():
                return pipeline.fused_profile(
                    *args, tables, emit_coverage=False, **plan)["packed"]

            if dev == device:
                hist.reset_launch_counts()
                packed[dev] = core().cpu().numpy()
                launches = add_launches(hist)
                require(launches[0] > 0 and launches[1] > 0,
                        f"core on {dev} launched (hist1, hist2) = {launches}")
                secs = cuda_time(core, reps=5)
                log(f"  core {len(read_id)} records x {n_contigs} contigs "
                    f"{dev}: median {secs:.6f} s, "
                    f"{len(read_id) / secs:.0f} records/s, "
                    f"launches hist1={launches[0]} hist2={launches[1]}")
                sharded_core(torch, np, pipeline, cuda_time, hist, tables,
                             records, plan, packed[dev], n_contigs, secs)
            else:
                c0 = time.perf_counter()
                packed[dev] = core().numpy()
                log(f"  core {len(read_id)} records x {n_contigs} contigs "
                    f"cpu: one run {time.perf_counter() - c0:.3f} s")
        require(np.array_equal(packed[device], packed["cpu"]),
                f"packed stats differ between {device} and cpu at {n} x "
                f"{n_contigs}")
        stats = pipeline.unpack_stats(packed[device], n_contigs, w["n_dense"])
        require(stats["reads_count"].sum() > 0.9 * len(read_id)
                and stats["uniq_matches"] > 0
                and stats["taxon_counts"].sum() > 0,
                f"implausible stats at {n} x {n_contigs}")
        log(f"  packed vectors equal ({device} == cpu), {len(packed['cpu'])} "
            f"int32, uniq_matches {stats['uniq_matches']}")
        base_secs = core_baseline(np, w, stats, n, n_contigs)
        n_rec = len(read_id)
        phase(f"core {n} x {n_contigs} (card {secs:.6f} s, "
              f"{n_rec / secs:.0f} records/s; single-core C++ "
              f"{base_secs:.6f} s, {n_rec / base_secs:.0f} records/s; card "
              f"against C++ {base_secs / secs:.1f}x)", t0)


def core_baseline(np, w, stats, n, n_contigs):
    """native.baseline_profile on the core's arrays, median of
    BASELINE_REPS (bench.py bench_baseline); its counters held to the
    port's unpacked stats wherever both have the counter.  Returns its
    median seconds."""
    from slimm_tpu_torch.io import native

    times = []
    for _ in range(BASELINE_REPS):
        secs, counters = native.baseline_profile(
            w["read_id"], w["rid"], w["pos"], w["n_reads"], w["lengths"],
            w["lineage"], w["avg_read_len"], w["avg_read_len"])
        times.append(secs)
    port = dict(uniq_matches=stats["uniq_matches"],
                uniq_matches2=stats["uniq_matches2"],
                n_valid_refs=int(stats["valid"].sum()),
                lca_total=int(stats["taxon_counts"].sum()),
                cov_mass=int(stats["reads_count"].sum()),
                uniq_cov2_mass=int(stats["uniq_reads_count2"].sum()))
    bad = {k: (counters[k], v) for k, v in port.items() if counters[k] != v}
    require(not bad, f"core {n} x {n_contigs}: the C++ baseline's counters "
            f"differ from the port's stats (C++, port): {bad}")
    secs = float(np.median(times))
    log(f"  single-core C++ baseline (native.baseline_profile) on the same "
        f"arrays: median of {BASELINE_REPS} {secs:.6f} s "
        f"({' / '.join(f'{x:.4f}' for x in times)}), "
        f"{len(w['read_id']) / secs:.0f} records/s; counters equal to the "
        f"port's stats {sorted(port)}; hits {counters['hits']}")
    return secs


def sharded_core(torch, np, pipeline, cuda_time, hist, tables, records, plan,
                 want, n_contigs, one_secs):
    """The core over (data, model) grids of tables' device, records routed
    and uploaded once per grid: packed vectors equal to `want`, the
    unsharded run's; pass A of every shard under sync debug mode "error"."""
    from slimm_tpu_torch.parallel import ShardedRunner

    device = tables.device
    n = len(records[0])
    for data, model in SHARDED_CORE[n_contigs]:
        grid = ShardedRunner(devices=grid_of(device, data, model)).grid(
            lambda dev: tables)
        c0 = time.perf_counter()
        shards = grid.shards(*records)
        torch.cuda.synchronize()
        route_secs = time.perf_counter() - c0
        hist.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = pipeline._pass_a_shards(grid, shards, **plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = pipeline._core_after_a(grid, *a[:3], a[3].__getitem__,
                                     emit_coverage=False)["packed"]
        got = got.cpu().numpy()
        launches = add_launches(hist)
        require(launches[0] > 0 and launches[1] > 0,
                f"sharded core ({data}, {model}) launched (hist1, hist2) = "
                f"{launches}")
        require(np.array_equal(got, want),
                f"sharded core ({data}, {model}) at {n} x {n_contigs}: "
                "packed vector differs from the unsharded run's")

        def core():
            return pipeline.fused_profile_shards(
                grid, shards, emit_coverage=False, **plan)["packed"]

        secs = cuda_time(core, reps=5)
        log(f"  sharded core {n} x {n_contigs} (data, model) = ({data}, "
            f"{model}) on {device}: median {secs * 1e3:.3f} ms (unsharded "
            f"{one_secs * 1e3:.3f} ms), upload + route {route_secs:.3f} s, "
            f"packed equal, pass A without a host sync, launches "
            f"hist1={launches[0]} hist2={launches[1]}")
    if n_contigs != 50:
        return
    # -ro/-co: the concatenated slices equal the one-device histograms
    grid = ShardedRunner(devices=grid_of(device, 2, 2)).grid(
        lambda dev: tables)
    shards = grid.shards(*records)
    hist.reset_launch_counts()
    got = pipeline.fused_profile_shards(grid, shards, emit_coverage=True,
                                        **plan)
    add_launches(hist)
    one = pipeline.fused_profile(
        *(torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
          for x in records), tables, emit_coverage=True, **plan)
    for key in ("packed", "cov", "uniq_cov", "uniq_cov2"):
        require(torch.equal(got[key], one[key]),
                f"sharded core (2, 2) with -ro/-co: {key} differs")
    log(f"  sharded core {n} x {n_contigs} (2, 2) with -ro/-co: packed, cov, "
        "uniq_cov, uniq_cov2 equal to the unsharded run's")


def stream_phase(torch, np, pipeline, hist, tmp, device, smi):
    """The streamed paths on `device` against each other and against the
    whole-file path on the CPU, on one 4M-record SAM.  On a GPU, pass A of
    the pieces runs under torch's sync debug mode "error": any call in it
    that makes the host wait for the card raises."""
    import slimm_tpu_torch.parallel.runner as runner_mod
    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.engine.reports import write_abundance
    from slimm_tpu_torch.io import native
    from slimm_tpu_torch.parallel import ShardedRunner
    from slimm_tpu_torch.utils import workload

    t0 = time.perf_counter()
    d = os.path.join(tmp, "stream")
    os.makedirs(d)
    w = workload.make_workload(STREAM_RECORDS, 50, seed=1)
    sam = os.path.join(d, "stream.sam")
    mb = workload.write_bench_sam(sam, w, 50)
    db = workload.make_bench_db(w, 50)
    require(int(w["lengths"].max()) // 40 >= 32768
            and int(w["lengths"].max()) // 20 > pipeline.V2_MAX_BIN,
            "the contigs do not reach the bins the -w 40 and -w 20 runs need")
    log(f"  wrote {len(w['read_id'])}-record SAM ({mb:.1f} MB): "
        f"{time.perf_counter() - t0:.3f} s")

    tsv = {}
    secs = {}

    def run(label, fn, want, *, dev=device, bin_width=0, reps=1, **knobs):
        """fn on the SAM `reps` times with the counts reset before each
        run and read after it; `want` holds (counter, least value) pairs."""
        times = []
        for _ in range(reps):
            engine = EngineOptions(fetch_coverage=False, phase_log=False,
                                   **knobs)
            options = ProfileOptions(bin_width=bin_width)
            hist.reset_launch_counts()
            pipeline.reset_path_counts()
            c0 = time.perf_counter()
            st = fn(options, copy.deepcopy(db), sam, device=dev,
                    engine=engine)
            sync()
            times.append(time.perf_counter() - c0)
            counts = {k: v for k, v in pipeline.path_counts.items() if v}
            launches = add_launches(hist)
            for key, least in want:
                require(pipeline.path_counts[key] >= least,
                        f"{label}: {key} = {pipeline.path_counts[key]}, "
                        f"want >= {least}; counts {counts}")
            if dev != "cpu":
                require(launches[0] > 0 and launches[1] > 0,
                        f"{label} launched (hist1, hist2) = {launches}")
        out = os.path.join(d, label) + "/"
        write_abundance(st, out, sam)
        tsv[label] = (bin_width, open(out + "stream_profile.tsv",
                                      "rb").read())
        secs[label] = float(np.median(times))
        log(f"  {label:28s} {dev} -w {bin_width or 'auto'}: "
            f"{' / '.join(f'{x:.3f}' for x in times)} s, counts {counts}, "
            f"launches hist1={launches[0]} hist2={launches[1]}")

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    pass_a_pieces = pipeline._pass_a_pieces
    pass_a_shards = pipeline._pass_a_shards

    def without_sync(fn):
        def run_fn(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run_fn

    # the routing of the sharded runs' pieces on the card (parallel/
    # runner.py), timed with its sync; its one sync per piece (the shard
    # sizes) is by design, so it alone runs outside sync debug mode "error"
    route_piece = runner_mod.route_piece
    route_secs = []

    def timed_route(*args, **kw):
        mode = torch.cuda.get_sync_debug_mode() if device != "cpu" else 0
        if mode:
            torch.cuda.set_sync_debug_mode("default")
        c0 = time.perf_counter()
        try:
            return route_piece(*args, **kw)
        finally:
            route_secs[-1] += time.perf_counter() - c0
            if mode:
                torch.cuda.set_sync_debug_mode(mode)

    def sharded(fn, **kw):
        data, model = SHARDED_FILES

        def run_fn(options, db, path, device, engine):
            route_secs.append(0.0)
            return fn(options, db, path, engine=engine, **kw,
                      sharded_runner=ShardedRunner(
                          devices=grid_of(device, data, model)))
        return run_fn

    stream = pipeline.profile_file_streaming
    whole = pipeline.profile_file
    if device != "cpu":
        pipeline._pass_a_pieces = without_sync(pass_a_pieces)
        pipeline._pass_a_shards = without_sync(pass_a_shards)
    runner_mod.route_piece = timed_route
    try:
        run("overlap", whole, [("overlap_files", 1), ("overlap_pieces", 2)],
            reps=3)
        run("whole_file", whole, [], reps=3, overlap_min_bytes=0)
        run("stream_v2", stream,
            [("stream_files", 1), ("stream_chunks_v2", 2)], reps=3,
            stream_chunk=STREAM_CHUNK)
        run("stream_v2_no_cache", stream,
            [("stream_chunks_v2", 2), ("pass_b_reuploads", 2)],
            stream_chunk=STREAM_CHUNK, stream_device_cache_bytes=0)
        run("whole_file_cpu", whole, [], dev="cpu", overlap_min_bytes=0)
        run("stream_v2_w40", stream,
            [("stream_files", 1), ("stream_chunks_v2", 2)], bin_width=40,
            stream_chunk=STREAM_CHUNK)
        run("whole_file_w40", whole, [], bin_width=40, overlap_min_bytes=0)
        run("stream_v1_w20", stream,
            [("stream_files", 1), ("stream_chunks_v1", 2)], bin_width=20,
            stream_chunk=STREAM_CHUNK)
        run("overlap_w20", whole, [("overlap_fallback_bins_past_uint16", 1)],
            bin_width=20)
        shard_runs = [
            ("sharded_whole_2x2", sharded(whole), [("sharded_files", 1)], 3,
             {}),
            ("sharded_stream_2x2", sharded(stream),
             [("sharded_files", 1), ("stream_files", 1),
              ("stream_chunks_v2", 2)], 3, dict(stream_chunk=STREAM_CHUNK)),
            ("sharded_stream_2x2_no_cache", sharded(stream),
             [("stream_chunks_v2", 2), ("pass_b_reuploads", 4)], 1,
             dict(stream_chunk=STREAM_CHUNK, stream_device_cache_bytes=0))]
        for label, fn, want, reps, knobs in shard_runs:
            del route_secs[:]
            run(label, fn, want, reps=reps, **knobs)
            log(f"    routing of the pieces on the card, sync included: "
                f"{' / '.join(f'{x:.3f}' for x in route_secs)} s")
            secs[label + "_route"] = float(np.median(route_secs))
    finally:
        pipeline._pass_a_pieces = pass_a_pieces
        pipeline._pass_a_shards = pass_a_shards
        runner_mod.route_piece = route_piece
    if device != "cpu":
        log("  pass A of every piece and shard ran under sync debug mode "
            "\"error\": no host sync but the routing's shard sizes")
    secs.update(route_bench(torch, np, pipeline, runner_mod, device))

    for width in {bw for bw, _ in tsv.values()}:
        runs = {k: v for k, (bw, v) in tsv.items() if bw == width}
        first = next(iter(runs.values()))
        require(first.count(b"\n") > 2, f"-w {width}: empty profile")
        for label, got in runs.items():
            require(got == first, f"-w {width or 'auto'}: {label}'s TSV "
                    f"differs from {next(iter(runs))}'s")
        log(f"  -w {width or 'auto'}: TSVs equal ({', '.join(runs)}; "
            f"{len(first)} bytes)")

    floor = []
    for _ in range(3):
        c0 = time.perf_counter()
        sr = native.NativeStreamReader(sam)
        n_pad = 4 << 20
        while sr.next_piece_v2(n_pad, n_pad, w["lengths"], 75, 150,
                               np.uint8) is not None:
            pass
        sr.close()
        floor.append(time.perf_counter() - c0)
    secs["decode_floor"] = float(np.median(floor))
    log(smi)
    log(f"  {STREAM_RECORDS}-record SAM, file seconds (median of 3, "
        f"{device}): overlap {secs['overlap']:.3f}, whole-file "
        f"{secs['whole_file']:.3f}, stream {secs['stream_v2']:.3f}, "
        f"decode-only floor {secs['decode_floor']:.3f}; sharded {SHARDED_FILES} "
        f"on one card: whole-file {secs['sharded_whole_2x2']:.3f} (routing "
        f"{secs['sharded_whole_2x2_route']:.3f}), stream "
        f"{secs['sharded_stream_2x2']:.3f} (routing "
        f"{secs['sharded_stream_2x2_route']:.3f})")
    os.remove(sam)
    phase("stream", t0)
    return w, db, tsv["overlap"][1]


def baseline_mismatch(counters, st, hits):
    """The counters of native.baseline_profile that differ from the port's
    ProfileState `st` (with its bin histograms), as {name: (C++, port)};
    `hits` is the number of records the baseline was given."""
    port = dict(hits=hits, matches=st.matches_count,
                uniq_matches=st.uniq_matches_count,
                uniq_matches2=st.uniq_matches_count2,
                n_valid_refs=len(st.valid_ref_ids),
                cov_mass=int(st.cov.sum()),
                uniq_cov2_mass=int(st.uniq_cov2.sum()))
    return {k: (counters[k], v) for k, v in port.items() if counters[k] != v}


def bam_phase(torch, np, pipeline, hist, batch_time, tmp, device, smi,
              stream_files):
    """The stream phase's 4M-record workload written as a BAM, decoded and
    profiled on `device`: profile_file's path (whichever its size gives),
    its TSV equal to the SAM's, the CLI on it launching both kernels; the
    file's seconds beside a decode-only floor and the single-thread C++
    end to end (single-thread decode + native.baseline_profile, whose
    counters must equal the port's); each kernel held against its plain
    version on the histogram inputs of profile_file's run and the CLI's.
    Returns the kernel rows."""
    from slimm_tpu_torch import cli
    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.engine.reports import write_abundance
    from slimm_tpu_torch.io import native
    from slimm_tpu_torch.utils import workload

    t0 = time.perf_counter()
    w, db, sam_tsv = stream_files
    d = os.path.join(tmp, "bam")
    os.makedirs(d)
    bam = os.path.join(d, "stream.bam")
    mb = workload.write_bench_bam(bam, w, 50)
    log(f"  wrote {len(w['read_id'])}-record BAM ({mb:.1f} MB; the overlap "
        f"path from {EngineOptions().overlap_min_bytes / 2**20:.0f} MB): "
        f"{time.perf_counter() - t0:.3f} s")

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def profile(fetch_coverage=False):
        st = pipeline.profile_file(
            ProfileOptions(), copy.deepcopy(db), bam, device=device,
            engine=EngineOptions(fetch_coverage=fetch_coverage,
                                 phase_log=False))
        sync()
        return st

    # the path, the TSV and the counters: one run with the histograms, its
    # histogram inputs kept
    hist.reset_launch_counts()
    pipeline.reset_path_counts()
    with recorded_hists(pipeline) as calls:
        st = profile(fetch_coverage=True)
    launches = add_launches(hist)
    counts = {k: v for k, v in pipeline.path_counts.items() if v}
    taken = "overlap" if pipeline.path_counts["overlap_files"] else \
        "whole-file"
    write_abundance(st, os.path.join(d, "lib") + "/", bam)
    got = open(os.path.join(d, "lib", "stream_profile.tsv"), "rb").read()
    require(got == sam_tsv, "BAM: profile_file's TSV differs from the SAM's")
    require(device == "cpu" or (launches[0] > 0 and launches[1] > 0),
            f"profile_file on the BAM launched (hist1, hist2) = {launches}")
    log(f"  profile_file on the BAM: the {taken} path (counts {counts}), "
        f"launches hist1={launches[0]} hist2={launches[1]}, TSV equal to "
        f"the SAM's ({len(got)} bytes)")

    # the CLI on the BAM
    db_path = os.path.join(d, "stream.sldb")
    db.save_sldb(db_path)
    hist.reset_launch_counts()
    pipeline.reset_path_counts()
    c0 = time.perf_counter()
    with recorded_hists(pipeline) as cli_calls:
        quiet_cli(cli, ["profile", "--device", device, "-o",
                        os.path.join(d, "cli") + "/", db_path, bam])
    cli_secs = time.perf_counter() - c0
    launches = add_launches(hist)
    require(device == "cpu" or (launches[0] > 0 and launches[1] > 0),
            f"the CLI on the BAM launched (hist1, hist2) = {launches}")
    require(open(os.path.join(d, "cli", "stream_profile.tsv"), "rb").read()
            == sam_tsv, "BAM: the CLI's TSV differs from the SAM's")
    log(f"  profile CLI on the BAM: TSV equal to the SAM's, {cli_secs:.3f} "
        f"s, launches hist1={launches[0]} hist2={launches[1]}")

    # a warm run of each, then BAM_REPS turns of the three
    def decode_floor():
        native.NativeAlignmentFile(bam).load()

    cpp = {}

    def cpp_e2e():
        b = native.NativeAlignmentFile(bam, single_thread=True).load()
        cpp["secs"], cpp["counters"] = native.baseline_profile(
            b.read_id.astype(np.int32), b.rid, b.pos, b.n_reads,
            w["lengths"], w["lineage"], b.avg_read_length, b.avg_read_length)
        cpp["targets"] = len(b.read_id)

    ways = {"file": profile, "decode_floor": decode_floor, "cpp_e2e": cpp_e2e}
    times = {way: [] for way in ways}
    for rep in range(BAM_REPS + 1):
        for way, fn in ways.items():
            c0 = time.perf_counter()
            fn()
            if rep:
                times[way].append(time.perf_counter() - c0)
    med = {way: float(np.median(t)) for way, t in times.items()}
    # the decoded (deduped) targets, as bench.py feeds them, and the raw
    # records as written, whose count is the state's hits
    bad = baseline_mismatch(cpp["counters"], st, cpp["targets"])
    _, raw = native.baseline_profile(
        w["read_id"], w["rid"], w["pos"], w["n_reads"], w["lengths"],
        w["lineage"], w["avg_read_len"], w["avg_read_len"])
    bad.update({f"{k} (raw records)": v for k, v in
                baseline_mismatch(raw, st, st.hits_count).items()})
    require(not bad, f"BAM: the C++ baseline's counters differ from the "
            f"port's (C++, port): {bad}")
    log(smi)
    n = st.hits_count
    log(f"  {n}-record BAM ({mb:.1f} MB), median of {BAM_REPS} in turns "
        f"after a warm run, {device}: file {med['file']:.3f} s "
        f"({' / '.join(f'{x:.3f}' for x in times['file'])}; "
        f"{n / med['file']:.0f} records/s), decode-only floor "
        f"{med['decode_floor']:.3f} s ("
        f"{' / '.join(f'{x:.3f}' for x in times['decode_floor'])}), "
        f"single-thread C++ end to end {med['cpp_e2e']:.3f} s ("
        f"{' / '.join(f'{x:.3f}' for x in times['cpp_e2e'])}; last: "
        f"baseline_profile {cpp['secs']:.3f} s of it; "
        f"{n / med['cpp_e2e']:.0f} records/s); file against C++ "
        f"{med['cpp_e2e'] / med['file']:.2f}x; counters equal "
        f"{cpp['counters']}")

    # the kernels on the inputs the BAM's path gave them: profile_file's
    # run (with the coverage histograms, so pass B's index is
    # [uniq_cov2 | taxa]) and the CLI's pass B over [contigs | taxa]
    for run_calls in (calls, cli_calls):
        kinds = [c[0] for c in run_calls]
        require(kinds == ["hist2", "hist1", "hist1"],
                f"the BAM's path called the histograms as {kinds}")
    cases = {"passA_real": calls[0], "passB_real": cli_calls[1],
             "pairs_real": calls[2], "cov2_real": calls[1]}
    rows = [kernel_case(torch, hist, batch_time, f"bam_{case}", *call)
            for case, call in cases.items()]
    phase("bam", t0)
    return rows


def host_route(np, arrays, n, D):
    """The plain routing of a v2 piece on the host, in numpy: the hash of
    slimm_tpu/parallel/mesh.py's route_shard over the piece-local read
    index, a stable argsort, each shard's boundary bits packed again."""
    bnd, rid, lbin = arrays
    bits = np.unpackbits(bnd, count=n, bitorder="little")
    read = np.cumsum(bits, dtype=np.int64) - 1
    h = (read.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) \
        >> np.uint64(17)
    shard = (h % np.uint64(D)).astype(np.uint8)
    order = np.argsort(shard, kind="stable")
    ends = np.cumsum(np.bincount(shard, minlength=D))[:-1]
    return [(np.packbits(bits[sel], bitorder="little"), rid[sel], lbin[sel])
            for sel in np.split(order, ends)]


def route_bench(torch, np, pipeline, runner_mod, device):
    """Routing one 2^19-record v2 piece over D data shards: on the host
    (host_route, then a pinned upload of each part) against the port's
    (a pinned upload of the piece, route_piece on the card); the parts
    must be equal.  Each way timed to the end of its work on the card
    (sync included), in turns host, card, card, host of ROUTE_REPS runs;
    returns the median of each turn."""
    dev = torch.device(device)
    rng = np.random.default_rng(7)
    runs = np.where(rng.random(ROUTE_PIECE) < 0.9, 1,
                    rng.integers(2, 4, ROUTE_PIECE))
    runs = runs[:np.searchsorted(np.cumsum(runs), ROUTE_PIECE)]
    n = int(runs.sum())
    bits = np.zeros(n, np.uint8)
    bits[np.cumsum(runs) - runs] = 1
    piece = (np.packbits(bits, bitorder="little"),
             rng.integers(0, 50, n).astype(np.uint8),
             rng.integers(-2**15, 2**15, n).astype(np.int16))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def on_host(D):
        out = [pipeline._upload(p, dev) for p in host_route(np, piece, n, D)]
        sync()
        return out

    def on_card(D):
        out = [p for p, _ in runner_mod.route_piece(
            "v2", pipeline._upload(piece, dev), n, D)]
        sync()
        return out

    result = {}
    for D in (2, 4):
        for h, c in zip(on_host(D), on_card(D)):
            for a, b in zip(h, c):
                require(torch.equal(a.cpu(), b.cpu()),
                        f"routing a piece over {D} shards: the card's parts "
                        "differ from the host's")
        turns = []
        for fn in (on_host, on_card, on_card, on_host):
            times = []
            for _ in range(ROUTE_REPS):
                c0 = time.perf_counter()
                fn(D)
                times.append(time.perf_counter() - c0)
            turns.append(float(np.median(times)))
        result[f"route_host_D{D}"] = (turns[0], turns[3])
        result[f"route_card_D{D}"] = (turns[1], turns[2])
        log(f"  routing a {n}-record v2 piece over {D} data shards, parts "
            f"equal; median of {ROUTE_REPS} per turn (host, card, card, "
            f"host): host + uploads {turns[0] * 1e3:.3f} / "
            f"{turns[3] * 1e3:.3f} ms, upload + card "
            f"{turns[1] * 1e3:.3f} / {turns[2] * 1e3:.3f} ms")
    return result


def cli_phase(hist, tmp, device_args):
    """The profile CLI; `device_args` select its device ([] takes the
    default, cuda).  Returns the launch counts of the main-path run."""
    from slimm_tpu_torch import cli
    from slimm_tpu_torch.engine import pipeline
    from slimm_tpu_torch.utils import workload

    toy = _load_toy()
    py = [sys.executable, "-m", "slimm_tpu_torch"]
    # toy dataset: the default device against the oracle
    t0 = time.perf_counter()
    d = os.path.join(tmp, "toy")
    os.makedirs(d)
    nodes, names = toy.write_taxonomy_files(d)
    fasta, acc = toy.write_fasta_and_acc2taxid(d)
    sam = toy.write_sam(d, toy.make_records(n_extra=4000, seed=3))
    db = os.path.join(d, "toy.sldb")
    run(py + ["build", "-nm", names, "-nd", nodes, "-o", db, fasta, acc])
    run(py + ["profile", *device_args, "-o", d + "/gpu/", db, sam])
    run(py + ["profile", "--no-device", "-o", d + "/oracle/", db, sam])
    got = open(d + "/gpu/toy-reads_profile.tsv", "rb").read()
    want = open(d + "/oracle/toy-reads_profile.tsv", "rb").read()
    require(got == want, "toy profile (cuda) differs from the oracle's")
    log(f"  toy profile.tsv (cuda) == oracle ({len(got)} bytes)")
    phase("cli toy", t0)

    # the main path: the profile CLI on a 1M-record SAM
    t0 = time.perf_counter()
    d = os.path.join(tmp, "bench")
    os.makedirs(d)
    w = workload.make_workload(CLI_RECORDS, 50, seed=1)
    sam = os.path.join(d, "bench.sam")
    mb = workload.write_bench_sam(sam, w, 50)
    db = os.path.join(d, "bench.sldb")
    workload.make_bench_db(w, 50).save_sldb(db)
    log(f"  wrote {len(w['read_id'])}-record SAM ({mb:.1f} MB) and DB: "
        f"{time.perf_counter() - t0:.3f} s")
    hist.reset_launch_counts()
    pipeline.reset_path_counts()
    c0 = time.perf_counter()
    rc = cli.main(["profile", *device_args, "-o", d + "/gpu/", db, sam])
    cuda_secs = time.perf_counter() - c0
    launches = dict(zip(("slimm_hist1", "slimm_hist2"), add_launches(hist)))
    pieces = pipeline.path_counts["overlap_pieces"]
    require(rc == 0, f"profile exited {rc}")
    require(all(v > 0 for v in launches.values()),
            f"main path launched {launches}")
    require(pipeline.path_counts["overlap_files"] == 1 and pieces >= 2,
            f"the {mb:.1f} MB SAM did not take the overlap path: "
            f"{pipeline.path_counts}")
    c0 = time.perf_counter()
    run(py + ["profile", "--device", "cpu", "-o", d + "/cpu/", db, sam])
    cpu_secs = time.perf_counter() - c0
    got = open(d + "/gpu/bench_profile.tsv", "rb").read()
    want = open(d + "/cpu/bench_profile.tsv", "rb").read()
    require(got == want, "1M-record profile differs between cuda and cpu")
    require(got.count(b"\n") > 2, "1M-record profile is empty")
    log(f"  1M-record profile.tsv cuda == cpu ({len(got)} bytes); cli wall "
        f"cuda {cuda_secs:.3f} s (in process), cpu {cpu_secs:.3f} s "
        f"(subprocess); launches {launches}, overlap pieces {pieces}")
    phase("cli 1M records", t0)

    # --shards 2: one GPU is one device too few (make_mesh's rule)
    import torch

    t0 = time.perf_counter()
    err = io.StringIO()
    hist.reset_launch_counts()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["profile", *device_args, "--shards", "2", "-o",
                       d + "/shards2/", db, sam])
    add_launches(hist)
    if torch.cuda.device_count() < 2:
        want = (f"requested 2 devices (2 data x 1 model shards), have "
                f"{torch.cuda.device_count()} CUDA devices")
        require(rc == 1 and want in err.getvalue()
                and not os.path.exists(d + "/shards2/"),
                f"profile --shards 2 on one GPU: exit {rc}, stderr "
                f"{err.getvalue()[-500:]!r}")
        log(f"  profile --shards 2 on {torch.cuda.device_count()} GPU: exit 1, "
            f"{want!r}")
    else:
        require(rc == 0 and open(d + "/shards2/bench_profile.tsv", "rb").read()
                == got, "profile --shards 2: TSV differs from the unsharded")
        log(f"  profile --shards 2 on {torch.cuda.device_count()} GPUs: TSV "
            "equal to the unsharded run's")
    phase("cli --shards 2", t0)
    return launches, (w, db, sam)


def quiet_cli(cli, argv):
    """cli.main(argv) with its stderr (phase logs, one block per file)
    kept; on a non-zero exit the end of it is raised."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"profile {argv} exited {rc}:\n"
                           f"{err.getvalue()[-3000:]}")


# the parts of a -d run's host time, by the pipeline's mark (host_marks)
# that ends each, and the TSV writes that follow a group
SPLIT_PARTS = {"decoded": "decode",
               "tables": "group prep, tables built and uploaded",
               "cutoffs": "records up, pass A, sums, cutoff sync",
               "fetched": "pass B, packing, packed fetch",
               "finalized": "_finalize_state", "written": "TSV writes"}


def host_split(pipeline, db_path, paths, per_group, out_dir):
    """`paths` profiled as the CLI's -d does on one device (sorted by size,
    profile_files_batched per group of `per_group`, each abundance TSV
    written), with the host clock read at the pipeline's fixed points
    (pipeline.host_marks) and after each group's writes.  Returns the
    seconds of each part of SPLIT_PARTS, summed over the groups."""
    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.engine.reports import write_abundance

    db = SlimmDatabase.load(db_path)
    by_size = sorted(paths, key=os.path.getsize)
    pipeline.host_marks = marks = []
    try:
        for i in range(0, len(by_size), per_group):
            marks.append(("start", time.perf_counter()))
            for path, st in pipeline.profile_files_batched(
                    ProfileOptions(), db, by_size[i:i + per_group],
                    engine=EngineOptions(fetch_coverage=False,
                                         phase_log=False)):
                write_abundance(st, out_dir + "/", path)
            marks.append(("written", time.perf_counter()))
    finally:
        pipeline.host_marks = None
    parts = dict.fromkeys(SPLIT_PARTS.values(), 0.0)
    for (_, t_prev), (point, t) in zip(marks, marks[1:]):
        if point != "start":
            parts[SPLIT_PARTS[point]] += t - t_prev
    return parts


def dir_phase(torch, np, pipeline, hist, batch_time, tmp, bench_files, smi):
    """`profile -d` on 16 SAMs of one header, batched (groups of
    files_per_dispatch) and as a per-file loop (files_per_dispatch=1),
    against each other and a --device cpu run of two files; the kernels
    held against their plain versions on one group's histogram inputs.
    Returns the kernel rows."""
    import functools

    from slimm_tpu_torch import cli
    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.utils import workload

    t0 = time.perf_counter()
    w0, db_path, _ = bench_files
    d = os.path.join(tmp, "dir")
    indir = os.path.join(d, "in")
    os.makedirs(indir)
    mb = 0.0
    for seed in DIR_SEEDS:
        w = workload.make_workload(DIR_RECORDS, 50, seed=seed)
        # one header for every file, the bench database's contigs: the
        # positions are drawn again within them
        pos = (np.random.default_rng(seed).random(len(w["rid"]))
               * (w0["lengths"][w["rid"]] - w["avg_read_len"])
               ).astype(np.int32)
        mb += workload.write_bench_sam(
            os.path.join(indir, f"s{seed}.sam"),
            dict(w, lengths=w0["lengths"], pos=pos), 50)
    names = sorted(os.listdir(indir))
    log(f"  wrote {len(names)} SAMs of {DIR_RECORDS} records ({mb:.1f} MB): "
        f"{time.perf_counter() - t0:.3f} s")

    engine_cls = cli.EngineOptions
    per_group = engine_cls().files_per_dispatch
    ways = {"batched": (engine_cls, -(-len(names) // per_group)),
            "per_file": (functools.partial(engine_cls, files_per_dispatch=1),
                         len(names))}
    secs = {way: [] for way in ways}
    try:
        # a warm run of each way, then DIR_REPS turns of both
        for rep in range(DIR_REPS + 1):
            for way, (engine, groups) in ways.items():
                cli.EngineOptions = engine
                hist.reset_launch_counts()
                pipeline.reset_path_counts()
                c0 = time.perf_counter()
                quiet_cli(cli, ["profile", "-d", "-o",
                                os.path.join(d, way) + "/", db_path, indir])
                secs[way].append(time.perf_counter() - c0)
                launches = add_launches(hist)
                require(pipeline.path_counts["batched_groups"] == groups
                        and launches == (2 * groups, groups),
                        f"-d {way}: {pipeline.path_counts['batched_groups']} "
                        f"groups, launches (hist1, hist2) = {launches}; "
                        f"want {groups} groups, ({2 * groups}, {groups})")
    finally:
        cli.EngineOptions = engine_cls

    # two of the files on the CPU, batched there too
    two = os.path.join(d, "two")
    os.makedirs(two)
    for name in names[:2]:
        os.link(os.path.join(indir, name), os.path.join(two, name))
    quiet_cli(cli, ["profile", "--device", "cpu", "-d", "-o",
                    os.path.join(d, "cpu") + "/", db_path, two])
    for name in names:
        tsv = name[:-len(".sam")] + "_profile.tsv"
        got = open(os.path.join(d, "batched", tsv), "rb").read()
        require(got.count(b"\n") > 2, f"-d: {tsv} is empty")
        require(got == open(os.path.join(d, "per_file", tsv), "rb").read(),
                f"-d: {tsv} differs between batched and per-file")
        if name in names[:2]:
            require(got == open(os.path.join(d, "cpu", tsv), "rb").read(),
                    f"-d: {tsv} differs between cuda and cpu")
    med = {way: float(np.median(t[1:])) for way, t in secs.items()}
    # what no way of profiling saves: decoding every file whole
    floor = []
    for _ in range(DIR_REPS):
        c0 = time.perf_counter()
        for name in names:
            pipeline.open_alignment_file(os.path.join(indir, name)).load()
        floor.append(time.perf_counter() - c0)
    log(f"  -d TSVs equal: batched == per-file loop for {len(names)} files, "
        f"== --device cpu for {names[0]} and {names[1]}")
    log(smi)
    for way, (_, groups) in ways.items():
        log(f"  -d {way:8s} ({groups} groups, launches hist1={2 * groups} "
            f"hist2={groups}): {' / '.join(f'{x:.3f}' for x in secs[way])} "
            f"s (first warm); median {med[way]:.3f} s, "
            f"{med[way] / len(names) * 1e3:.2f} ms per file")
    log(f"  -d decode-only floor (open_alignment_file(path).load() of each "
        f"file): {' / '.join(f'{x:.3f}' for x in floor)} s")

    # where a small file's host time goes: one more run of each way with
    # the host clock read at the pipeline's fixed points
    paths = [os.path.join(indir, name) for name in names]
    split = {}
    for way, per in (("batched", per_group), ("per_file", 1)):
        out = os.path.join(d, way + "_split")
        c0 = time.perf_counter()
        split[way] = host_split(pipeline, db_path, paths, per, out)
        split[way]["all of the run"] = time.perf_counter() - c0
        for name in names:
            tsv = name[:-len(".sam")] + "_profile.tsv"
            require(open(os.path.join(out, tsv), "rb").read()
                    == open(os.path.join(d, "batched", tsv), "rb").read(),
                    f"-d split run {way}: {tsv} differs from the CLI's")
    log(f"  -d host time per file, ms (batched / per file), one run of "
        f"{len(names)} files each, TSVs equal to the CLI's:")
    for part in split["batched"]:
        log(f"    {part:44s} {split['batched'][part] / len(names) * 1e3:8.3f}"
            f" / {split['per_file'][part] / len(names) * 1e3:8.3f}")

    # the kernels on the histogram inputs of one group
    with recorded_hists(pipeline) as calls:
        pipeline.profile_files_batched(
            ProfileOptions(), SlimmDatabase.load(db_path), paths[:per_group],
            engine=EngineOptions(fetch_coverage=False, phase_log=False))
    kinds = [c[0] for c in calls]
    require(kinds == ["hist2", "hist1", "hist1"],
            f"a batched group called the histograms as {kinds}")
    rows = [kernel_case(torch, hist, batch_time, f"dir{per_group}_{case}",
                        *call)
            for case, call in zip(("passA_real", "passB_real", "pairs_real"),
                                  calls)]
    phase("dir", t0)
    return rows


def trace_phase(hist, tmp, bench_files, smi):
    """`profile --trace-dir` on the card: the TSV of the untraced CLI run,
    and a trace that names both kernels."""
    from slimm_tpu_torch import cli

    t0 = time.perf_counter()
    _, db, sam = bench_files
    d = os.path.join(tmp, "trace")
    hist.reset_launch_counts()
    c0 = time.perf_counter()
    quiet_cli(cli, ["profile", "--trace-dir", d, "-o", d + "/out/", db, sam])
    secs = time.perf_counter() - c0
    launches = add_launches(hist)
    got = open(d + "/out/bench_profile.tsv", "rb").read()
    want = open(os.path.join(tmp, "bench", "gpu", "bench_profile.tsv"),
                "rb").read()
    require(got == want, "--trace-dir: TSV differs from the untraced run's")
    path = os.path.join(d, os.path.basename(sam) + ".pt.trace.json")
    events = json.load(open(path))["traceEvents"]
    on_card = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # the port's kernels, by their names in csrc/hist.cu (an anonymous
    # namespace there)
    ours = {}
    for e in on_card:
        name = e["name"].replace("(anonymous namespace)::", "")
        if e["cat"] == "kernel" and name.startswith(
                ("hist1_", "hist2_", "split_packed")):
            name = name.split("(")[0]
            ours[name] = ours.get(name, 0) + 1
    for prefix in ("hist2_", "hist1_"):
        require(any(name.startswith(prefix) for name in ours),
                f"--trace-dir: no {prefix}* kernel in the trace: {ours}")
    device_ms = sum(e.get("dur", 0) for e in on_card) / 1e3
    # the traced window: the file's profile, decode included
    stamped = [e for e in events if "ts" in e and e.get("ph") == "X"]
    span_ms = (max(e["ts"] + e.get("dur", 0) for e in stamped)
               - min(e["ts"] for e in stamped)) / 1e3
    log(smi)
    log(f"  --trace-dir on the 1M-record SAM: TSV equal, "
        f"{os.path.getsize(path) / 2**20:.1f} MB trace, {len(on_card)} "
        f"device events ({device_ms:.3f} ms of kernels and copies in a "
        f"{span_ms:.3f} ms traced window: device busy "
        f"{device_ms / span_ms:.1%}), CLI {secs:.3f} s; launches "
        f"hist1={launches[0]} hist2={launches[1]}; the port's kernels in "
        f"the trace {ours}")
    phase("trace", t0)


def multi_child(backend, init_method, world, rank, db_path, sam, out_dir):
    """One process of a torch.distributed world: `sam` profiled through
    MultiHostRunner whole-file and streamed, each TSV written under
    out_dir; prints one `MULTI {json}` line with seconds, launches and the
    runner's collective payload bytes."""
    world, rank = int(world), int(rank)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.engine import pipeline
    from slimm_tpu_torch.engine.reports import write_abundance
    from slimm_tpu_torch.ops import hist
    from slimm_tpu_torch.parallel import MultiHostRunner, initialize

    initialize(backend, init_method, world, rank)
    try:
        # by default the process's own GPU (cuda:LOCAL_RANK, here the rank);
        # the two-process gloo world asks for cuda:0 (NCCL refuses two
        # ranks on one GPU)
        runner = (MultiHostRunner() if backend == "nccl"
                  else MultiHostRunner(devices=["cuda:0"]))
        require(runner.distributed and dist.get_backend() == backend
                and runner.devices == [[torch.device("cuda", 0)]],
                f"rank {rank}: {dist.get_backend()} on {runner.devices}")
        db = SlimmDatabase.load(db_path)
        report = {}
        for label, fn, kw in (
                ("whole", pipeline.profile_file, {}),
                ("stream", pipeline.profile_file_streaming,
                 dict(chunk_targets=STREAM_CHUNK))):
            hist.reset_launch_counts()
            pipeline.reset_path_counts()
            for issued in runner.collective_bytes.values():
                issued.clear()              # the runner's counts accumulate
            c0 = time.perf_counter()
            st = fn(ProfileOptions(), copy.deepcopy(db), sam,
                    engine=EngineOptions(fetch_coverage=False,
                                         phase_log=False),
                    sharded_runner=runner, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - c0
            write_abundance(st, os.path.join(out_dir, label) + "/", sam)
            report[label] = dict(
                secs=secs, hist1=hist.hist1_launches,
                hist2=hist.hist2_launches,
                paths={k: v for k, v in pipeline.path_counts.items() if v},
                collective_bytes=copy.deepcopy(runner.collective_bytes))
        print("MULTI " + json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multi_phase(np, pipeline, tmp, bench_files):
    """A one-process NCCL world on the whole SAM and a two-process gloo
    world on its halves (split by read, in order of first appearance, as
    tests/_mp_child.py splits), started together; every process's TSVs
    equal the one-process run's."""
    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.engine.reports import write_abundance
    from slimm_tpu_torch.utils import workload

    t0 = time.perf_counter()
    w, db_path, sam = bench_files
    d = os.path.join(tmp, "multi")
    os.makedirs(d)
    _, first, inv = np.unique(w["read_id"], return_index=True,
                              return_inverse=True)
    order = np.argsort(np.argsort(first))[inv]
    halves = []
    for r in range(2):
        sel = order % 2 == r
        halves.append(os.path.join(d, f"rank{r}.sam"))
        workload.write_bench_sam(halves[-1], dict(
            w, read_id=w["read_id"][sel], rid=w["rid"][sel],
            pos=w["pos"][sel]), 50)
    st = pipeline.profile_file(
        ProfileOptions(), SlimmDatabase.load(db_path), sam, device="cuda",
        engine=EngineOptions(fetch_coverage=False, phase_log=False))
    write_abundance(st, os.path.join(d, "one") + "/", sam)
    want = open(os.path.join(d, "one", "bench_profile.tsv"), "rb").read()

    nccl, gloo = (f"tcp://127.0.0.1:{_free_port()}" for _ in range(2))
    jobs = [("nccl", nccl, 1, 0, sam)] + [
        ("gloo", gloo, 2, r, halves[r]) for r in range(2)]
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "raise SystemExit(chip_smoke.multi_child(*sys.argv[2:]))")
    procs = []
    try:
        for backend, init, world, rank, path in jobs:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, ROOT, backend, init, str(world),
                 str(rank), db_path, path,
                 os.path.join(d, f"{backend}{world}_rank{rank}")],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    sent_by_label = {}
    for (backend, _, world, rank, _), p, out in zip(jobs, procs, outs):
        tag = f"{backend} world {world} rank {rank}"
        require(p.returncode == 0, f"{tag} exited {p.returncode}:\n"
                f"{out[-3000:]}")
        report = json.loads(next(line[6:] for line in out.splitlines()
                                 if line.startswith("MULTI ")))
        for label in ("whole", "stream"):
            r = report[label]
            require(r["hist1"] > 0 and r["hist2"] > 0,
                    f"{tag} {label} launched (hist1, hist2) = "
                    f"({r['hist1']}, {r['hist2']})")
            PATH_LAUNCHES["slimm_hist1"] += r["hist1"]
            PATH_LAUNCHES["slimm_hist2"] += r["hist2"]
            out_dir = os.path.join(d, f"{backend}{world}_rank{rank}", label)
            tsv = os.listdir(out_dir)
            require(len(tsv) == 1 and open(os.path.join(out_dir, tsv[0]),
                                           "rb").read() == want,
                    f"{tag} {label}: TSV differs from the one-process run's")
            sent = r["collective_bytes"]
            # the same tables in every world: the same payload
            sent_by_label.setdefault(label, sent)
            require(sent["all_reduce"] and sent == sent_by_label[label],
                    f"{tag} {label}: collective payload {sent}, another "
                    f"process's {sent_by_label[label]}")
            log(f"  {tag} {label}: TSV equal ({len(want)} bytes), "
                f"{r['secs']:.3f} s, launches hist1={r['hist1']} "
                f"hist2={r['hist2']}, counts {r['paths']}; collective "
                f"payload {sum(map(sum, sent.values()))} B: {sent}")
    phase("multi", t0)


def main() -> int:
    if not (os.path.isdir(os.path.join(ROOT, "slimm_tpu_torch"))
            and os.path.exists(os.path.join(ROOT, "native",
                                            "slimm_native.cpp"))):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(slimm_tpu_torch/ and native/ not found beside it)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from slimm_tpu_torch.engine import pipeline
    from slimm_tpu_torch.io import native
    from slimm_tpu_torch.ops import _build, hist
    from slimm_tpu_torch.utils.devbench import batch_time, cuda_time

    def timed(build):
        c0 = time.perf_counter()
        return build(), time.perf_counter() - c0

    # nvcc and g++ side by side
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(timed, b) for b in (_build.build, native.build)]
        (kernels_so, kernels_s), (native_so, native_s) = [
            f.result() for f in builds]
    _build.load()
    log(f"  kernels built in {kernels_s:.3f} s: "
        f"{os.path.relpath(kernels_so, ROOT)}")
    log(f"  native SAM/BAM decoder built in {native_s:.3f} s: "
        f"{os.path.relpath(native_so, ROOT)}")
    log(f"  SMs, shared memory per block: {hist.device_limits(0)}")
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(torch, np, pipeline, hist, batch_time, "cuda")
    phase("kernels", t0)

    core_phase(torch, np, pipeline, cuda_time, hist, "cuda")

    tmp = tempfile.mkdtemp(prefix="slimm_chip_smoke_")
    try:
        stream_files = stream_phase(torch, np, pipeline, hist, tmp, "cuda",
                                    smi[0])
        rows += bam_phase(torch, np, pipeline, hist, batch_time, tmp, "cuda",
                          smi[0], stream_files)
        del stream_files
        main_launches, bench_files = cli_phase(hist, tmp, [])
        rows += dir_phase(torch, np, pipeline, hist, batch_time, tmp,
                          bench_files, smi[0])
        trace_phase(hist, tmp, bench_files, smi[0])
        multi_phase(np, pipeline, tmp, bench_files)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  launches of the CLI's main-path run {main_launches}; of every "
        f"path run {PATH_LAUNCHES}")

    main_case = {"slimm_hist2": "passA_real", "slimm_hist1": "passB_real"}
    replaces = {"slimm_hist2": "slimm_tpu/ops/hist.py:130",
                "slimm_hist1": "slimm_tpu/ops/hist.py:147"}
    kernels = []
    for name in ("slimm_hist2", "slimm_hist1"):
        kind = name.split("_")[1]
        row = next(r for r in rows if r["case"] == main_case[name])
        kernels.append(dict(
            name=name, route="cuda", source="slimm_tpu_torch/csrc/hist.cu",
            replaces=replaces[name], launches=PATH_LAUNCHES[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == kind),
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by="bytes",
            library_ms=row["library_ms"], share=row["share"]))
    log(json.dumps({"cases": rows}))
    log(smi[0])
    log(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
