#!/usr/bin/env python3
"""Smoke run of slimm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root, one CUDA card)

Phases, each timed; any failure raises and the script exits non-zero:

  device   the card's name and power limit, as nvidia-smi reports them
  build    the CUDA kernels of slimm_tpu_torch/csrc/ (nvcc, sm_90a) and the
           native SAM/BAM decoder (make -C native)
  kernels  each kernel against its plain PyTorch version on the card, on 8M
           records at the profile's bin domains: bit-equal, both timed
  core     fused_profile (emit_coverage=False, the default CLI path) on the
           bench workloads, 8M records x 50 contigs and 10M x 1000, on cuda
           and on cpu: the packed stats vectors must be equal
  stream   the streamed paths on a 4M-record bench SAM (about 1.3 GB):
           the overlap path (profile_file's default at this size), the
           whole-file path, chunk streaming (v2 pieces, with and without the
           device cache), and at bin widths 40 and 20 the v2 pieces with
           local bins of 32768 and above, v1 chunks and the overlap path's
           fallback past uint16 bins; the path and launch counters of each
           run are read, the abundance TSVs must be equal per bin width and
           to a whole-file run on the CPU; pass A of the pieces must run
           without a host sync (torch's sync debug mode "error"); file
           seconds are the median of 3 beside a decode-only floor
  cli      `python -m slimm_tpu_torch profile` on a toy SAM against the
           oracle (--no-device); then the profile CLI on a 1M-record bench
           SAM (which takes the overlap path) with the kernel launch and
           path counts reset and read around it, against the same command
           with --device cpu

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The card's numbers come from this run alone.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the port runs without JAX: make any import of it fail in this process
sys.modules["jax"] = None

RECORDS = 8_000_000
CORE_WORKLOADS = [(8_000_000, 50, 0), (10_000_000, 1000, 2)]
CLI_RECORDS = 1_000_000
STREAM_RECORDS = 4_000_000
STREAM_CHUNK = 1 << 19


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
    """Bin-domain sizes of bench.make_workload(n, n_contigs, seed)."""
    import numpy as np

    import bench

    w = bench.make_workload(2_000, n_contigs, seed=seed)
    nbins = w["lengths"] // np.uint32(bin_width) + 1
    pair = -(-(n_contigs * w["n_codes"]) // 1024) * 1024
    return int(nbins.sum()), n_contigs + w["n_dense"], pair


def _load_toy():
    """tests/toy.py, the repository's toy dataset writer, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "slimm_toy", os.path.join(ROOT, "tests", "toy.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def kernel_phase(torch, np, hist, cuda_time, shared_counters, device):
    """Each kernel against its plain version at the profile's domains, on
    `device`; returns one row per case."""
    import bench

    a50, b50, p50 = geometry(50, 0)
    a1k, b1k, p1k = geometry(1000, 2)
    rng = np.random.default_rng(1)
    w = bench.make_workload(RECORDS, 50, seed=0)
    nbins = w["lengths"] // np.uint32(150) + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int64)
    center = np.minimum(w["pos"].astype(np.uint32) + np.uint32(75),
                        w["lengths"][w["rid"]])
    workload_bins = (boff[w["rid"]] + center // np.uint32(150)).astype(np.int32)

    # (name, kernel, domain, weight density, index source)
    cases = [
        ("passA_bins_50ctg", "hist2", a50, 0.9, "workload"),
        ("passA_d0", "hist2", a50, 0.0, "uniform"),
        ("passA_d0.9", "hist2", a50, 0.9, "uniform"),
        ("passA_d1", "hist2", a50, 1.0, "uniform"),
        ("passA_1000ctg", "hist2", a1k, 0.9, "uniform"),
        ("passA_12.6M", "hist2", 12_600_000, 0.9, "uniform"),
        ("hist2_shared", "hist2", shared_counters // 2, 0.9, "uniform"),
        ("passB_taxa_50ctg", "hist1", b50, 0.9, "uniform"),
        ("passB_taxa_1000ctg", "hist1", b1k, 0.9, "uniform"),
        ("passB_pairs_50ctg", "hist1", p50, 0.9, "uniform"),
        ("passB_pairs_1000ctg", "hist1", p1k, 0.9, "uniform"),
        ("passB_cov2_50ctg", "hist1", a50 + b50 - 50, 0.9, "uniform"),
    ]
    rows = []
    for name, kernel, n_bins, density, source in cases:
        if source == "workload":
            idx = workload_bins.copy()
        else:
            idx = rng.integers(0, n_bins, RECORDS).astype(np.int32)
        n = len(idx)
        idx[:70_000] = n_bins // 3              # one bin with 70,000 hits
        oor = rng.choice(n, 2_000, replace=False)
        idx[oor] = np.where(np.arange(2_000) % 2 == 0, -1 - oor % 100,
                            n_bins + oor % 100)  # dropped, weight or not
        d_idx = torch.from_numpy(idx).to(device)
        d_w1 = torch.from_numpy(rng.random(n) < density).to(device)
        d_w2 = torch.from_numpy(rng.random(n) < 0.85 * density).to(device)
        if kernel == "hist2":
            run_k = lambda: hist.hist2(d_idx, d_w1, d_w2, n_bins)  # noqa: E731
            run_p = lambda: hist.hist2_plain(d_idx, d_w1, d_w2, n_bins)  # noqa: E731
        else:
            run_k = lambda: (hist.hist1(d_idx, d_w1, n_bins),)  # noqa: E731
            run_p = lambda: (hist.hist1_plain(d_idx, d_w1, n_bins),)  # noqa: E731
        got = run_k()
        want = run_p()
        err = max(int((g.long() - p.long()).abs().max()) for g, p in
                  zip(got, want))
        for g, p in zip(got, want):
            require(torch.equal(g, p), f"{name}: {kernel} != plain version")
        require(int(want[0].sum()) > 0 or density == 0.0, f"{name}: empty")
        ms = cuda_time(run_k, reps=7) * 1e3
        plain_ms = cuda_time(run_p, reps=7) * 1e3
        variant = ("shared" if (2 if kernel == "hist2" else 1) * n_bins
                   <= shared_counters else "global")
        rows.append(dict(case=name, kernel=kernel, n_bins=n_bins,
                         density=density, variant=variant, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms))
        log(f"  {name:22s} {kernel} bins={n_bins:>10d} w={density:<4} "
            f"{variant:6s} equal  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    return rows


def core_phase(torch, np, pipeline, cuda_time, hist, device):
    """fused_profile on `device` and on the CPU; packed vectors equal."""
    import bench
    from slimm_tpu_torch.tables import DeviceTables

    for n, n_contigs, seed in CORE_WORKLOADS:
        t0 = time.perf_counter()
        w = bench.make_workload(n, n_contigs, seed=seed)
        bw = w["avg_read_len"]
        nbins = w["lengths"] // np.uint32(bw) + 1
        boff = np.concatenate([[0], np.cumsum(nbins)[:-1]])
        read_id, rid, pos, dedup_window, k_steps, window = \
            pipeline.plan_records(w["read_id"], w["rid"], w["pos"], n_contigs,
                                  deduped=False)
        packed = {}
        for dev in (device, "cpu"):
            tables = DeviceTables.from_numpy(
                w["lengths"], boff, boff + nbins, w["lineage"], w["sk_code"],
                n_dense=w["n_dense"], n_codes=w["n_codes"], half=bw // 2,
                bin_width=bw, q=0.95, device=dev)
            args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                    for a in (read_id, rid, pos)]

            def core():
                return pipeline.fused_profile(
                    *args, tables, dedup_window=dedup_window, k_steps=k_steps,
                    window=window, emit_coverage=False)["packed"]

            if dev == device:
                hist.reset_launch_counts()
                packed[dev] = core().cpu().numpy()
                launches = (hist.hist1_launches, hist.hist2_launches)
                require(launches[0] > 0 and launches[1] > 0,
                        f"core on {dev} launched (hist1, hist2) = {launches}")
                secs = cuda_time(core, reps=5)
                log(f"  core {len(read_id)} records x {n_contigs} contigs "
                    f"{dev}: median {secs:.6f} s, "
                    f"{len(read_id) / secs:.0f} records/s, "
                    f"launches hist1={launches[0]} hist2={launches[1]}")
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
        phase(f"core {n} x {n_contigs}", t0)


def stream_phase(torch, np, pipeline, hist, tmp, device, smi):
    """The streamed paths on `device` against each other and against the
    whole-file path on the CPU, on one 4M-record SAM.  On a GPU, pass A of
    the pieces runs under torch's sync debug mode "error": any call in it
    that makes the host wait for the card raises."""
    import bench
    from slimm_tpu.config import EngineOptions, ProfileOptions
    from slimm_tpu.io import native
    from slimm_tpu_torch.engine.reports import write_abundance

    require(native.available(), "stream phase: the native decoder is not "
            "built, and neither streamed path exists without it")
    t0 = time.perf_counter()
    d = os.path.join(tmp, "stream")
    os.makedirs(d)
    w = bench.make_workload(STREAM_RECORDS, 50, seed=1)
    sam = os.path.join(d, "stream.sam")
    mb = bench.write_bench_sam(sam, w, 50)
    db = bench.make_bench_db(w, 50)
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
            launches = (hist.hist1_launches, hist.hist2_launches)
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

    def pass_a_without_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return pass_a_pieces(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    stream = pipeline.profile_file_streaming
    whole = pipeline.profile_file
    if device != "cpu":
        pipeline._pass_a_pieces = pass_a_without_sync
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
    finally:
        pipeline._pass_a_pieces = pass_a_pieces
    if device != "cpu":
        log("  pass A of every piece ran under sync debug mode \"error\": "
            "no host sync")

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
        f"decode-only floor {secs['decode_floor']:.3f}")
    os.remove(sam)
    phase("stream", t0)
    return secs


def cli_phase(hist, tmp, device_args):
    """The profile CLI; `device_args` select its device ([] takes the
    default, cuda).  Returns the launch counts of the main-path run."""
    import bench
    from slimm_tpu_torch import cli
    from slimm_tpu_torch.engine import pipeline

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
    w = bench.make_workload(CLI_RECORDS, 50, seed=1)
    sam = os.path.join(d, "bench.sam")
    mb = bench.write_bench_sam(sam, w, 50)
    db = os.path.join(d, "bench.sldb")
    bench.make_bench_db(w, 50).save_sldb(db)
    log(f"  wrote {len(w['read_id'])}-record SAM ({mb:.1f} MB) and DB: "
        f"{time.perf_counter() - t0:.3f} s")
    hist.reset_launch_counts()
    pipeline.reset_path_counts()
    c0 = time.perf_counter()
    rc = cli.main(["profile", *device_args, "-o", d + "/gpu/", db, sam])
    cuda_secs = time.perf_counter() - c0
    launches = {"slimm_hist1": hist.hist1_launches,
                "slimm_hist2": hist.hist2_launches}
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
    return launches


def main() -> int:
    if not (os.path.isdir(os.path.join(ROOT, "slimm_tpu_torch"))
            and os.path.exists(os.path.join(ROOT, "bench.py"))):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(slimm_tpu_torch/ not found beside it)", file=sys.stderr)
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
    from slimm_tpu_torch.engine import pipeline
    from slimm_tpu_torch.ops import _build, hist
    from slimm_tpu_torch.utils.devbench import cuda_time

    lib = _build.load()
    log(f"  kernels built in {time.perf_counter() - t0:.3f} s: "
        f"{os.path.relpath(_build.library_path(), ROOT)}")
    n0 = time.perf_counter()
    make = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                          capture_output=True, text=True)
    native = os.path.exists(os.path.join(ROOT, "slimm_tpu", "native",
                                         "libslimm_native.so"))
    log(f"  native decoder: make exit {make.returncode} in "
        f"{time.perf_counter() - n0:.3f} s; SAM decoder in use: "
        f"{'native C++' if native else 'pure Python'}")
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(torch, np, hist, cuda_time,
                        lib.slimm_hist_shared_counters(), "cuda")
    phase("kernels", t0)

    core_phase(torch, np, pipeline, cuda_time, hist, "cuda")

    tmp = tempfile.mkdtemp(prefix="slimm_chip_smoke_")
    try:
        stream_phase(torch, np, pipeline, hist, tmp, "cuda", smi[0])
        launches = cli_phase(hist, tmp, [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_case = {"slimm_hist2": "passA_bins_50ctg",
                 "slimm_hist1": "passB_taxa_50ctg"}
    replaces = {"slimm_hist2": "slimm_tpu/ops/hist.py:130",
                "slimm_hist1": "slimm_tpu/ops/hist.py:147"}
    kernels = []
    for name in ("slimm_hist2", "slimm_hist1"):
        kind = name.split("_")[1]
        row = next(r for r in rows if r["case"] == main_case[name])
        kernels.append(dict(
            name=name, route="cuda", source="slimm_tpu_torch/csrc/hist.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == kind),
            ms=row["ms"], plain_ms=row["plain_ms"]))
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
