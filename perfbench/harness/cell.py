"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, the metrics and the result line.

The traffic file says what the window drives:

  entry "arrays"  records in host memory -> `pipeline.profile_arrays`
                  (raw multi-hit records, `deduped=False`), the samples in
                  turn, one caller (a closed loop)
  entry "file"    one alignment file -> `pipeline.profile_file`, then
                  `reports.write_abundance`, as the CLI's `profile` does

with the options the CLI builds without -ro/-co.  `samples` samples are
drawn from the seed against one database; `records` (or the
configuration's `sample_records`) sets their size; `path_counts` says which
`pipeline.path_counts` the window must move (a value "calls": once a call;
"any": not checked; every other counter stays 0), or the run gives no
result; one call in `check_every`, drawn from the seed, keeps its state for
the check, as does each sample's first call.
"""

from __future__ import annotations

import copy
import gc
import os
import shutil
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from reference import slimm as reference

from . import compare, generate, guards
from .spec import Cell
from .trace import MarkList, Tracer, call_span, tsv_span, window_span

FAULTS = (None, "stale", "half", "alter")


@dataclass
class Call:
    sample: int
    t0: float
    t1: float               # the answer returned (file: its TSV written)
    records: int
    t_cut: float | None = None   # pipeline's "cutoffs" mark (traced runs)


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window_s: float
    calls: list
    work: list = field(default_factory=list)    # reference's, per sample
    trace: object = None                        # trace.TraceSummary
    peak_window_bytes: int | None = None
    files: list = field(default_factory=list)
    path_counts: dict = field(default_factory=dict)  # pipeline's, window

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def _half(s: dict) -> dict:
    """The sample with its second half of reads left out (a fault)."""
    cut = int(np.searchsorted(s["read_id"], s["n_reads"] // 2))
    return dict(s, read_id=s["read_id"][:cut], rid=s["rid"][:cut],
                pos=s["pos"][:cut], n_reads=s["n_reads"] // 2)


def _spread(ms: list) -> dict:
    """Quantiles of the calls' times, and the first and last tenth's mean:
    where a run's time goes within the window."""
    q = np.percentile(ms, [5, 25, 50, 75, 95]).tolist() if ms else []
    k = max(1, len(ms) // 10)
    return {"p5_25_50_75_95": q, "first_tenth": float(np.mean(ms[:k])),
            "last_tenth": float(np.mean(ms[-k:]))} if ms else {}


def _keep_mask(seed: int, every: int, n: int = 1 << 16) -> np.ndarray:
    rng = np.random.default_rng([seed % 2**64, 7])
    return rng.random(n) * every < 1


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, entry: str = "program",
             fault: str | None = None, records: int | None = None,
             engine: dict | None = None) -> dict:
    """One run; returns the result object whose JSON is the run's last line.

    `entry` "control" puts the reference, computed in bfloat16, in the
    program's place; `fault` breaks the timed path (tests); `records` and
    `engine` (EngineOptions fields) resize and re-tune a run (tests)."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(cell, seed, seconds, trace, device, t_start, entry,
                    fault, records, engine or {}, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, entry, fault, records,
         engine_kw, tmp):
    import torch

    from slimm_tpu_torch.config import EngineOptions, ProfileOptions
    from slimm_tpu_torch.database import SlimmDatabase
    from slimm_tpu_torch.engine import pipeline, reports

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    on_file = tr["entry"] == "file"

    # -- set-up: the database, the samples, the file ------------------------
    db = generate.make_database(cfg, seed)
    n_records = records or tr.get("records") or cfg["sample_records"]
    samples = [generate.make_sample(cfg, db, seed, i, n_records)
               for i in range(tr["samples"])]
    seen = [_half(s) for s in samples] if fault == "half" else samples
    pdb = SlimmDatabase(
        ac__taxid={k: list(v) for k, v in db["ac__taxid"].items()},
        taxid__name=dict(db["taxid__name"]))
    options = ProfileOptions(**cfg["options"])
    engine = EngineOptions(fetch_coverage=False, **engine_kw)
    files = []
    if on_file:
        write = {"sam": generate.write_sam, "bam": generate.write_bam}
        for i, s in enumerate(seen):
            files.append(os.path.join(tmp, f"sample{i}.{tr['format']}"))
            write[tr["format"]](files[-1], db, s)
    avg = (generate.file_read_length(cfg["read_length"]) if on_file
           else cfg["read_length"])

    def produce(i, out):
        """The timed call: the program's ProfileState, or the control's
        answer."""
        k = i % len(seen)
        opts = copy.deepcopy(options)
        if entry == "control":
            s = seen[k]
            return reference.profile(
                s["read_id"], s["rid"], s["pos"], contig_names=db["names"],
                contig_lengths=db["lengths"], ac__taxid=db["ac__taxid"],
                taxid__name=db["taxid__name"], options=cfg["options"],
                avg_read_length=avg, rnd=reference.to_bfloat16)
        if on_file:
            opts.output_prefix = out
            return pipeline.profile_file(opts, pdb, files[k], device=dev,
                                         engine=engine)
        s = seen[k]
        return pipeline.profile_arrays(
            opts, pdb, db["names"], db["lengths"], s["read_id"], s["rid"],
            s["pos"], s["n_reads"], len(s["rid"]), avg, device=dev,
            engine=engine, deduped=False)

    def report(result, i, out):
        """The file cells' TSV, written as the CLI writes it."""
        if isinstance(result, dict):          # the control's answer
            os.makedirs(out, exist_ok=True)
            with open(tsv_of(i, out), "w") as f:
                f.write(TSV_HEADER + "".join(r + "\n" for r in result["rows"]))
        else:
            reports.write_abundance(result, out, files[i % len(files)])

    def tsv_of(i, out):
        stem = os.path.basename(files[i % len(files)]).rsplit(".", 1)[0]
        return os.path.join(out, stem + "_profile.tsv")

    prev = [None]

    def one_call(i, out):
        if fault == "stale" and prev[0] is not None:
            result = prev[0]
        else:
            result = produce(i, out)
        prev[0] = result
        if fault == "alter" and not isinstance(result, dict):
            tid = min(result.taxon_id__read_count)
            result.taxon_id__read_count[tid] += 1
        return result

    # -- warm-up: every shape the window uses, once -------------------------
    out_root = os.path.join(tmp, "out")
    for i in range(len(seen)):
        out = os.path.join(out_root, f"warm{i}") + "/"
        r = one_call(i, out)
        if on_file:
            report(r, i, out)
    del r

    # -- the window ---------------------------------------------------------
    marks = MarkList() if trace else None
    pipeline.host_marks = marks
    pipeline.reset_path_counts()
    peak_before = 0
    if cuda:
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    keep = _keep_mask(seed, int(tr.get("check_every", 1)))
    kept, calls, raised = {}, [], {}
    tracer = Tracer(cuda) if trace else nullcontext()
    span = call_span if trace else nullcontext
    tspan = tsv_span if trace else nullcontext
    with tracer:
        with window_span() if trace else nullcontext():
            t_w0 = time.perf_counter()
            setup_s = t_w0 - t_start
            end = t_w0 + seconds
            i = 0
            while i < len(seen) or time.perf_counter() < end:
                out = os.path.join(out_root, str(i)) + "/"
                t0 = time.perf_counter()
                try:
                    with span():
                        result = one_call(i, out)
                    if on_file:
                        with tspan():
                            report(result, i, out)
                except Exception as e:      # counted against the run
                    raised[i] = f"{type(e).__name__}: {e}"
                    result = None
                t1 = time.perf_counter()
                n = len(seen[i % len(seen)]["rid"])
                c = Call(i % len(seen), t0, t1, n)
                if marks is not None:
                    cut = [t for p, t in marks if p == "cutoffs"]
                    c.t_cut = cut[-1] if cut else None
                    del marks[:]
                calls.append(c)
                if result is not None and (i < len(seen)
                                           or keep[i % len(keep)]):
                    kept[i] = result
                result = None
                i += 1
            if cuda:
                torch.cuda.synchronize()
            t_w1 = time.perf_counter()
    pipeline.host_marks = None
    path_counts = dict(pipeline.path_counts)
    peak_window = torch.cuda.max_memory_allocated() if cuda else None
    prev[0] = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: the reference once per sample, after the window ---------
    t_ref = time.perf_counter()
    refs = [reference.profile(
        s["read_id"], s["rid"], s["pos"], contig_names=db["names"],
        contig_lengths=db["lengths"], ac__taxid=db["ac__taxid"],
        taxid__name=db["taxid__name"], options=cfg["options"],
        avg_read_length=avg) for s in samples]
    ref_s = time.perf_counter() - t_ref
    if entry == "program":
        # a run that took another path than its traffic names measured
        # another program: no result
        want = tr.get("path_counts", {})
        off = {k: n for k, n in path_counts.items() if want.get(k, 0) != "any"
               and n != (len(calls) if want.get(k, 0) == "calls"
                         else want.get(k, 0))}
        if off:
            raise RuntimeError(f"pipeline.path_counts {off} are off the "
                               f"traffic's {want} over {len(calls)} calls")
    differing = dict.fromkeys(compare.GROUPS, 0)
    wrong = set(raised)         # an answer that never came is wrong
    for i, result in kept.items():
        got = (result if isinstance(result, dict)
               else compare.answer_of_state(result))
        for group, n in compare.compare(got, refs[i % len(refs)]).items():
            differing[group] += n
            if n:
                wrong.add(i)
    if on_file:
        differing["tsv"] = 0
        for i in range(len(calls)):
            try:
                with open(tsv_of(i, os.path.join(out_root, str(i)))) as f:
                    lines = f.read().split("\n")
            except OSError:
                lines = []
            want = refs[i % len(refs)]["rows"]
            if lines and lines[0] + "\n" == TSV_HEADER and lines[-1] == "":
                n = compare.differ(lines[1:-1], want)
            else:
                n = max(1, len(want))
            differing["tsv"] += n
            if n:
                wrong.add(i)
    kept.clear()
    check_s = time.perf_counter() - t_ref
    checks = {"wrong_answers": len(wrong)}
    correct = bool(calls) and len(wrong) <= LIMIT

    # -- metrics ------------------------------------------------------------
    run = Run(cell, setup_s, t_w1 - t_w0, calls,
              work=[r["work"] for r in refs],
              trace=tracer.summary if trace else None,
              peak_window_bytes=peak_window, files=files,
              path_counts=path_counts)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}

    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if cuda
                         else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (max(peak_before, peak_window)
                                      if cuda else 0)}
    if cuda:
        dev_info["power_limit"] = guards.power_limit()
    out = {"correct": correct, "attempted": len(calls),
           "failed": len(wrong),
           "metrics": metrics, "device": dev_info}
    if trace:
        s = tracer.summary
        dev_info.update(busy_s=s.busy_s(), window_s=s.window_s)
        out["breakdown"] = {"device_ops": s.top_device_ops(),
                            "idle_gaps": s.idle_gaps()}
    out["info"] = {
        "seed": seed, "setup_sec": setup_s, "window_sec": t_w1 - t_w0,
        "calls": len(calls), "checked_calls": len(
            [1 for i in range(len(calls))
             if i < len(seen) or keep[i % len(keep)]]),
        "records_per_call": [len(s["rid"]) for s in seen],
        "reference_s": ref_s, "check_s": check_s,
        "path_counts": {k: v for k, v in path_counts.items() if v},
        "file_bytes": [os.path.getsize(f) for f in files],
        "call_ms": _spread([1e3 * (c.t1 - c.t0) for c in calls]),
        "fields_differing": differing,
        "raised": list(raised.items())[:3], "entry": entry,
        "fault": fault}
    if trace:
        out["info"]["trace_reduce_s"] = tracer.reduce_s
    out["checks"] = {k: {"value": v, "limit": LIMIT}
                     for k, v in checks.items()}
    return out


# The one number compared: the checked answers (each sample's first call,
# a seeded share of the others, every TSV) that differ from the
# reference's in any field, with the calls that raised.  The comparison is
# exact, so its limit is 0.
LIMIT = 0

TSV_HEADER = "taxa_level\ttaxa_id\tlinage\tabundance\tread_count\n"
