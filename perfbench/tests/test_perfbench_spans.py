"""The per-layer metrics that read the program's own spans and counters
(harness/spans.py): reported by a traced run of each cell on the CPU at a
tiny size, and on the card (`-m card`) no device event of a traced window
carries a program span's name, so the spans leave the device's busy time
as it is."""

import time

import pytest
import torch

from harness import cell as cell_mod
from harness import spans, trace
from harness.spec import load_benchmark, load_cell

RECORDS = 20000
SEED = 2**33 + 777
CELLS = [w["name"] for w in load_benchmark()["workloads"]]

# the metrics that read the program's spans and counters; upload_gbps.core
# also needs the device's copies, which a CPU run has none of
PROGRAM = {
    "init_ms.core", "plan_ms.core", "upload_ms.core", "pass_a_ms.core",
    "cutoffs_ms.core", "pass_b_ms.core", "fetch_ms.core", "finalize_ms.core",
    "untraced_ms.core", "minor_faults.core", "upload_gbps.core",
    "decode_wait_ms.file", "pass_a_ms.file", "finalize_ms.file",
    "report_ms.file", "host_cpu_ms.file"}
ON_THE_CARD_ONLY = {"upload_gbps.core"}


def _run(name, device, trace_on=True, seconds=0.5):
    c = load_cell(name)
    engine = {"phase_log": False}
    if c.traffic.get("path") == "overlap":
        engine["overlap_min_bytes"] = 1   # a tiny SAM takes the overlap path
    return c, cell_mod.run_cell(c, seed=SEED, seconds=seconds, trace=trace_on,
                                device=device, t_start=time.perf_counter(),
                                records=RECORDS, engine=engine)


@pytest.mark.parametrize("name", CELLS)
def test_traced_cpu_run_reports_the_program_metrics(name):
    c, out = _run(name, "cpu")
    assert out["correct"] is True
    want = {m.name for m in c.per_layer} & PROGRAM
    assert want, "the cell reads none of the program's spans"
    assert want - ON_THE_CARD_ONLY <= set(out["metrics"])
    for metric in want - ON_THE_CARD_ONLY:
        assert out["metrics"][metric]["value"] >= 0, metric
    # every stage span lies inside the call: the stages and what they leave
    # unnamed add up to no more than the mean call
    m = {k: v["value"] for k, v in out["metrics"].items()}
    if c.traffic["entry"] == "arrays":
        stages = sum(m[k] for k in want if k.endswith("_ms.core"))
        assert 0 < stages <= out["info"]["window_sec"] * 1e3 / out[
            "info"]["calls"]


class _Window:
    """A run's traced window, as harness/trace.py summarises it."""

    def __init__(self, host):
        self.trace = trace.TraceSummary((0, 1000), host=host)


def test_untraced_time_is_the_profile_span_less_its_direct_children(
        monkeypatch):
    ev = trace.Event
    run = _Window([ev("slimm.profile", 0, 100), ev("slimm.init", 0, 10),
                   ev("slimm.plan", 10, 30), ev("aten::sort", 12, 20),
                   ev("slimm.report", 12, 20),      # nested: not a child
                   ev("slimm.pass_a", 50, 60), ev("slimm.profile", 200, 300),
                   ev("slimm.finalize", 250, 300), ev("slimm.plan", 400, 410)])
    monkeypatch.setattr(spans, "calls", lambda: 2)
    # (100 - 40) + (100 - 50) ns over 2 calls
    assert spans.untraced_ms_per_call(run) == pytest.approx(55 / 1e6)
    assert spans.ms_per_call(run, "plan") == pytest.approx(30 / 2 / 1e6)
    assert spans.ms_per_call(run, "fetch") is None
    monkeypatch.setattr(spans, "calls", lambda: None)
    assert spans.untraced_ms_per_call(run) is None


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_no_device_event_carries_a_program_span(card, name, monkeypatch):
    kept = []

    class Keep(trace.Tracer):
        def __exit__(self, *exc):
            kept.append(self)
            return super().__exit__(*exc)

    monkeypatch.setattr(cell_mod, "Tracer", Keep)
    _, out = _run(name, card, seconds=1.0)
    assert out["correct"] is True
    events = kept[0].prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    device = [e.name() for e in events if e.device_type() != cpu]
    host = {e.name() for e in events if e.device_type() == cpu}
    assert device and "slimm.profile" in host
    assert not [n for n in device if n.startswith("slimm.")]
