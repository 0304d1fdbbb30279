"""The harness's run at a tiny size on the CPU (a device the command line
does not offer): the result line's shape, the check passing on the
program, and failing with the timed path broken underneath or the control
in the program's place."""

import dataclasses
import json
import time

import pytest

from harness import spec
from harness.cell import run_cell

RECORDS = 20000
SEED = 2**33 + 12345


def _cell(name):
    """A cell of BENCHMARK.json, or the BAM mix that PERF.md keeps for a
    later cell (`genus50.bam`: the SAM cell's metrics over traffic/bam)."""
    if name != "genus50.bam":
        return spec.load_cell(name)
    with open(spec.traffic_path("bam")) as f:
        return dataclasses.replace(spec.load_cell("genus50.sam"), name=name,
                                   traffic=json.load(f))


def _run(cell, trace=False, **kw):
    c = _cell(cell)
    engine = {"phase_log": False}
    if c.traffic.get("path") == "overlap":
        engine["overlap_min_bytes"] = 1   # a tiny SAM takes the overlap path
    out = run_cell(c, seed=SEED, seconds=0.5, trace=trace, device="cpu",
                   t_start=time.perf_counter(), records=RECORDS,
                   engine=engine, **kw)
    return c, json.loads(json.dumps(out))


def _shape(c, out, trace):
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = c.per_layer if trace else c.end_to_end
    assert set(out["metrics"]) <= {m.name for m in want}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for name, chk in out["checks"].items():
        assert set(chk) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell,trace", [
    ("genus50.core", False), ("genus50.core", True), ("genus50.sam", False),
    ("genus50.sam", True), ("genus50.bam", False), ("genus50.bam", True),
    ("refseq1k.core", False)])
def test_run_is_correct_and_well_formed(cell, trace):
    c, out = _run(cell, trace)
    _shape(c, out, trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    if not trace:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) >= 2
    if c.traffic["entry"] == "file":
        assert out["info"]["fields_differing"]["tsv"] == 0
        assert out["info"]["path_counts"].get("overlap_files", 0) == (
            out["attempted"] if c.traffic["path"] == "overlap" else 0)


@pytest.mark.parametrize("cell,fault", [
    ("genus50.core", "stale"), ("genus50.core", "half"),
    ("genus50.core", "alter"), ("genus50.sam", "half"),
    ("genus50.sam", "alter"), ("genus50.bam", "alter")])
def test_broken_timed_path_is_not_correct(cell, fault):
    _, out = _run(cell, fault=fault)
    assert out["correct"] is False
    assert out["failed"] == out["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("cell", ["genus50.core", "genus50.bam"])
def test_the_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place: the cutoffs and
    the abundances move, and the exact comparison catches them."""
    _, out = _run(cell, entry="control")
    assert out["correct"] is False
    checked = out["info"]["checked_calls"]
    assert out["checks"]["wrong_answers"]["value"] == checked
    differing = out["info"]["fields_differing"]
    assert differing["pass_a"] == 0 and differing["finalize"] > 0
