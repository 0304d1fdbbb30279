"""quantile_ms.core, the coverage-quantile walks' per-layer metric: it
resolves in the three core cells only, reads the window's `slimm.quantile`
spans over its calls (None on the file entry, and None for a program that
opens no such span), and a traced CPU run of each core cell at a tiny
size (refseq50k.core cut down, conftest.py) reports it, with four walks
a call in `pipeline.work_counts`."""

import time

import pytest

from harness import cell as cell_mod
from harness import spans, trace
from harness.spec import load_benchmark, load_cell, load_metric

METRIC = "quantile_ms.core"
CORE = [w["name"] for w in load_benchmark()["workloads"]
        if w["name"].endswith(".core")]
RECORDS = 20000
SEED = 2**33 + 1409


def _reader():
    spec = {m["name"]: m for m in load_benchmark()["per_layer"]}[METRIC]
    return load_metric(spec).read


def test_the_metric_resolves_in_the_core_cells_only():
    for w in load_benchmark()["workloads"]:
        names = {m.name for m in load_cell(w["name"]).per_layer}
        assert (METRIC in names) == w["name"].endswith(".core"), w["name"]


class _Window:
    """A run's traced window, as harness/trace.py summarises it."""

    def __init__(self, entry, host):
        self.traffic = {"entry": entry}
        self.trace = trace.TraceSummary((0, 1000), host=host)


def test_the_metric_sums_the_walks_over_the_calls(monkeypatch):
    ev = trace.Event
    host = [ev("slimm.cutoffs", 0, 100), ev("slimm.quantile", 10, 20),
            ev("slimm.quantile", 20, 50), ev("slimm.finalize", 200, 300),
            ev("slimm.quantile", 210, 214), ev("slimm.quantile", 214, 220),
            ev("slimm.quantile", 900, 1100)]       # past the window
    monkeypatch.setattr(spans, "calls", lambda: 2)
    read = _reader()
    assert read(_Window("arrays", host)) == pytest.approx(50 / 2 / 1e6)
    assert read(_Window("file", host)) is None
    # a program without the span (the parent of the change that adds it)
    older = [e for e in host if e.name != "slimm.quantile"]
    assert read(_Window("arrays", older)) is None


@pytest.mark.parametrize("name", CORE)
def test_traced_cpu_run_reports_the_walks(name, cpu_sized):
    from slimm_tpu_torch.engine import pipeline

    c = cpu_sized(load_cell(name))
    out = cell_mod.run_cell(c, seed=SEED, seconds=0.5, trace=True,
                            device="cpu", t_start=time.perf_counter(),
                            records=RECORDS, engine={"phase_log": False})
    assert out["correct"] is True, out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < m[METRIC] < m["cutoffs_ms.core"] + m["finalize_ms.core"]
    calls = out["info"]["calls"]
    assert pipeline.work_counts["quantile_walks"] == 4 * calls >= 8
    assert pipeline.work_counts["quantile_values"] > 0
