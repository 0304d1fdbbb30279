"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import os
import re

import pytest

from harness import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_one_line_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_what_it_names(entry):
    cfg = json.load(open(os.path.join(spec.ROOT, entry["file"])))
    assert entry["file"].startswith("perfbench/")
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert cfg["name"] == entry["name"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key in entry["reduced"]:
        assert key in cfg and key in cfg["published"]
        assert not key.endswith(("_dim", "_rank"))
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert w["chips"] == 1 and c.chips == 1
    assert os.path.isfile(spec.traffic_path(w["traffic"]))
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m.spec["moves"] in e2e
    assert sum(x["config"] == w["config"] and x["traffic"] == w["traffic"]
               for x in BENCH["workloads"]) == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert os.path.isfile(spec.metric_path(metric["name"]))
    assert callable(spec.load_metric(metric).read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        ends = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in ends and metric["layer"]


def test_harness_names_no_cell_config_or_metric():
    names = set(CELLS) | {c["name"] for c in BENCH["configs"]} | {
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    sources = [os.path.join(spec.BENCH_DIR, "run.py")] + [
        os.path.join(spec.BENCH_DIR, "harness", f)
        for f in os.listdir(os.path.join(spec.BENCH_DIR, "harness"))
        if f.endswith(".py")]
    for path in sources:
        text = open(path).read()
        for name in names:
            assert f'"{name}"' not in text, (path, name)
