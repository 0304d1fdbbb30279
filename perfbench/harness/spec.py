"""BENCHMARK.json and the files its names lead to.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one `configs` gives; the traffic mix is
`perfbench/traffic/<traffic>.json`; a metric is `perfbench/metrics/<name>.py`,
a module with `read(run) -> float | None`.  Nothing here knows a cell, a
configuration or a metric by name: a later change adds files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    spec: dict
    read: object            # read(run) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # [Metric] this cell reports with --trace 0
    per_layer: list         # [Metric] this cell reports with --trace 1


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metric_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "perfbench", "metrics", name + ".py")


def traffic_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "perfbench", "traffic", name + ".json")


def load_metric(spec: dict, root: str = ROOT) -> Metric:
    path = metric_path(spec["name"], root)
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + spec["name"].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return Metric(spec["name"], spec["unit"], spec, mod.read)


def _applies(spec: dict, cell: str, reported: set | None) -> bool:
    if "workloads" in spec:
        return cell in spec["workloads"]
    return reported is None or spec["moves"] in reported


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {', '.join(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], root)) as f:
        traffic = json.load(f)
    e2e = [load_metric(m, root) for m in bench["end_to_end"]
           if _applies(m, workload, None)]
    reported = {m.name for m in e2e}
    layer = [load_metric(m, root) for m in bench["per_layer"]
             if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)
