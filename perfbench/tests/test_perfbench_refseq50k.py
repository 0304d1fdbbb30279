"""The full-RefSeq cell, refseq50k.core: it resolves, its database has the
configuration's size on every seed, and a traced CPU run of a cut-down copy
(20,000 genomes of 20-60 kbp, 1.5M records a sample: past
NATIVE_PROPAGATE_MIN LCA taxa, as the full database is) reports the LCA
pairs and propagation metrics, with every propagation in C++.

The cell itself is too large for a CPU run: the reference alone needs about
45 GB over its 1.33 billion bins."""

import dataclasses
import time

import numpy as np
import pytest

from harness import cell as cell_mod
from harness import generate
from harness.spec import load_cell

CELL = "refseq50k.core"
BINS = 1_333_360_000            # sum over the genomes of length // 150 + 1
TAXA = 66_704
SEEDS = (2**31 + 11, 3 * 2**33 + 5)
NEW = {"propagate_ms.core", "pairs_ms.core"}


def test_the_cell_resolves_with_its_metrics():
    c = load_cell(CELL)
    assert c.chips == 1 and c.traffic["entry"] == "arrays"
    assert {m.name for m in c.end_to_end} == {"core_records_per_s",
                                              "core_ms_p95", "setup_s"}
    assert NEW <= {m.name for m in c.per_layer}
    assert c.config["reduced"] == ["sample_records"]
    assert c.config["sample_records"] == 20_000_000


@pytest.mark.parametrize("seed", SEEDS)
def test_the_database_has_its_bins_and_taxa_on_every_seed(seed):
    cfg = load_cell(CELL).config
    db = generate.make_database(cfg, seed)
    lengths = db["lengths"].astype(np.int64)
    assert len(lengths) == 50_000
    assert int((lengths // cfg["read_length"] + 1).sum()) == BINS < 2**31
    assert len(db["taxid__name"]) == TAXA
    assert len(np.unique(db["lineage"])) == TAXA


def test_traced_cpu_run_of_a_cut_down_copy_reports_pairs_and_propagate():
    from slimm_tpu_torch.engine import pipeline

    c = load_cell(CELL)
    c = dataclasses.replace(c, config=dict(
        c.config, n_contigs=20_000, genome_length=[20_000, 60_000]))
    out = cell_mod.run_cell(c, seed=SEEDS[0], seconds=0.5, trace=True,
                            device="cpu", t_start=time.perf_counter(),
                            records=1_500_000, engine={"phase_log": False})
    assert out["correct"] is True, out["checks"]
    for name in NEW:
        assert out["metrics"][name]["value"] > 0, name
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["propagate_ms.core"] + m["pairs_ms.core"] < m["finalize_ms.core"]
    counts = pipeline.work_counts
    assert counts["native_propagations"] == out["info"]["calls"] >= 2
    assert counts["python_propagations"] == 0
