"""On the card, at each cell's own size: the control (the reference in
bfloat16, in the program's place, for a short window at the cell's load)
must come out not correct on every seed, and the numbers it reads are the
upper readings that PERF.md sets the limits from.

    python -m pytest perfbench/tests -q -m card -s
"""

import json
import time

import pytest

from harness.cell import run_cell
from harness.spec import load_benchmark, load_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEEDS = (3000000101, 3000000202, 3000000303)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(card, cell):
    c = load_cell(cell)
    for seed in SEEDS:
        out = run_cell(c, seed=seed, seconds=1.0, trace=False, device=card,
                       t_start=time.perf_counter(), entry="control")
        wrong = out["checks"]["wrong_answers"]["value"]
        differing = out["info"]["fields_differing"]
        print("control", cell, seed, "wrong_answers", wrong, "of",
              out["attempted"], json.dumps(differing))
        assert out["correct"] is False and wrong >= 1
