"""The whole-file plan of slimm_tpu_torch's profile_arrays, on the CPU.

profile_arrays uploads the records first and takes their plan from the
upload (engine/pipeline.py plan_uploaded): the sortedness and the longest
run of equal read ids in one host read, a stable sort on the device for
unsorted records, and plan_records on the host only where raw records need
its first-hit dedup.  Its (dedup_window, k_steps, window) and the records
it hands pass A equal plan_records' on every input here, each state equals
slimm_tpu's profile_arrays on the same arrays, and `work_counts` says which
plan ran (`device_plans`, `host_plans`)."""

import copy

import numpy as np
import pytest
import torch

from slimm_tpu.config import EngineOptions, ProfileOptions
from slimm_tpu.engine.pipeline import profile_arrays as jax_profile_arrays
from slimm_tpu_torch.engine import pipeline as tp
from slimm_tpu_torch.parallel import ShardedRunner
from slimm_tpu_torch.tables import DeviceTables

from tests.test_engine import assert_states_equal
from tests.test_torch_host import to_port
from tests.toy import READ_LEN, TOY_CONTIGS, build_toy_db

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the toy contigs, then contigs absent from the database: room for deduped
# reads of up to C records
NAMES = [c[1] for c in TOY_CONTIGS] + [f"NC_1000{k:02d}.1" for k in range(26)]
LENGTHS = np.array([c[2] for c in TOY_CONTIGS] + [3000] * 26, np.int64)
C = len(NAMES)
W = tp.MAX_WINDOW

# case -> (reads, longest run, deduped, max_targets, shuffled, sharded,
# the plan that runs: "device" or "host")
CASES = {
    "grouped_run1": (300, 1, False, 0, False, False, "device"),
    "grouped_run3": (300, 3, False, 0, False, False, "device"),
    "grouped_run_window": (300, W + 1, False, 0, False, False, "device"),
    "raw_run_past_window": (300, W + 2, False, 0, False, False, "host"),
    "deduped_run_past_window": (300, 20, True, 0, False, False, "device"),
    "unsorted_run3": (300, 3, False, 0, True, False, "device"),
    "unsorted_run3_sharded": (300, 3, False, 0, True, True, "device"),
    "unsorted_run_past_window": (300, W + 2, False, 0, True, False, "host"),
    "empty": (0, 1, False, 0, False, False, "device"),
    "one_record": (1, 1, False, 0, False, False, "device"),
    "max_targets": (300, 3, True, 3, False, False, "device"),
}


def _records(case):
    """(read_id, rid, pos) of a case: reads of 1..longest records, one read
    of exactly the longest, each first on a toy contig of the database; raw
    records repeat contigs within a read (the first hit counts), deduped
    ones do not."""
    n_reads, longest, deduped, _, shuffled, _, _ = CASES[case]
    rng = np.random.default_rng(len(case) * 31 + longest)
    runs = rng.integers(1, longest + 1, n_reads)
    if n_reads:
        runs[n_reads // 2] = longest
    read_id = np.repeat(np.arange(n_reads, dtype=np.int32), runs)
    first = np.repeat(rng.integers(0, 5, n_reads), runs)
    if deduped:
        rid = (first + np.concatenate([np.arange(r) for r in runs])) % C
    else:
        rid = rng.integers(0, 5, len(read_id))
    rid = rid.astype(np.int32)
    pos = (rng.random(len(rid)) * (LENGTHS[rid] - READ_LEN)).astype(np.int32)
    if shuffled:
        order = rng.permutation(len(read_id))
        read_id, rid, pos = read_id[order], rid[order], pos[order]
    return read_id, rid, pos


def _plan_grid():
    """A grid of the CPU alone (its tables are not read by the plan)."""
    return tp.Grid.single(DeviceTables.from_numpy(
        np.array([1000]), [0], [10], np.zeros((1, 8)), np.zeros(1),
        n_dense=1, n_codes=9, half=50, bin_width=100, q=0.95, device=CPU))


def _profile(case, db, records):
    """(port's state, slimm_tpu's state) of a case's records."""
    n_reads, _, deduped, max_targets, _, sharded, _ = CASES[case]
    args = (NAMES, LENGTHS, *records, n_reads, len(records[0]), READ_LEN)
    where = (dict(sharded_runner=ShardedRunner(devices=[["cpu", "cpu"]] * 2))
             if sharded else dict(device=CPU))
    st_t = tp.profile_arrays(
        to_port(ProfileOptions()), to_port(db), *args,
        engine=to_port(EngineOptions(phase_log=False)), deduped=deduped,
        max_targets=max_targets, **where)
    st_j = jax_profile_arrays(
        ProfileOptions(), copy.deepcopy(db), *args,
        engine=EngineOptions(phase_log=False), deduped=deduped,
        max_targets=max_targets)
    return st_t, st_j


@pytest.fixture(scope="module")
def toy_db(toy_dir):
    return build_toy_db(toy_dir)


@pytest.mark.parametrize("case", list(CASES))
def test_device_plan_matches_host_plan(case, toy_db):
    n_reads, _, deduped, max_targets, _, _, ran = CASES[case]
    host = _records(case)
    want = tp.plan_records(*host, C, deduped=deduped, max_targets=max_targets)

    tp.reset_path_counts()
    grid = _plan_grid()
    records, *plan = tp.plan_uploaded(grid, grid.upload(*host), host, C,
                                      deduped=deduped,
                                      max_targets=max_targets)
    assert tuple(plan) == tuple(want[3:])
    assert all(x.device == CPU and x.dtype == torch.int32 for x in records)
    for got, expect in zip(records, want[:3]):
        np.testing.assert_array_equal(got.numpy(), expect)
    plans = (tp.work_counts["device_plans"], tp.work_counts["host_plans"])
    assert plans == ((1, 0) if ran == "device" else (0, 1))

    if not n_reads:
        return
    tp.reset_path_counts()
    st_t, st_j = _profile(case, toy_db, host)
    assert_states_equal(st_j, st_t)
    assert tp.work_counts["calls"] == 1
    plans = (tp.work_counts["device_plans"], tp.work_counts["host_plans"])
    assert plans == ((1, 0) if ran == "device" else (0, 1))


def test_plan_counters_and_record_uploads(toy_db):
    """device_plans and host_plans add up to the calls, and the records are
    uploaded once a call, and again deduped where the host planned: the
    bytes are the tables', the validity mask's, the two cutoffs' and 12 a
    record uploaded (tests/test_torch_spans.py's formula)."""
    tables = C * (8 + 4 + 4 + 8 * 4 + 4) + 256 * 4
    cases = ["grouped_run3", "raw_run_past_window", "max_targets",
             "unsorted_run_past_window", "deduped_run_past_window"]
    tp.reset_path_counts()
    uploaded = 0
    for case in cases:
        n_reads, _, deduped, max_targets, _, _, ran = CASES[case]
        host = _records(case)
        uploaded += len(host[0])
        if ran == "host":
            uploaded += len(tp.plan_records(*host, C, deduped=deduped)[0])
        tp.profile_arrays(
            to_port(ProfileOptions()), to_port(toy_db),
            NAMES, LENGTHS, *host, n_reads,
            len(host[0]), READ_LEN, device=CPU,
            engine=to_port(EngineOptions(phase_log=False)), deduped=deduped,
            max_targets=max_targets)
    hosts = sum(CASES[case][-1] == "host" for case in cases)
    assert tp.work_counts["calls"] == len(cases)
    assert tp.work_counts["host_plans"] == hosts == 2
    assert tp.work_counts["device_plans"] == len(cases) - hosts
    assert tp.work_counts["h2d_bytes"] == (uploaded * 12 + len(cases)
                                           * (tables + C + 8))
