"""The import guard, and what the reference and the harness load."""

import os
import shutil
import subprocess
import sys

import pytest

from harness import guards
from harness.spec import BENCH_DIR, ROOT


@pytest.mark.parametrize("loaded,found", [
    (["slimm_tpu_torch", "slimm_tpu_torch.engine.pipeline", "torch"], []),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["slimm_tpu", "slimm_tpu.engine"], ["slimm_tpu"]),
    (["slimm_tpu.ops.hist", "slimm_tpu_torch"], ["slimm_tpu"]),
    (["bench", "chip_smoke"], ["bench", "chip_smoke"]),
    (["slimm_tpu_x", "jax_free", "benchmark"], []),
])
def test_guard_compares_whole_top_level_names(loaded, found):
    assert guards.forbidden_modules(loaded) == found


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_reference_loads_nothing_of_the_program_or_jax():
    out = _python(
        "import sys; sys.path.insert(0, 'perfbench')\n"
        "from harness import generate\n"
        "from reference import slimm\n"
        "import json\n"
        "cfg = dict(json.load(open('perfbench/configs/genus50.json')),"
        " n_contigs=20)\n"
        "db = generate.make_database(cfg, 1)\n"
        "s = generate.make_sample(cfg, db, 1, 0, 5000)\n"
        "a = slimm.profile(s['read_id'], s['rid'], s['pos'],"
        " contig_names=db['names'], contig_lengths=db['lengths'],"
        " ac__taxid=db['ac__taxid'], taxid__name=db['taxid__name'],"
        " options=dict(bin_width=0, min_reads=0, rank='species',"
        " cov_cut_off=0.95, abundance_cut_off=0.01), avg_read_length=150)\n"
        "assert a['rows']\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'slimm_tpu_torch', 'slimm_tpu', 'jax',"
        " 'jaxlib', 'torch'}))\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    """Everything run.py imports on its way to a run, without a card."""
    out = _python(
        "import runpy, sys\n"
        "sys.argv = ['perfbench/run.py', '--workload', 'genus50.core',"
        " '--seed', '1', '--seconds', '1']\n"
        "try:\n"
        "    runpy.run_path('perfbench/run.py', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "from harness import cell, guards, compare, trace  # noqa\n"
        "import slimm_tpu_torch.engine.pipeline  # noqa\n"
        "print(guards.forbidden_modules())\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "genus50.core",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "genus50.core",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "slimm_tpu_torch" in out.stderr
