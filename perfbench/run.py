"""The benchmark of slimm_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are the entries of BENCHMARK.json and the files they name
(harness/spec.py).  The run makes its database and samples from the seed,
warms up, profiles for `--seconds`, checks a sample of the answers against
the NumPy reference (reference/slimm.py) and prints one JSON line: the
end-to-end metrics with `--trace 0`, the per-layer metrics (from a
torch.profiler window) with `--trace 1`.  It exits 1 without a result when
the cell's CUDA devices are missing or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]
# every build and kernel cache of the run inside the checkout, at fixed
# paths (slimm_tpu_torch builds its own libraries into its _build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".perfbench_cache", sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import guards
    from harness.cell import run_cell
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    import slimm_tpu_torch  # noqa: F401  the system under test, or no run
    missing = guards.cards_missing(cell.chips)
    if missing:
        print(f"[perfbench] {missing}: no result", file=sys.stderr)
        return 1
    result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda",
                      t_start=T_START)
    found = guards.forbidden_modules()
    if found:
        print(f"[perfbench] loaded in this process: {', '.join(found)}: "
              "no result", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
