"""pass_b_ms.core: pass B's and the packing's enqueue on the host
(`_core_after_a` after its "cutoffs" mark), summed over the traced window's
`slimm.pass_b` spans (the program's own, harness/spans.py) and taken over
the window's profile_arrays calls (`pipeline.work_counts["calls"]`), in ms.
None where the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "pass_b")
