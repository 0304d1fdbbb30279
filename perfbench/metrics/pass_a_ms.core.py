"""pass_a_ms.core: pass A's enqueue on the host (`_pass_a_shards` in
`fused_profile_shards`), summed over the traced window's `slimm.pass_a`
spans (the program's own, harness/spans.py) and taken over the window's
profile_arrays calls (`pipeline.work_counts["calls"]`), in ms. None where
the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "pass_a")
