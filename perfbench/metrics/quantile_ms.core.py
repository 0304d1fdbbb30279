"""quantile_ms.core: the coverage-quantile walks (`state.quantile_cut_off`,
cc and ucc from the cutoffs' `_cutoffs` and again from finalize's
`compute_valid_refs`), summed over the traced window's `slimm.quantile`
spans (the program's own, harness/spans.py) and taken over the window's
profile_arrays calls (`pipeline.work_counts["calls"]`), in ms.  None where
the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "quantile")
