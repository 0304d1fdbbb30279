"""plan_ms.core: the host plan before the upload (`plan_records`: the
sortedness check, the sort or dedup, `seg_plan`), summed over the traced
window's `slimm.plan` spans (the program's own, harness/spans.py) and taken
over the window's profile_arrays calls (`pipeline.work_counts["calls"]`), in
ms.  None where the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "plan")
