"""init_ms.core: per-call host state (`ProfileState.init_contigs`, `tensorize`)
and the contig and taxonomy tables put on the device, summed over the traced
window's `slimm.init` spans (the program's own, harness/spans.py) and taken
over the window's profile_arrays calls (`pipeline.work_counts["calls"]`), in
ms.  None where the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "init")
