"""cutoffs_ms.core: the merges of pass A, the contig sums, the one host sync
and the host cutoffs (`_core_after_a` up to its "cutoffs" mark), summed over
the traced window's `slimm.cutoffs` spans (the program's own,
harness/spans.py) and taken over the window's profile_arrays calls
(`pipeline.work_counts["calls"]`), in ms.  None where the program opens no
such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "cutoffs")
