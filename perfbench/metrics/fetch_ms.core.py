"""fetch_ms.core: the fetch of the packed vector, which waits for pass B
(`_finalize_state`), summed over the traced window's `slimm.fetch` spans
(the program's own, harness/spans.py) and taken over the window's
profile_arrays calls (`pipeline.work_counts["calls"]`), in ms.  None where
the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "fetch")
