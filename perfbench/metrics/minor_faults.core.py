"""minor_faults.core: the process's minor page faults across the window's
profile_arrays calls (`pipeline.work_counts`, getrusage at each outermost
call's entry and exit), per call.  None where the program has no such
counter."""

from harness import spans


def read(run):
    counts, n = spans.work_counts(), spans.calls()
    if run.traffic["entry"] != "arrays" or not n:
        return None
    return counts["minor_faults"] / n
