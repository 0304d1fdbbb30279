"""host_cpu_ms.file: the process's CPU time, user and system, every thread (the
native decoder's included), across the window's profile_file calls
(`pipeline.work_counts["cpu_s"]`, getrusage at each outermost call's entry
and exit), per file, in ms.  None where the program has no such counter."""

from harness import spans


def read(run):
    counts, n = spans.work_counts(), spans.calls()
    if run.traffic["entry"] != "file" or not n:
        return None
    return counts["cpu_s"] / n * 1e3
