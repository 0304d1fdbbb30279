"""propagate_ms.core: the ancestor propagation inside the host's finalize
(`ProfileState.propagate_counts`: the native C++ `stpu_propagate_run` past
NATIVE_PROPAGATE_MIN LCA taxa, else the Python loop), summed over the
traced window's `slimm.propagate` spans (the program's own,
harness/spans.py) and taken over the window's profile_arrays calls
(`pipeline.work_counts["calls"]`), in ms.  None where the program opens no
such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "propagate")
