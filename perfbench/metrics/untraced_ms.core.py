"""untraced_ms.core: the time of each `slimm.profile` span (a profile_arrays
call) that none of its direct child spans covers, summed over the traced
window and taken over its calls, in ms: what the stage spans leave unnamed.
None where the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.untraced_ms_per_call(run)
