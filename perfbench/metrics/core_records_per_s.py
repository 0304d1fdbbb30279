"""core_records_per_s: the alignment records of every profile_arrays call
completed in the window, over the window's seconds (host clock, from the
window's start to the last call's return)."""


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return sum(c.records for c in run.calls) / run.window_s
