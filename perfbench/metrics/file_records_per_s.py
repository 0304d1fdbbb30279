"""file_records_per_s: the alignment records of every file profiled and
written as a TSV in the window, over the window's seconds (host clock)."""


def read(run):
    if run.traffic["entry"] != "file":
        return None
    return sum(c.records for c in run.calls) / run.window_s
