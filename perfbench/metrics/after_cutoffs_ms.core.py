"""after_cutoffs_ms.core: the mean host-clock time from the program's
"cutoffs" mark to profile_arrays' return: pass B, packing, the fetch and
_finalize_state.  Traced run."""


def read(run):
    d = [c.t1 - c.t_cut for c in run.calls if c.t_cut is not None]
    if run.traffic["entry"] != "arrays" or not d:
        return None
    return sum(d) / len(d) * 1e3
