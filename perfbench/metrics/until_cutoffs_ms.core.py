"""until_cutoffs_ms.core: the mean host-clock time from a profile_arrays
call to the program's "cutoffs" mark (pipeline.host_marks, right after the
one host sync of the cutoffs): host plan, upload, pass A, contig sums and
the cutoffs.  Traced run."""


def read(run):
    d = [c.t_cut - c.t0 for c in run.calls if c.t_cut is not None]
    if run.traffic["entry"] != "arrays" or not d:
        return None
    return sum(d) / len(d) * 1e3
