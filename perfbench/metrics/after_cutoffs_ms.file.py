"""after_cutoffs_ms.file: the mean host-clock time from the program's
"cutoffs" mark (after the decoder's end of file and pass A) to the written
TSV: pass B, packing, the fetch, _finalize_state and the report.  Traced
run."""


def read(run):
    d = [c.t1 - c.t_cut for c in run.calls if c.t_cut is not None]
    if run.traffic["entry"] != "file" or not d:
        return None
    return sum(d) / len(d) * 1e3
