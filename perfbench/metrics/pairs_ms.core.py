"""pairs_ms.core: the children sets read from the fetched pair presence
inside the host's finalize (`pipeline.pairs_into`: the bitpacked
(contig x code) words unpacked, the (LCA, contig) pairs made unique, a set
filled per distinct LCA), summed over the traced window's `slimm.pairs`
spans (the program's own, harness/spans.py) and taken over the window's
profile_arrays calls (`pipeline.work_counts["calls"]`), in ms.  None where
the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "pairs")
