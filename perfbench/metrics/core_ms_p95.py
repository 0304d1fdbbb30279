"""core_ms_p95: the 95th percentile (linear) of the time of every
profile_arrays call in the window, from the call to its returned
ProfileState (host clock)."""

import numpy as np


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return float(np.percentile([c.t1 - c.t0 for c in run.calls], 95)) * 1e3
