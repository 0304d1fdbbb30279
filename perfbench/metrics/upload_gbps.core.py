"""upload_gbps.core: the bytes of every host-to-device copy the program issued
in the window (`pipeline.work_counts["h2d_bytes"]`: the records, the tables,
the validity mask, the cutoffs) over the device time of the trace's `Memcpy
HtoD` events, in GB/s.  None on the CPU or where the program has no such
counter."""

from harness import spans


def _htod(name: str) -> bool:
    return name.startswith("Memcpy HtoD")


def read(run):
    t, counts = run.trace, spans.work_counts()
    if (run.traffic["entry"] != "arrays" or t is None or not counts
            or not counts.get("h2d_bytes")):
        return None
    seconds = t.device_time_s(_htod)
    if seconds <= 0:
        return None
    return counts["h2d_bytes"] / seconds / 1e9
