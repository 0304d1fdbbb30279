"""upload_ms.core: the records' host-to-device copies (`Grid.shards`: the int32
copies and the uploads), summed over the traced window's `slimm.upload`
spans (the program's own, harness/spans.py) and taken over the window's
profile_arrays calls (`pipeline.work_counts["calls"]`), in ms.  None where
the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "upload")
