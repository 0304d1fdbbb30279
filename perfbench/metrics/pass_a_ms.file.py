"""pass_a_ms.file: the overlap path's work per piece while the decoder runs:
each piece's upload and its pass A's enqueue, summed over the traced
window's `slimm.upload` and `slimm.pass_a` spans (the program's own,
harness/spans.py) and taken over the window's files
(`pipeline.work_counts["calls"]`), in ms.  None where the program opens no
such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "file":
        return None
    return spans.ms_per_call(run, "upload", "pass_a")
