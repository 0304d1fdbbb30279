"""decode_wait_ms.file: the host waiting on the native decoder: the stream
reader's opening (its read-length sample) and each `next_piece` of the
overlap path's piece loop, summed over the traced window's
`slimm.decode_wait` spans (the program's own, harness/spans.py) and taken
over the window's files (`pipeline.work_counts["calls"]`), in ms.  None
where the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "file":
        return None
    return spans.ms_per_call(run, "decode_wait")
