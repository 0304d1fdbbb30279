"""report_ms.file: the TSV written (`reports.write_abundance`), summed over the
traced window's `slimm.report` spans (the program's own, harness/spans.py)
and taken over the window's files (`pipeline.work_counts["calls"]`), in ms.
None where the program opens no such span."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "file":
        return None
    return spans.ms_per_call(run, "report")
