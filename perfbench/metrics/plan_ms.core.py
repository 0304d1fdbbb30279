"""plan_ms.core: the records' plan, summed over the traced window's
`slimm.plan` spans (the program's own, harness/spans.py) and taken over the
window's profile_arrays calls (`pipeline.work_counts["calls"]`), in ms.
None where the program opens no such span.

The plan is `plan_uploaded`: on the card, after the upload, with one host
read (sortedness and the longest run of one read's records; a sort on the
card where they are unsorted).  The host `plan_records` (sort, first-hit
dedup, `seg_plan`, and the records uploaded again) runs only for raw
records in which some read has more than MAX_WINDOW + 1 records, which
samples of many hits a read bring back (`work_counts["host_plans"]`)."""

from harness import spans


def read(run):
    if run.traffic["entry"] != "arrays":
        return None
    return spans.ms_per_call(run, "plan")
