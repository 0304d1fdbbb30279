# Copied from slimm_tpu/tools/collect.py, with pandas replaced by the csv
# module (the GPU machine has no pandas); the output bytes are the same.
"""Multi-sample profile merge (reference collect_profiles.py, Python-3 port).

Faithful behavior notes (collect_profiles.py:17-61): rows are keyed by the
LINEAGE column; the "name" output column actually carries the abundance
value of the last file that mentioned the taxon (row[3]); the per-sample
columns carry the READ COUNT (row[4]); sort is descending by level, then
lineage, then the sample columns.
"""

from __future__ import annotations

import csv


def _sample_name(path: str) -> str:
    """File stem between the last '/' and the last '.'"""
    return path[path.rfind("/") + 1:path.rfind(".")]


def collect_profiles(profile_paths: list[str],
                     output_path: str = "merged_profile.tsv") -> str:
    samples = [_sample_name(p) for p in profile_paths]
    header = ["level", "taxid", "name", "linage"] + samples

    # union of taxa across every profile, keyed by lineage string; the
    # "name" slot holds the LAST-seen abundance (reference quirk)
    by_lineage: dict[str, list] = {}
    for path in profile_paths:
        with open(path) as f:
            next(f)
            for line in f:
                row = line.rstrip("\n").split("\t")
                by_lineage[row[2]] = [row[0], row[1], row[3], row[2]]
    for key in by_lineage:
        by_lineage[key] = by_lineage[key] + len(samples) * ["0.0"]

    # zero-filled read-count matrix, one column per sample
    for k, path in enumerate(profile_paths):
        with open(path) as f:
            next(f)
            for line in f:
                row = line.rstrip("\n").split("\t")
                by_lineage[row[2]][4 + k] = row[4]

    # every column holds strings: pandas' sort_values(level, linage,
    # samples..., ascending=False) is a descending sort of those tuples
    # (the lineage keys are unique, so ties never reach the sample columns)
    rows = sorted(by_lineage.values(), key=lambda r: (r[0], *r[3:]),
                  reverse=True)
    with open(output_path, "w", newline="") as f:
        out = csv.writer(f, delimiter="\t", quoting=csv.QUOTE_MINIMAL,
                         lineterminator="\n")
        out.writerow(header)
        out.writerows(rows)
    return output_path
