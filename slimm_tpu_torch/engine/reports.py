"""TSV/CSV report writers (reference slimm.hpp:733-943).

Copied from slimm_tpu/engine/reports.py, whose package imports jax.

Row content is produced by the shared ProfileState (slimm_tpu.state); this
module only handles files and headers.  Header strings replicate the
reference byte-for-byte, including its spelling ("accesion", "linage").
"""

from __future__ import annotations

import os
import sys

from ..io.files import tsv_file_name
from ..state import ProfileState


def _open_out(path: str):
    # the reference's ofstream fails silently on a missing directory
    # (slimm.hpp:736); we create it instead
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return open(path, "wt")

PROFILE_HEADER = "taxa_level\ttaxa_id\tlinage\tabundance\tread_count\n"

RAW_HEADER = (
    "accesion\ttaxaid\tname\treads_count\tabundance\tuniq1_abundance\t"
    "uniq2_abundance\tgenome_length\tuniq1_reads_count\tuniq2_reads_count\t"
    "bins_count\tbins_count(>0)\tuniq1_bins_count(>0)\tuniq2_bins_count(>0)\t"
    "coverage_depth\tuniq1_coverage_depth\tuniq2_coverage_depth\t"
    "coverage(%)\tuniq1_coverage(%)\tuniq2_coverage(%)\n")


def write_abundance(state: ProfileState, output_prefix: str,
                    input_path: str) -> str:
    path = tsv_file_name(output_prefix, input_path, "_profile")
    with _open_out(path) as f:
        f.write(PROFILE_HEADER)
        for row in state.abundance_rows():
            f.write("\t".join(row) + "\n")
    if state.options.verbose:
        # per-rank summary (slimm.hpp:836-840; typo "bellow" is verbatim);
        # setw(4)/setw(15) right-alignment, no trailing newline
        from ..state import fmt_float
        from ..taxonomy import considered_ranks, rank_name
        rank = considered_ranks(state.options.rank)[1]
        sys.stderr.write(
            f"\n{state.rank_row_count:>4}{rank_name(rank):>15} "
            f"({state.rank_failed_count} bellow cutoff i.e. "
            f"{fmt_float(state.options.abundance_cut_off)})")
    return path


def write_raw_stat(state: ProfileState, output_prefix: str,
                   input_path: str) -> str:
    path = tsv_file_name(output_prefix, input_path, "_raw")
    with _open_out(path) as f:
        f.write(RAW_HEADER)
        for row in state.raw_rows():
            f.write("\t".join(row) + "\n")
    return path


def write_coverage(state: ProfileState, output_prefix: str,
                   input_path: str) -> list[str]:
    paths = [tsv_file_name(output_prefix, input_path, suffix)
             for suffix in ("_coverage", "_uniq_coverage", "_uniq_coverage2")]
    for path, rows in zip(paths, state.coverage_rows()):
        with _open_out(path) as f:
            for row in rows:
                f.write(row + "\n")
    return paths
