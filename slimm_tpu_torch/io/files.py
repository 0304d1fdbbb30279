# Copied from slimm_tpu/io/files.py (the port imports nothing of slimm_tpu).
"""File discovery and output path construction.

Mirrors the reference's helpers (src/file_helper.hpp:48-123, slimm.hpp:306-326):
directory scan for *.sam / *.bam, and the `<prefix><stem><suffix>.tsv` output
path rule where an empty prefix file-name component falls back to the input
file's stem.
"""

from __future__ import annotations

import os
import sys


def _is_sam_or_bam(name: str) -> bool:
    # full_file_name.find(".sam") == find_last_of(".") — i.e. the final
    # extension is exactly .sam or .bam (file_helper.hpp:73-74).
    dot = name.rfind(".")
    if dot == -1:
        return False
    return name[dot:] in (".sam", ".bam")


def get_bam_files_in_directory(directory: str) -> list[str]:
    paths = []
    for entry in os.listdir(directory):
        if entry.startswith("."):
            continue
        full = directory + "/" + entry
        if os.path.isdir(full):
            continue
        if _is_sam_or_bam(full):
            paths.append(full)
    return paths


def collect_bam_files(input_path: str, is_directory: bool,
                      verbose: bool = False) -> list[str]:
    """Single file or -d directory scan (slimm.hpp:306-326)."""
    if is_directory:
        paths = get_bam_files_in_directory(input_path)
        if verbose:
            print(f"{len(paths)} SAM/BAM Files found under the directory: "
                  f"{input_path}!", file=sys.stderr)
        return paths
    if os.path.exists(input_path):
        return [input_path]
    print(f"{input_path} is not a file use -d option for a directory.",
          file=sys.stderr)
    raise SystemExit(1)


def get_file_name(path: str) -> str:
    found = max(path.rfind("/"), path.rfind("\\"))
    return path[found + 1:]


def get_directory(path: str) -> str:
    found = max(path.rfind("/"), path.rfind("\\"))
    return path[:found] if found != -1 else ""


def tsv_file_name(output_prefix: str, input_path: str, decor_suffix: str) -> str:
    """Output TSV path (file_helper.hpp:100-123)."""
    dir_name = get_directory(output_prefix)
    file_name = get_file_name(output_prefix)
    if file_name == "":
        file_name = get_file_name(input_path)
        dot = file_name.rfind(".")
        if dot != -1 and file_name[dot:] in (".sam", ".bam"):
            file_name = file_name[:dot]
    return dir_name + "/" + file_name + decor_suffix + ".tsv"
