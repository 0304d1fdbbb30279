# Copied from slimm_tpu/io/fasta.py (the port imports nothing of slimm_tpu).
"""Streaming FASTA reader (reference: SeqAn SeqFileIn used at
slimm_build.cpp:151-170).  Supports plain and gzip-compressed files."""

from __future__ import annotations

import gzip


def _open_text(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path: str):
    """Yield (id_line, sequence) records.  id_line excludes the '>'."""
    name = None
    chunks: list[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def read_fasta_ids(path: str):
    """Yield only the id lines (fast accession scan, slimm_build.cpp:151-170)."""
    with _open_text(path) as f:
        for line in f:
            if line.startswith(">"):
                yield line[1:].rstrip("\n").rstrip("\r")
