# Copied from slimm_tpu/taxonomy.py (the port imports nothing of slimm_tpu).
"""Taxonomic rank model and accession parsing.

TPU-native re-design of the reference's rank enum and lineage-vector layout
(reference: src/misc.hpp:24-75, src/misc.hpp:415-422).  The lineage of a
reference contig is a dense vector of LINEAGE_LENGTH taxon ids indexed by
rank level: index 0 = strain ... 7 = superkingdom (src/misc.hpp:4).
"""

from __future__ import annotations

import re
from enum import IntEnum

LINEAGE_LENGTH = 8


class Rank(IntEnum):
    """Rank levels; numeric values match the reference enum (misc.hpp:24-35)."""

    STRAIN = 0
    SPECIES = 1
    GENUS = 2
    FAMILY = 3
    ORDER = 4
    CLASS = 5
    PHYLUM = 6
    SUPERKINGDOM = 7
    INTERMEDIATE = 8


_STR_TO_RANK = {
    "strain": Rank.STRAIN,
    "species": Rank.SPECIES,
    "genus": Rank.GENUS,
    "family": Rank.FAMILY,
    "order": Rank.ORDER,
    "class": Rank.CLASS,
    "phylum": Rank.PHYLUM,
    "superkingdom": Rank.SUPERKINGDOM,
}

_RANK_TO_STR = {
    Rank.STRAIN: "strain",
    Rank.SPECIES: "species",
    Rank.GENUS: "genus",
    Rank.FAMILY: "family",
    Rank.ORDER: "order",
    Rank.CLASS: "class",
    Rank.PHYLUM: "phylum",
    Rank.SUPERKINGDOM: "superkingdom",
    Rank.INTERMEDIATE: "intermidiate",  # sic — reference spelling (misc.hpp:61)
}

_RANK_TO_SHORT = {
    Rank.STRAIN: "r",
    Rank.SPECIES: "s",
    Rank.GENUS: "g",
    Rank.FAMILY: "f",
    Rank.ORDER: "o",
    Rank.CLASS: "c",
    Rank.PHYLUM: "p",
    Rank.SUPERKINGDOM: "k",
    Rank.INTERMEDIATE: "i",
}

#: rank strings accepted by the profiler CLI (reference slimm.hpp:53-60)
RANK_LIST = [
    "strains",
    "species",
    "genus",
    "family",
    "order",
    "class",
    "phylum",
    "superkingdom",
]


def to_rank(name: str) -> Rank:
    """String → rank level; unknown strings map to INTERMEDIATE (misc.hpp:37-48)."""
    return _STR_TO_RANK.get(name, Rank.INTERMEDIATE)


def rank_name(rank: int) -> str:
    """Rank level → long name (misc.hpp:51-62)."""
    return _RANK_TO_STR.get(Rank(rank) if 0 <= rank <= 8 else Rank.INTERMEDIATE,
                            "intermidiate")


def rank_short(rank: int) -> str:
    """Rank level → one-letter prefix used in lineage strings (misc.hpp:64-75)."""
    return _RANK_TO_SHORT.get(Rank(rank) if 0 <= rank <= 8 else Rank.INTERMEDIATE,
                              "i")


# Accession parsing: first token when splitting the sequence name on
# whitespace, '.', or '|' (reference misc.hpp:415-422).
_ACC_DELIM = re.compile(r"[ \t\r\n\v\f.|]")


def accession_id(sequence_name: str) -> str:
    """First chunk of a FASTA/BAM sequence name split on whitespace/'.'/'|'.

    Mirrors get_accession_id (misc.hpp:415-422): SeqAn's strSplit drops empty
    chunks, so leading delimiters are skipped.
    """
    for chunk in _ACC_DELIM.split(sequence_name):
        if chunk:
            return chunk
    return ""


def considered_ranks(rank: str) -> list[int]:
    """Ranks considered for the abundance report (reference slimm.hpp:498-514).

    "all" → [7..0]; "superkingdom" → [7, 7] (the reference pushes a single
    element and then reads considered_ranks[1] out of bounds in
    write_abundance — we define the sane behavior: parent == rank);
    otherwise → [rank+1, rank].
    """
    if rank == "all":
        return list(range(7, -1, -1))
    if rank == "superkingdom":
        return [int(Rank.SUPERKINGDOM), int(Rank.SUPERKINGDOM)]
    r = int(to_rank(rank))
    return [r + 1, r]
