# Copied from slimm_tpu/misc_compat.py (the port imports nothing of slimm_tpu).
"""Reference utility-surface parity: the misc.hpp helpers outside the
profiler's live call graph.

The reference ships several helpers that its current flow never calls —
the CIGAR alignment score (misc.hpp:323-338), the taxonomy-tree-walk LCA
over `TNodes` (misc.hpp:368-413, 441-455; superseded by the lineage-matrix
LCA the engine vectorizes), the running-stats templates
(misc.hpp:274-320), and the `ti|` / `kraken:taxid|` header-field locator
(misc.hpp:425-439, 524-538; the preprocessing merge writes such headers,
tools/preprocess.py).  They are part of the reference's API surface, so
they are provided here with faithful semantics — including the quirks —
for completeness and for external callers; the engine itself does not use
them, mirroring the reference.

Faithfulness notes (each locked by tests/test_misc_compat.py):
  * `median` replicates the reference's arithmetic exactly: for EVEN
    sizes it returns the upper-middle element v[n] with NO averaging, and
    for ODD sizes it returns (v[n] + v[n+1]) / 2.0 (misc.hpp:276-283 —
    the conventional definitions are swapped; kept as-is).  The reference
    uses nth_element, which leaves v[n+1] unspecified; this port uses the
    sorted order (a deterministic refinement of the same contract).
  * integer inputs keep C++ integer-division semantics in `mean` /
    `variance` (T is the element type).
  * `get_lca_tree` returns 0 when the walk leaves the node table
    (misc.hpp:404-407); ties follow std::set ascending order.
"""

from __future__ import annotations

import math
import re
import sys

# -- running stats (misc.hpp:274-320) ----------------------------------------


def _int_inputs(values) -> bool:
    return all(isinstance(v, int) and not isinstance(v, bool)
               for v in values)


def mean(values):
    """Sum / size with the element type's division (misc.hpp:285-289)."""
    total = sum(values)
    n = len(values)
    return total // n if _int_inputs(values) else total / n


def median(values):
    """misc.hpp:274-283, quirks preserved: even size → v[n] (upper middle,
    no averaging); odd size → (v[n] + v[n+1]) / 2.0 cast back to T."""
    v = sorted(values)
    n = len(v) // 2
    if n * 2 == len(v):
        return v[n]
    out = (v[n] + v[n + 1]) / 2.0
    return int(out) if _int_inputs(values) else out


def variance(values, m=None):
    """Population variance about the (optionally given) mean
    (misc.hpp:291-307); integer T keeps integer division."""
    if m is None:
        m = mean(values)
    total = sum((v - m) * (v - m) for v in values)
    n = len(values)
    return total // n if _int_inputs(values) else total / n


def std_dev(values, m=None):
    """sqrt(variance) (misc.hpp:309-319); always float (C++ sqrt)."""
    return math.sqrt(variance(values, m))


# -- CIGAR alignment score (misc.hpp:323-338) ---------------------------------

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def calculate_alignment_score(cigar, edit_distance: int,
                              read_len: int) -> float:
    """(edit distance + inserted/deleted base counts) / read length.

    `cigar` is a CIGAR string ("3M1I2D") or an iterable of (op, count)
    pairs, mirroring SeqAn's CigarElement sequence."""
    score = float(edit_distance)
    if isinstance(cigar, str):
        ops = [(op, int(n)) for n, op in _CIGAR_RE.findall(cigar)]
    else:
        ops = [(op, int(n)) for op, n in cigar]
    for op, n in ops:
        if op in ("D", "I"):
            score += float(n)
    return score / read_len


# -- taxonomy-tree-walk LCA over TNodes (misc.hpp:368-413, 441-455) -----------
#
# TNodes = {taxid: (parent_taxid, rank_name)} — the builder's nodes.dmp
# form.  The engine's LCA is the vectorized lineage-matrix one
# (engine/pipeline.py); this is the reference's legacy parent-pointer walk.


def get_lca_tree(taxon_ids, nodes, valid_taxon_ids=None):
    """Pairwise parent-walk LCA (misc.hpp:368-413).

    Filters to valid_taxon_ids (defaults to taxon_ids itself,
    misc.hpp:441-444), then repeatedly replaces the two smallest members
    with their common ancestor; returns 0 the moment a walk escapes the
    node table."""
    if valid_taxon_ids is None:
        valid_taxon_ids = taxon_ids
    parents = sorted(set(t for t in taxon_ids if t in set(valid_taxon_ids)))
    if not parents:
        # the reference dereferences begin() of an empty set (UB); be kind
        return 0
    while len(parents) > 1:
        t1, t2 = parents[0], parents[1]
        found = False
        while t1 in nodes and t1 != 0:
            t2 = parents[1]
            while t2 in nodes and t2 != 0:
                if t1 == t2:
                    found = True
                    break
                nxt = nodes[t2][0]
                if nxt == t2:
                    break  # root self-parent (taxid 1 in nodes.dmp): chain
                    # top.  The reference loop assumes chains end at 0 or
                    # leave the table and would spin forever here
                    # (misc.hpp:386-395) — terminating is the one
                    # divergence, in never-called code.
                t2 = nxt
            if found:
                break
            nxt = nodes[t1][0]
            if nxt == t1:
                break
            t1 = nxt
        if not found:
            return 0
        parents = sorted(set(parents[2:]) | {t1})
    return parents[0]


def get_lca_tree_list(taxon_ids, nodes):
    """Vector overload (misc.hpp:448-455): singleton short-circuits."""
    s = set(taxon_ids)
    if len(s) == 1:
        return taxon_ids[0]
    return get_lca_tree(s, nodes)


# -- ti| / kraken:taxid| header locator (misc.hpp:425-439, 524-538) -----------


def get_taxon_id(accession: str, id_type: str):
    """Find the '|'-separated field equal to id_type; the taxid is the
    NEXT field (misc.hpp:425-439).  Returns (found, position)."""
    chunks = accession.split("|")
    for i, c in enumerate(chunks):
        if c == id_type:
            return True, i + 1
    return False, 0


def get_taxon_id_pos(accession: str) -> int:
    """Position of the taxid field for SLIMM-style ('ti|') or
    kraken-style ('kraken:taxid|') sequence names; exits like the
    reference when neither is present (misc.hpp:524-538)."""
    found, pos = get_taxon_id(accession, "ti")
    if found:
        return pos
    found, pos = get_taxon_id(accession, "kraken:taxid")
    if found:
        return pos
    print("Unable to find a way to resolve taxon id associated with "
          "references.\nMake sure you used a set of references provided "
          "with SLIMM\nor generated by the preprocessing script.",
          file=sys.stderr)
    raise SystemExit(1)
