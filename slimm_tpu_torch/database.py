# Copied from slimm_tpu/database.py (the port imports nothing of slimm_tpu).
"""Taxonomy database: model, persistence, builder, tensorization.

Reference model (src/misc.hpp:77-100): `slimm_database` holds two maps,
  ac__taxid   : accession → [8] taxon-id lineage (index 0 = strain ... 7 = superkingdom)
  taxid__name : taxon id → (rank, scientific name)
persisted with cereal's binary archive (misc.hpp:178-195).  This module
implements a byte-compatible reader/writer for that format (so existing .sldb
files interoperate), the slimm_build construction pipeline
(slimm_build.cpp:151-346), a fast columnar .npz cache, and the dense-tensor
form the TPU engine consumes (lineage matrix + taxid remap).

Validation scope: the reference's SeqAn/cereal submodules are EMPTY in this
checkout (.gitmodules pins them, include/cereal has no sources) and the
environment has no network, so the reference binary cannot be built and no
reference-written .sldb exists to diff against.  The layout is instead locked
three ways: (a) against the cereal 1.x BinaryOutputArchive spec, (b) by an
independent C++ reimplementation round-trip (native/slimm_native.cpp
stpu_sldb_* — written from the cereal spec, not from this module), and
(c) by committed golden bytes (tests/test_database.py).
"""

from __future__ import annotations

import os
import struct
import sys
from dataclasses import dataclass, field

import numpy as np

from .config import BuildOptions
from .taxonomy import LINEAGE_LENGTH, Rank, accession_id, to_rank


@dataclass
class SlimmDatabase:
    ac__taxid: dict = field(default_factory=dict)    # str → list[int] (len 8)
    taxid__name: dict = field(default_factory=dict)  # int → (rank:int, name:str)

    # -- cereal-binary .sldb persistence --------------------------------------
    #
    # cereal BinaryOutputArchive layout (little-endian, no headers):
    #   unordered_map  : uint64 count, then (key, value) pairs
    #   std::string    : uint64 size + bytes
    #   vector<uint32> : uint64 size + raw uint32 data
    #   tuple<enum,str>: int32 enum (underlying int), then string
    # Verified against the cereal 1.x spec used by the reference's vendored
    # submodule (misc.hpp:13-18, .gitmodules).

    def save_sldb(self, path: str) -> None:
        out = bytearray()
        out += struct.pack("<Q", len(self.ac__taxid))
        for acc, lineage in self.ac__taxid.items():
            raw = acc.encode()
            out += struct.pack("<Q", len(raw))
            out += raw
            out += struct.pack("<Q", LINEAGE_LENGTH)
            out += np.asarray(lineage, "<u4").tobytes()
        out += struct.pack("<Q", len(self.taxid__name))
        for taxid, (rank, name) in self.taxid__name.items():
            raw = name.encode()
            out += struct.pack("<IiQ", taxid, int(rank), len(raw))
            out += raw
        with open(path, "wb") as f:
            f.write(bytes(out))

    @classmethod
    def load_sldb(cls, path: str) -> "SlimmDatabase":
        with open(path, "rb") as f:
            data = f.read()
        db = cls()
        off = 0
        (n,) = struct.unpack_from("<Q", data, off)
        off += 8
        for _ in range(n):
            (klen,) = struct.unpack_from("<Q", data, off)
            off += 8
            acc = data[off:off + klen].decode()
            off += klen
            (vlen,) = struct.unpack_from("<Q", data, off)
            off += 8
            lineage = np.frombuffer(data, "<u4", int(vlen), off).tolist()
            off += 4 * vlen
            db.ac__taxid[acc] = lineage
        (m,) = struct.unpack_from("<Q", data, off)
        off += 8
        for _ in range(m):
            taxid, rank, slen = struct.unpack_from("<IiQ", data, off)
            off += 16
            name = data[off:off + slen].decode()
            off += slen
            db.taxid__name[taxid] = (rank, name)
        return db

    # -- columnar cache (fast load path for large DBs) ------------------------

    def save_npz(self, path: str) -> None:
        accs = sorted(self.ac__taxid)
        lineage = np.asarray([self.ac__taxid[a] for a in accs], np.uint32)
        if lineage.size == 0:
            lineage = lineage.reshape(0, LINEAGE_LENGTH)
        tids = sorted(self.taxid__name)
        ranks = np.asarray([self.taxid__name[t][0] for t in tids], np.int32)
        names = np.asarray([self.taxid__name[t][1] for t in tids], dtype=object)
        np.savez_compressed(
            path, accessions=np.asarray(accs, dtype=object), lineage=lineage,
            taxids=np.asarray(tids, np.uint32), ranks=ranks, names=names,
            allow_pickle=True)

    @classmethod
    def load_npz(cls, path: str) -> "SlimmDatabase":
        z = np.load(path, allow_pickle=True)
        db = cls()
        lineage = z["lineage"]
        for i, acc in enumerate(z["accessions"]):
            db.ac__taxid[str(acc)] = lineage[i].tolist()
        for tid, rank, name in zip(z["taxids"], z["ranks"], z["names"]):
            db.taxid__name[int(tid)] = (int(rank), str(name))
        return db

    @classmethod
    def load(cls, path: str) -> "SlimmDatabase":
        """Load a database, preferring a fresh .npz cache next to the .sldb."""
        cache = path + ".npz"
        if os.path.exists(cache) and (not os.path.exists(path) or
                                      os.path.getmtime(cache) >= os.path.getmtime(path)):
            return cls.load_npz(cache)
        if path.endswith(".npz"):
            return cls.load_npz(path)
        return cls.load_sldb(path)


# -- builder (slimm_build semantics) ------------------------------------------


def _parse_nodes_line(line: str):
    # "taxid\t|\tparent\t|\trank\t|\t..." (slimm_build.cpp:295-305)
    parts = line.split("\t|\t")
    if len(parts) < 3:
        return None
    try:
        taxid = int(parts[0].strip())
        parent = int(parts[1].strip())
    except ValueError:
        return None
    return taxid, parent, parts[2]


def _parse_names_line(line: str):
    # only "scientific name" rows (slimm_build.cpp:310-322)
    if "scientific name" not in line:
        return None
    parts = line.split("\t|\t")
    if len(parts) < 2:
        return None
    try:
        taxid = int(parts[0].strip())
    except ValueError:
        return None
    return taxid, parts[1]


def stream_acc2taxid_batches(path: str, batch_size: int):
    """Yield {accession: taxid} dicts of <= batch_size mappings
    (slimm_build.cpp:175-195): col1 = accession, col3 = taxid; a failed
    integer parse yields 0 (C++11 stream extraction)."""
    batch: dict[str, int] = {}
    count = 0
    with open(path, "rt") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if not cols or cols[0] == "":
                continue
            acc = cols[0]
            try:
                taxid = int(cols[2].split()[0]) if len(cols) > 2 else 0
            except (ValueError, IndexError):
                taxid = 0
            batch[acc] = taxid
            count += 1
            if count >= batch_size:
                yield batch
                batch = {}
                count = 0
    if count:
        yield batch


def build_database(options: BuildOptions) -> SlimmDatabase:
    """slimm_build main flow (slimm_build.cpp:354-375)."""
    from .io.fasta import read_fasta_ids

    print("[MSG] getting accessions numbers from fasta file ...", file=sys.stderr)
    accessions = {accession_id(i) for i in read_fasta_ids(options.fasta_path)}

    db = SlimmDatabase()
    print("[MSG] mapping accessions to taxaid ...", file=sys.stderr)
    accessions_count = len(accessions)

    use_native = False
    if options.use_native:
        from .io import native as _native
        use_native = _native.available()

    for file_no, map_path in enumerate(options.ac__taxid_paths, 1):
        if not accessions:
            break
        if use_native:
            # native batched scan (stpu_acc2taxid_scan): same resolution
            # semantics, ~50x the python line loop — the mapping files are
            # ~50 GB at RefSeq scale (slimm_build.cpp:175-278)
            if options.verbose:
                print(f"[VERBOSE MSG] mapping file: [{file_no}/"
                      f"{len(options.ac__taxid_paths)}]\t(native scan)\t"
                      f"accessions left: "
                      f"[{len(accessions)}/{accessions_count}]",
                      file=sys.stderr)
            found = _native.acc2taxid_scan(map_path, sorted(accessions),
                                           options.batch)
            for acc, taxid in found.items():
                lineage = [0] * LINEAGE_LENGTH
                lineage[0] = taxid
                db.ac__taxid[acc] = lineage
            accessions -= found.keys()
            continue
        for iter_no, batch in enumerate(
                stream_acc2taxid_batches(map_path, options.batch), 1):
            if not accessions:
                break
            if options.verbose:
                print(f"[VERBOSE MSG] mapping file: [{file_no}/"
                      f"{len(options.ac__taxid_paths)}]\titer: [{iter_no}]\t"
                      f"accessions left: [{len(accessions)}/{accessions_count}]",
                      file=sys.stderr)
            found = accessions & batch.keys()
            for acc in found:
                lineage = [0] * LINEAGE_LENGTH
                lineage[0] = batch[acc]
                db.ac__taxid[acc] = lineage
            accessions -= found

    if accessions:
        _print_missed(accessions, options)

    _fill_name_taxid_lineage(db, options)
    return db


def _print_missed(accessions: set, options: BuildOptions) -> None:
    # <out stem>missed file + warning (slimm_build.cpp:200-219)
    missed_path = options.output_path[:-4] + "missed" \
        if options.output_path.endswith(".sldb") else options.output_path + "missed"
    sample = ", ".join(sorted(accessions)[:3])
    print(f"[WARNING!] {len(accessions)} accessions ({sample}, ...) "
          "were not mapped to taxaid.", file=sys.stderr)
    with open(missed_path, "wt") as f:
        for acc in sorted(accessions):
            f.write(acc + "\n")
    print(f"[WARNING!] Take a look at {missed_path} file for a complete list.",
          file=sys.stderr)
    print("[WARNING!] Try including the more ACCESSION2TAXAID MAP FILE "
          "(e.g. dead_nucl.accession2taxid)", file=sys.stderr)


def _fill_name_taxid_lineage(db: SlimmDatabase, options: BuildOptions) -> None:
    # (slimm_build.cpp:283-346)
    print("[MSG] loading nodes and names mappings from files ...", file=sys.stderr)
    taxid__parent: dict[int, tuple[int, int]] = {}
    with open(options.nodes_path, "rt") as f:
        for line in f:
            parsed = _parse_nodes_line(line)
            if parsed:
                taxid, parent, rank = parsed
                taxid__parent[taxid] = (int(to_rank(rank)), parent)
    names: dict[int, str] = {}
    with open(options.names_path, "rt") as f:
        for line in f:
            parsed = _parse_names_line(line)
            if parsed:
                names[parsed[0]] = parsed[1]

    print("[MSG] getting taxonomic linages and resolving names ...", file=sys.stderr)
    for lineage in db.ac__taxid.values():
        tid = lineage[0]
        db.taxid__name[tid] = (int(Rank.STRAIN), names.get(tid, ""))
        while tid != 1:
            entry = taxid__parent.get(tid)
            if entry is None:
                break
            current_rank, parent = entry
            if Rank.SPECIES <= current_rank <= Rank.SUPERKINGDOM:
                lineage[current_rank] = tid
                db.taxid__name[tid] = (current_rank, names.get(tid, ""))
            tid = parent


# -- tensorization for the TPU engine -----------------------------------------


@dataclass
class DenseTaxonomy:
    """Dense-tensor view of the DB for a given contig list.

    lineage      : (n_contigs, 8) int32 — dense taxon ids per level
                   (remapped; 0 stays 0)
    dense_to_tid : (n_dense,) int64 — dense id → NCBI taxon id (dense 0 == 0)
    tid_rank     : (n_dense,) int32 — rank per dense id (default 0 like the
                   reference's operator[] insert)
    sk_dense     : (S,) int32 — the distinct superkingdom-level dense ids
                   (sorted unique of lineage[:, 7]); S is tiny (bacteria/
                   archaea/viruses/... + 0)
    sk_code      : (n_contigs,) int32 — index of lineage[r, 7] in sk_dense

    The sk tables exist for the compact (lca, contig) pair channel: an LCA
    value is always lineage[max_rid][L] for the read's first agreeing level
    L, so when some level agrees the pair is recoverable from (contig,
    level) alone; when NO level agrees (reference slimm.hpp:516-531 falls
    through and returns the last-inserted level-7 taxid) the value is one
    of the S superkingdom ids — the presence map needs only 8 + S codes
    per contig instead of an (n_dense x n_contigs) domain.
    """

    lineage: np.ndarray
    dense_to_tid: np.ndarray
    tid_rank: np.ndarray
    accessions: list[str]
    sk_dense: np.ndarray = None
    sk_code: np.ndarray = None

    def __post_init__(self):
        if self.sk_dense is None:
            lvl7 = (self.lineage[:, 7] if len(self.lineage)
                    else np.zeros(0, np.int32))
            self.sk_dense = np.unique(lvl7).astype(np.int32)
            self.sk_code = np.searchsorted(self.sk_dense, lvl7).astype(
                np.int32)

    @property
    def n_dense(self) -> int:
        return len(self.dense_to_tid)

    @property
    def n_pair_codes(self) -> int:
        """Codes per contig in the pair presence map: 8 levels + the
        no-agreeing-level superkingdom codes."""
        return 8 + len(self.sk_dense)

    def dense_of(self, tid: int) -> int:
        idx = np.searchsorted(self.dense_to_tid, tid)
        if idx < len(self.dense_to_tid) and self.dense_to_tid[idx] == tid:
            return int(idx)
        return -1


def tensorize(db: SlimmDatabase, contig_names: list[str]) -> DenseTaxonomy:
    """Build the dense lineage matrix for a BAM header's contig list.

    Mirrors contig init (slimm.hpp:430-445): unknown accessions get an
    all-zero lineage (and are inserted into the live db map, like the
    reference's operator[]).
    """
    accs = [accession_id(n) for n in contig_names]
    rows = np.zeros((len(accs), LINEAGE_LENGTH), np.int64)
    for i, acc in enumerate(accs):
        lineage = db.ac__taxid.get(acc)
        if lineage is None:
            db.ac__taxid[acc] = [0] * LINEAGE_LENGTH
        else:
            rows[i] = lineage
    # dense id space: all lineage values (0 sorts first so dense 0 == taxid 0)
    uniq = np.unique(np.concatenate([rows.ravel(), [0]]))
    dense_rows = np.searchsorted(uniq, rows).astype(np.int32)
    ranks = np.zeros(len(uniq), np.int32)
    for i, tid in enumerate(uniq.tolist()):
        entry = db.taxid__name.get(tid)
        if entry is not None:
            ranks[i] = entry[0]
    return DenseTaxonomy(lineage=dense_rows, dense_to_tid=uniq,
                         tid_rank=ranks, accessions=accs)
