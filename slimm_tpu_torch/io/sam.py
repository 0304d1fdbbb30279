# Copied from slimm_tpu/io/sam.py (the port imports nothing of slimm_tpu).
"""SAM / BAM alignment ingestion → fixed-width record arrays.

TPU-native replacement for the reference's SeqAn BamFileIn path
(misc.hpp:498-522, slimm.hpp:191-213): instead of streaming one
BamAlignmentRecord at a time into hash maps, the decoder produces dense numpy
arrays (read_id, rid, pos) ready for device transfer, with the read-name
dictionary (qname + ".1"/".2" pair suffix) applied on the host.

Two decoders:
  * this pure-Python module (reference path, always available);
  * the native C++ decoder (slimm_tpu.io.native), used when built — same
    array contract, ~50x faster.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

FLAG_UNMAPPED = 0x4
FLAG_FIRST = 0x40
FLAG_LAST = 0x80

AVG_LEN_SAMPLE = 100000  # reference samples <=100k records (slimm.hpp:409)


@dataclass
class RecordBatch:
    """Dedup'd alignment targets of one file as dense arrays.

    One entry per distinct (read, contig) pair holding the FIRST hit's
    position — the read_stat::add_target first-hit-wins dedup
    (read_stat.hpp:116-135) applied during decode.

    read_id: int64 read index (dictionary order = first appearance)
    rid:     int32 contig index from the header
    pos:     int32 0-based leftmost mapping position of the first hit
    """

    read_id: np.ndarray
    rid: np.ndarray
    pos: np.ndarray
    n_reads: int           # distinct read keys == matches_count
    hits_count: int        # ALL mapped records (incl. dropped duplicates)
    avg_read_length: int   # two-pass sampling semantics (misc.hpp:509-522)
    read_keys: list | None = None  # optional (debug/tests)
    # longest per-read target run when known (native grouped decode);
    # 0 = unknown, the engine measures it from the arrays
    max_targets: int = 0


def _sniff(path: str) -> tuple[bool, bool]:
    """(is_bam, is_gzip) from the container + decompressed magic — a gzipped
    SAM text file is valid input (the native decoder sniffs identically)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"\x1f\x8b":  # BGZF/gzip container
        try:
            with gzip.open(path, "rb") as g:
                inner = g.read(4)
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"{path}: corrupt gzip stream: {e}") from e
        return inner == b"BAM\x01", True
    return head == b"BAM\x01", False


class AlignmentFile:
    """Header + record arrays for one SAM or BAM file."""

    def __init__(self, path: str):
        self.path = path
        self.contig_names: list[str] = []
        self.contig_lengths: np.ndarray | None = None
        self._records = None  # list of (qname, flag, rid, pos, seq_len)
        self.n_malformed = 0  # skipped malformed SAM lines
        if not os.path.exists(path):
            raise FileNotFoundError(f"Could not open {path}!")
        is_bam, is_gzip = _sniff(path)
        if is_bam:
            self._parse_bam()
        else:
            self._parse_sam(gzip.open if is_gzip else open)
        if self.n_malformed:
            import sys
            print(f"[WARNING] {path}: skipped {self.n_malformed} malformed "
                  "SAM lines", file=sys.stderr)

    # -- parsing -------------------------------------------------------------

    def _parse_sam(self, opener=open):
        names, lengths, records = [], [], []
        rid_of = {}
        try:
            self._parse_sam_lines(opener, names, lengths, records, rid_of)
        except (EOFError, zlib.error, gzip.BadGzipFile) as e:
            raise ValueError(f"{self.path}: corrupt gzip stream: {e}") from e
        self.contig_names = names
        self.contig_lengths = np.asarray(lengths, np.int64)
        self._records = records

    def _parse_sam_lines(self, opener, names, lengths, records, rid_of):
        with opener(self.path, "rt") as f:
            for line in f:  # file iteration streams; only records are held
                if line.startswith("@"):
                    if line.startswith("@SQ"):
                        sn, ln = None, None
                        for field in line.rstrip("\n").split("\t")[1:]:
                            if field.startswith("SN:"):
                                sn = field[3:]
                            elif field.startswith("LN:"):
                                ln = int(field[3:])
                        if sn is not None:
                            rid_of[sn] = len(names)
                            names.append(sn)
                            lengths.append(ln or 0)
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 11:
                    if line.strip():  # malformed: count + warn (SeqAn throws)
                        self.n_malformed += 1
                    continue
                qname, flag, rname, pos1 = cols[0], int(cols[1]), cols[2], int(cols[3])
                seq = cols[9]
                seq_len = 0 if seq == "*" else len(seq)
                rid = rid_of.get(rname, -1)
                records.append((qname, flag, rid, pos1 - 1, seq_len))

    def _parse_bam(self):
        # BGZF is a series of gzip members; python gzip streams across the
        # concatenation.  The raw/inflated file is never fully resident —
        # a bounded window is pulled per record (truncation raises).
        head = open(self.path, "rb").read(4)
        opener = open if head == b"BAM\x01" else gzip.open
        with opener(self.path, "rb") as f:
            buf = bytearray()
            pos = 0
            consumed = 0

            def take(n: int, what: str) -> bytes:
                nonlocal buf, pos, consumed
                while len(buf) - pos < n:
                    if pos > (1 << 22):
                        del buf[:pos]
                        pos = 0
                    try:
                        chunk = f.read(1 << 20)
                    except (OSError, EOFError, zlib.error) as e:
                        raise ValueError(
                            f"{self.path}: corrupt gzip/BGZF stream near "
                            f"uncompressed offset {consumed}: {e}") from e
                    if not chunk:
                        raise ValueError(
                            f"{self.path}: truncated BAM stream: {what} at "
                            f"uncompressed offset {consumed} (need {n} "
                            f"bytes, have {len(buf) - pos})")
                    buf.extend(chunk)
                out = bytes(buf[pos:pos + n])  # copy: buf resizes later
                pos += n
                consumed += n
                return out

            def at_end() -> bool:
                nonlocal buf, pos
                if len(buf) - pos > 0:
                    return False
                chunk = f.read(1 << 20)
                if not chunk:
                    return True
                buf.extend(chunk)
                return False

            if take(4, "magic") != b"BAM\x01":
                raise ValueError(f"{self.path}: not a BAM file")
            (l_text,) = struct.unpack("<i", take(4, "l_text"))
            if not (0 <= l_text < (1 << 30)):
                raise ValueError(f"{self.path}: corrupt BAM header length "
                                 f"{l_text}")
            take(l_text, "header text")
            (n_ref,) = struct.unpack("<i", take(4, "n_ref"))
            if not (0 <= n_ref < (1 << 28)):
                raise ValueError(f"{self.path}: corrupt BAM n_ref {n_ref}")
            names, lengths = [], []
            for i in range(n_ref):
                (l_name,) = struct.unpack("<i", take(4, "ref name length"))
                if not (1 <= l_name < (1 << 20)):
                    raise ValueError(f"{self.path}: corrupt BAM reference "
                                     f"name length at ref {i}")
                names.append(take(l_name, "ref name")[:-1].decode())
                (l_ref,) = struct.unpack("<i", take(4, "ref length"))
                lengths.append(l_ref)
            records = []
            rec_no = 0
            while not at_end():
                rec_off = consumed
                (block_size,) = struct.unpack("<i", take(4, "record size"))
                if not (32 <= block_size < (1 << 28)):
                    raise ValueError(
                        f"{self.path}: corrupt BAM record size {block_size} "
                        f"at record {rec_no}, uncompressed offset {rec_off}")
                body = take(block_size, "record body")
                (ref_id, rpos, l_read_name, _mapq, _bin, _n_cigar, flag,
                 l_seq) = struct.unpack_from("<iiBBHHHi", body, 0)
                if l_read_name < 1 or 32 + l_read_name > block_size:
                    raise ValueError(
                        f"{self.path}: corrupt BAM read name length at "
                        f"record {rec_no}, uncompressed offset {rec_off}")
                if not (-1 <= ref_id < n_ref):
                    raise ValueError(
                        f"{self.path}: BAM refID {ref_id} out of range at "
                        f"record {rec_no}")
                qname = body[32:32 + l_read_name - 1].decode()
                records.append((qname, flag, ref_id, rpos, l_seq))
                rec_no += 1
        self.contig_names = names
        self.contig_lengths = np.asarray(lengths, np.int64)
        self._records = records

    # -- record access -------------------------------------------------------

    def raw_records(self):
        """(qname, flag, rid, pos, seq_len) tuples — oracle/test input."""
        return self._records

    def load(self, dedup: bool = True) -> RecordBatch:
        """Build the dense arrays + read-name dictionary.

        Read keys get the ".1"/".2" pair suffix from the first/last-of-pair
        flags (slimm.hpp:204-209); ids are assigned in first-appearance order.
        Unmapped or invalid-rid records are excluded (slimm.hpp:197-198) but
        still count toward the average-read-length sample.

        dedup=False emits RAW grouped records (duplicates included) for the
        engine's on-device first-hit dedup path.
        """
        total_len = 0
        n_sampled = 0
        hits = 0
        read_ids, rids, poss = [], [], []
        key_to_id: dict[str, int] = {}
        keys: list[str] = []
        seen: set[tuple[int, int]] = set()
        for qname, flag, rid, pos, seq_len in self._records:
            if n_sampled < AVG_LEN_SAMPLE and seq_len > 0:
                total_len += seq_len
                n_sampled += 1
            if (flag & FLAG_UNMAPPED) or rid < 0:
                continue
            if flag & FLAG_FIRST:
                key = qname + ".1"
            elif flag & FLAG_LAST:
                key = qname + ".2"
            else:
                key = qname
            idx = key_to_id.get(key)
            if idx is None:
                idx = len(key_to_id)
                key_to_id[key] = idx
                keys.append(key)
            hits += 1
            pair = (idx, rid)
            if not dedup:
                read_ids.append(idx)
                rids.append(rid)
                poss.append(pos)
            elif pair not in seen:  # first hit wins (read_stat.hpp:116-135)
                seen.add(pair)
                read_ids.append(idx)
                rids.append(rid)
                poss.append(pos)
        if n_sampled == 0:
            raise ZeroDivisionError("no records with sequences (misc.hpp:521)")
        read_id = np.asarray(read_ids, np.int64)
        rid = np.asarray(rids, np.int32)
        pos = np.asarray(poss, np.int32)
        # group targets by read id (stable), matching the native decoder's
        # counting sort — enables neighbor-compare uniqueness on device
        order = np.argsort(read_id, kind="stable")
        return RecordBatch(
            read_id=read_id[order],
            rid=rid[order],
            pos=pos[order],
            n_reads=len(key_to_id),
            hits_count=hits,
            avg_read_length=total_len // n_sampled,
            read_keys=keys)
