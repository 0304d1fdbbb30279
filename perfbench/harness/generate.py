"""The benchmark's one traffic generator: a SLIMM database and its samples
made from a seed, and a sample written as a SAM or a BAM file.

A frozen copy of slimm_tpu_torch/utils/workload.py (`make_workload`,
`make_bench_db`, `bench_names`, `write_bench_sam`, `_bgzf_blocks`,
`write_bench_bam`), itself a copy of bench.py:48-100 and 214-346.  The
program may change; this copy stays as it is, so that every later run makes
the same bytes from the same seed.  The writers are copied as they were;
the database and the samples are not: the database (contig lengths,
lineages, names) is drawn from the seed alone and each sample from the seed
and the sample's index, so that several samples share one database; the
sizes, the taxonomy, the abundances and the multi-mapping come from the
configuration's file; and every seed gets the same sizes and counts in
another order, so that a seed changes the order of the work and not its
amount.
"""

from __future__ import annotations

import os
import struct
import zlib
from statistics import NormalDist

import numpy as np

LINEAGE_LENGTH = 8
# the ranks above a genome's own taxon (the strain, level 0), as SLIMM's
# lineage orders them
RANKS = ("species", "genus", "family", "order", "class", "phylum",
         "superkingdom")


def _rng(seed: int, stream: int) -> np.random.Generator:
    # any whole seed, negative or past 64 bits, maps to one stream
    return np.random.default_rng([seed % 2**64, stream])


def _spaced(n: int) -> np.ndarray:
    """n evenly spaced quantile levels in (0, 1)."""
    return (np.arange(n) + 0.5) / n


def make_database(cfg: dict, seed: int) -> dict:
    """Contig names and lengths, each contig's lineage and the two maps of
    a SLIMM database: accession -> lineage, taxid -> (rank, name).

    Every seed gets the same set of genome lengths (evenly spaced over the
    configuration's `genome_length` range) in an order drawn from the seed,
    so the bin tables have the same size on every seed.  The taxonomy is
    contiguous groups of contigs: `taxon_sizes[rank]` genomes per taxon of
    that rank (the last group of a rank may be smaller)."""
    n = int(cfg["n_contigs"])
    lo, hi = cfg["genome_length"]
    rng = _rng(seed, 0)
    lengths = rng.permutation(
        np.rint(lo + (hi - lo) * _spaced(n))).astype(np.uint32)
    lineage = np.zeros((n, LINEAGE_LENGTH), np.int32)
    c = np.arange(n)
    lineage[:, 0] = 1 + c
    base = 1 + n
    sizes = [1] + [int(cfg["taxon_sizes"][r]) for r in RANKS]
    if any(b % a and b < n for a, b in zip(sizes, sizes[1:])):
        raise ValueError(f"taxon_sizes {sizes[1:]}: each rank's taxa must "
                         "be whole groups of the rank's below")
    for lvl, size in enumerate(sizes[1:], start=1):
        lineage[:, lvl] = base + c // size
        base += -(-n // size)
    names, _ = contig_names(n)
    ac__taxid = {}
    taxid__name = {}
    for c in range(n):
        ac__taxid[names[c]] = lineage[c].tolist()
        for lvl in range(LINEAGE_LENGTH):
            tid = int(lineage[c, lvl])
            taxid__name.setdefault(tid, (lvl, f"taxon{tid}"))
    return dict(names=names, lengths=lengths, lineage=lineage,
                ac__taxid=ac__taxid, taxid__name=taxid__name)


def _largest_remainder(p: np.ndarray, total: int) -> np.ndarray:
    """Whole counts in the proportions p that sum to total."""
    raw = p * total
    counts = np.floor(raw).astype(np.int64)
    rest = total - int(counts.sum())
    counts[np.argsort(counts - raw, kind="stable")[:rest]] += 1
    return counts


def make_sample(cfg: dict, db: dict, seed: int, index: int,
                n_records: int) -> dict:
    """About n_records raw alignment records, grouped by read as a mapper
    emits them, in read order.

    Abundances: the log-normal (mu, sigma) of `abundance_lognormal` at
    evenly spaced quantiles, handed to the genomes in an order drawn from
    the seed and the sample's index; each genome gets its share of the
    reads exactly.  A `multi_share` of the reads map to further genomes:
    half of them one more, half two more.  The k-th extra hit lies on
    another genome of the read's taxon at rank `partner_ranks[k]` (a
    repeated genome is a duplicate hit).  So every seed has the same
    number of reads, records and reads per genome, in another order."""
    n_contigs = len(db["lengths"])
    lengths = db["lengths"]
    read_len = int(cfg["read_length"])
    share = float(cfg["multi_share"])
    rng = _rng(seed, 1 + index)
    n_reads = int(n_records / (1 + share * 1.5))

    mu, sigma = cfg["abundance_lognormal"]
    z = np.array([NormalDist().inv_cdf(q) for q in _spaced(n_contigs)])
    weights = rng.permutation(np.exp(mu + sigma * z))
    per_contig = _largest_remainder(weights / weights.sum(), n_reads)
    read_contig = rng.permutation(np.repeat(np.arange(n_contigs),
                                            per_contig))
    n_multi = int(round(n_reads * share))
    multi = rng.permutation(n_reads)[:n_multi]
    extra = [multi, multi[:n_multi // 2]]

    rows = [np.stack([np.arange(n_reads), read_contig], axis=1)]
    for k, sel in enumerate(extra):
        size = int(cfg["taxon_sizes"][cfg["partner_ranks"][k]])
        own = read_contig[sel]
        start = own // size * size
        span = np.minimum(size, n_contigs - start)
        if (span < 2).any():
            raise ValueError(f"rank {cfg['partner_ranks'][k]!r} has a "
                             "taxon of one genome: no partner to draw")
        step = 1 + (rng.random(len(sel)) * (span - 1)).astype(np.int64)
        partner = start + (own - start + step) % span
        rows.append(np.stack([sel, partner], axis=1))
    pairs = np.concatenate(rows)
    order = np.argsort(pairs[:, 0], kind="stable")  # records grouped per read
    pairs = pairs[order]
    read_id = pairs[:, 0].astype(np.int32)
    rid = pairs[:, 1].astype(np.int32)
    pos = (rng.random(len(rid)) * (lengths[rid] - read_len)).astype(np.int32)
    return dict(read_id=read_id, rid=rid, pos=pos, n_reads=n_reads,
                read_len=read_len)


def contig_names(n_contigs):
    """Zero-padded contig names: every record line is then fixed-width,
    which lets write_sam build the file with vectorized numpy byte fills
    instead of one Python f-string per record."""
    cw = max(1, len(str(n_contigs - 1)))
    return [f"ctg{c:0{cw}d}" for c in range(n_contigs)], cw


def file_read_length(read_len: int) -> int:
    """The SEQ length the writers give every record: 4 * (read_len // 4)."""
    return 4 * (read_len // 4)


def write_sam(path, db, s, block=1 << 20):
    """Write sample `s` as a SAM file (vectorized fixed-width lines; numeric
    fields zero-padded, which parse as the plain numbers).  Returns its
    size in bytes."""
    n_contigs = len(db["lengths"])
    names, cw = contig_names(n_contigs)
    rl = file_read_length(s["read_len"])
    seq = b"ACGT" * (s["read_len"] // 4)
    qual = b"I" * rl
    rid, pos, read = s["rid"], s["pos"], s["read_id"]
    rw = max(1, len(str(int(read.max()) if len(read) else 0)))
    pw = max(1, len(str(int(db["lengths"].max()) + 1)))
    cig = f"{s['read_len']}M".encode()
    row = (b"r" + b"0" * rw + b"\t0\tctg" + b"0" * cw + b"\t" + b"0" * pw
           + b"\t60\t" + cig + b"\t*\t0\t0\t" + seq + b"\t" + qual + b"\n")
    o_read = 1
    o_rid = o_read + rw + 6          # "\t0\tctg"
    o_pos = o_rid + cw + 1
    tmpl = np.frombuffer(row, np.uint8)
    # the line buffer is allocated and template-filled once; per block only
    # the digit columns are rewritten (uint32 divmods)
    m = np.empty((min(block, len(rid)) or 1, len(row)), np.uint8)
    m[:] = tmpl

    def put(col, vals, width):
        v = vals.astype(np.uint32)
        for k in range(width):
            np.add(np.uint8(48),
                   ((v // np.uint32(10**k)) % np.uint32(10)).astype(np.uint8),
                   out=m[:len(v), col + width - 1 - k])

    with open(path, "wb", buffering=1 << 22) as f:
        head = "@HD\tVN:1.6\n" + "".join(
            f"@SQ\tSN:{names[c]}\tLN:{int(db['lengths'][c])}\n"
            for c in range(n_contigs))
        f.write(head.encode())
        for lo in range(0, len(rid), block):
            hi = min(lo + block, len(rid))
            put(o_read, read[lo:hi], rw)
            put(o_rid, rid[lo:hi], cw)
            put(o_pos, pos[lo:hi] + 1, pw)
            f.write(m[:hi - lo])
    return os.path.getsize(path)


def _bgzf_blocks(payload: bytes, out, level=1):
    """BGZF-wrap `payload` into <=64KB deflate blocks appended to file
    `out` (the BAM container format, SAM spec 4.1)."""
    step = 0xFF00
    for lo in range(0, max(len(payload), 1), step):
        chunk = payload[lo:lo + step]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        out.write(struct.pack("<4BI2BH2B2H", 31, 139, 8, 4, 0, 0, 255,
                              6, 66, 67, 2, bsize - 1))
        out.write(cdata)
        out.write(struct.pack("<II", zlib.crc32(chunk), len(chunk)))


def write_bam(path, db, s, block=1 << 20):
    """Write sample `s` as a BAM file (BGZF container, binary records, zlib
    level 1), the binary twin of write_sam's file: the same records, read
    names and header.  Returns its size in bytes."""
    n_contigs = len(db["lengths"])
    names, _ = contig_names(n_contigs)
    rl = file_read_length(s["read_len"])
    rid, pos, read = s["rid"], s["pos"], s["read_id"]
    name_len = len(f"r{max(int(read.max()), 0)}")
    # fixed-size record: header(36) + qname(name_len+1) + cigar(4)
    # + seq(ceil(rl/2)) + qual(rl)
    seq_b = (rl + 1) // 2
    rec_size = 36 + name_len + 1 + 4 + seq_b + rl
    with open(path, "wb", buffering=1 << 22) as f:
        hdr_text = "@HD\tVN:1.6\n" + "".join(
            f"@SQ\tSN:{nm}\tLN:{int(db['lengths'][c])}\n"
            for c, nm in enumerate(names))
        head = b"BAM\x01" + struct.pack("<i", len(hdr_text))
        head += hdr_text.encode() + struct.pack("<i", n_contigs)
        for c, nm in enumerate(names):
            head += struct.pack("<i", len(nm) + 1) + nm.encode() + b"\0"
            head += struct.pack("<i", int(db["lengths"][c]))
        _bgzf_blocks(head, f)

        tmpl = np.zeros(rec_size, np.uint8)
        for lo in range(0, len(rid), block):
            hi = min(lo + block, len(rid))
            n = hi - lo
            recs = np.broadcast_to(tmpl, (n, rec_size)).copy()
            head32 = recs[:, :36].view("<i4")
            head32[:, 0] = rec_size - 4                 # block_size
            head32[:, 1] = rid[lo:hi]                   # refID
            head32[:, 2] = pos[lo:hi]                   # POS (0-based)
            head32[:, 3] = (name_len + 1) | (60 << 8)   # l_read_name | mapq
            head32[:, 4] = 1                            # n_cigar | flag=0
            head32[:, 5] = rl                           # l_seq
            head32[:, 6] = -1                           # next_refID
            head32[:, 7] = -1                           # next_pos
            head32[:, 8] = 0                            # tlen
            # qname "r<digits>" zero-padded to fixed width + NUL
            digits = read[lo:hi].astype(np.int64)
            recs[:, 36] = ord("r")
            for k in range(name_len - 1):
                recs[:, 36 + name_len - 1 - k] = (
                    ord("0") + (digits // 10**k) % 10)
            recs[:, 36 + name_len] = 0
            cig = recs[:, 36 + name_len + 1:36 + name_len + 5].view("<i4")
            cig[:, 0] = rl << 4                         # <rl>M
            body = recs[:, 36 + name_len + 5:]
            body[:, :seq_b] = 0x12                      # ACAC... 4-bit
            body[:, seq_b:] = 40                        # qual 'I'
            _bgzf_blocks(recs.tobytes(), f)
        _bgzf_blocks(b"", f)  # EOF marker
    return os.path.getsize(path)
