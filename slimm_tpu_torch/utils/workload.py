"""The bench's synthetic workload: alignment arrays, a database and a SAM
file made from a seed.

Copied from bench.py:48-100 (`make_workload`, `make_bench_db`) and 214-267
(`bench_names`, `write_bench_sam`), with `make_bench_db` on the port's own
SlimmDatabase; the arrays and file bytes are the same for the same seed.
"""

import os

import numpy as np


def make_workload(n_records, n_contigs, seed=0):
    """Synthetic alignments: ~90% unique reads, ~10% multi-mapped (2-3 hits),
    contig lengths 0.5-2 Mbp, read length 150.  Records grouped per read
    (mapper output order — the decoder contract)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(500_000, 2_000_000, n_contigs).astype(np.uint32)
    avg_read_len = 150
    n_reads_target = int(n_records / 1.15)
    weights = rng.dirichlet(np.ones(n_contigs) * 0.3)
    read_contig = rng.choice(n_contigs, n_reads_target, p=weights)
    multi = rng.random(n_reads_target) < 0.10
    extra_counts = np.where(multi, rng.integers(1, 3, n_reads_target), 0)

    rows = [np.stack([np.arange(n_reads_target, dtype=np.int64), read_contig],
                     axis=1)]
    for k in range(2):
        sel = np.flatnonzero(extra_counts > k)
        partner = rng.integers(0, n_contigs, len(sel))
        rows.append(np.stack([sel, partner], axis=1))
    pairs = np.concatenate(rows)
    order = np.argsort(pairs[:, 0], kind="stable")  # records grouped per read
    pairs = pairs[order]
    read_id = pairs[:, 0].astype(np.int32)
    rid = pairs[:, 1].astype(np.int32)
    pos = (rng.random(len(rid))
           * (lengths[rid] - avg_read_len)).astype(np.int32)
    lineage = np.zeros((n_contigs, 8), np.int32)
    # dense taxonomy: species-ish groups of 5 contigs sharing upper ranks
    base = 1
    for c in range(n_contigs):
        lineage[c, 0] = base + c
        for lvl in range(1, 8):
            lineage[c, lvl] = base + n_contigs + (c // (5 * lvl)) + 1000 * lvl
    n_dense = int(lineage.max()) + 1
    sk_dense = np.unique(lineage[:, 7]).astype(np.int32)
    sk_code = np.searchsorted(sk_dense, lineage[:, 7]).astype(np.int32)
    return dict(read_id=read_id, rid=rid, pos=pos,
                n_reads=n_reads_target, lengths=lengths, lineage=lineage,
                n_dense=n_dense, avg_read_len=avg_read_len,
                sk_code=sk_code, n_codes=8 + len(sk_dense))


def make_bench_db(w, n_contigs):
    from ..database import SlimmDatabase

    db = SlimmDatabase()
    names, _ = bench_names(n_contigs)
    for c in range(n_contigs):
        db.ac__taxid[names[c]] = w["lineage"][c].tolist()
        for lvl in range(8):
            tid = int(w["lineage"][c, lvl])
            db.taxid__name.setdefault(tid, (lvl, f"taxon{tid}"))
    return db


def bench_names(n_contigs):
    """Zero-padded contig names: every record line is then fixed-width,
    which lets write_bench_sam build the file with vectorized numpy byte
    fills instead of one Python f-string per record."""
    cw = max(1, len(str(n_contigs - 1)))
    return [f"ctg{c:0{cw}d}" for c in range(n_contigs)], cw


def write_bench_sam(path, w, n_contigs, block=1 << 20):
    """Write the workload as a SAM file (vectorized fixed-width lines;
    numeric fields zero-padded — leading zeros parse identically).  Returns
    its size in MiB."""
    names, cw = bench_names(n_contigs)
    rl = 4 * (w["avg_read_len"] // 4)
    seq = b"ACGT" * (w["avg_read_len"] // 4)
    qual = b"I" * rl
    rid, pos, read = w["rid"], w["pos"], w["read_id"]
    rw = max(1, len(str(int(read.max()) if len(read) else 0)))
    pw = max(1, len(str(int(w["lengths"].max()) + 1)))
    cig = f"{w['avg_read_len']}M".encode()
    row = (b"r" + b"0" * rw + b"\t0\tctg" + b"0" * cw + b"\t" + b"0" * pw
           + b"\t60\t" + cig + b"\t*\t0\t0\t" + seq + b"\t" + qual + b"\n")
    o_read = 1
    o_rid = o_read + rw + 6          # "\t0\tctg"
    o_pos = o_rid + cw + 1
    tmpl = np.frombuffer(row, np.uint8)
    # the line buffer is allocated and template-filled once; per block only
    # the digit columns are rewritten (uint32 divmods) and the buffer is
    # handed to write() directly
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
            f"@SQ\tSN:{names[c]}\tLN:{int(w['lengths'][c])}\n"
            for c in range(n_contigs))
        f.write(head.encode())
        for lo in range(0, len(rid), block):
            hi = min(lo + block, len(rid))
            n = hi - lo
            put(o_read, read[lo:hi], rw)
            put(o_rid, rid[lo:hi], cw)
            put(o_pos, pos[lo:hi] + 1, pw)
            f.write(m[:n])
    return os.path.getsize(path) / 2**20
