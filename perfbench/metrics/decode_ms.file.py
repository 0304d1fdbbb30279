"""decode_ms.file: the cell's file decoded alone, with no device work,
through the reader its path uses: the native stream reader's v2 pieces (the
overlap path, at the piece size that path picked) or the native whole-file
decoder (the whole-file path).  The median of three decodes, made after the
traced window, in ms.  The piece size is a copy of the overlap path's rule;
where the decode here makes another number of pieces than the window's
calls made (`pipeline.path_counts`), the rule has moved and the metric
reads nothing."""

import os
import statistics
import time

import numpy as np

REPS = 3


def _overlap_pieces(native, path):
    sr = native.NativeStreamReader(path)
    try:
        lengths = np.asarray(sr.contig_lengths).astype(np.uint32)
        avg = sr.avg_read_length
        n = len(lengths)
        rid_dtype = (np.uint8 if n <= 255 else np.int16 if n <= 32767
                     else np.int32)
        # the overlap path's piece: at least 262,144 targets, and about
        # 1/56 of the file's records at ~100 bytes a SAM line
        cap = max(262144, -(-(os.path.getsize(path) // 100 + 1) // 56))
        cap = -(-cap // 2048) * 2048
        pieces = 0
        while sr.next_piece_v2(cap, cap, lengths, avg // 2, avg, rid_dtype,
                               with_plan=True) is not None:
            pieces += 1
    finally:
        sr.close()
    return pieces


def _whole_file(native, path):
    af = native.NativeAlignmentFile(path)
    try:
        af.load()
    finally:
        af.close()


def read(run):
    if run.traffic["entry"] != "file" or run.trace is None:
        return None
    from slimm_tpu_torch.io import native

    overlap = run.traffic["path"] == "overlap"
    decode = _overlap_pieces if overlap else _whole_file
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        pieces = decode(native, run.files[0])
        times.append(time.perf_counter() - t0)
    if overlap:
        files = run.path_counts.get("overlap_files", 0)
        if not files or pieces * files != run.path_counts.get(
                "overlap_pieces", 0):
            return None
    return statistics.median(times) * 1e3
