# Copied from slimm_tpu/io/native.py (the port imports nothing of slimm_tpu).
"""ctypes bindings to the native C++ decoder/baseline
(native/slimm_native.cpp).

The port builds its own copy of the library at first use: `g++` with
native/Makefile's flags into `slimm_tpu_torch/_build/`, named by a hash of
the source, the flags and the host CPU's feature flags (`-march=native`
code runs only where those hold).  Concurrent builders (test workers) take
a file lock, and the library is renamed into place, so none sees half a
file.  A failed build raises with the compiler's output; the pure-Python
decoder is asked for with `EngineOptions(use_native=False)`."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "slimm_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile: CXXFLAGS, -shared, then the libraries
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared"]
LIBS = ["-lz", "-pthread"]
_lib = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> str:
    """Where the library for this source, these flags and this CPU lives
    (built or not)."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_cpu_flags())
    return os.path.join(BUILD_DIR, f"libslimm_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile native/slimm_native.cpp unless the library for its hash
    exists; returns its path.  Raises RuntimeError on a failed build."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native SAM/BAM decoder cannot "
                           "be built (EngineOptions(use_native=False) takes "
                           "the Python decoder)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def available() -> bool:
    """True once the library is built: builds it at the first call, and a
    failed build raises."""
    load_library()
    return True


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.stpu_open.restype = ctypes.c_void_p
    lib.stpu_open.argtypes = [ctypes.c_char_p]
    lib.stpu_open2.restype = ctypes.c_void_p
    lib.stpu_open2.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.stpu_error.restype = ctypes.c_char_p
    lib.stpu_error.argtypes = [ctypes.c_void_p]
    lib.stpu_warning.restype = ctypes.c_char_p
    lib.stpu_warning.argtypes = [ctypes.c_void_p]
    for fn in ("stpu_n_refs", "stpu_hits", "stpu_n_targets", "stpu_n_reads",
               "stpu_avg_read_len", "stpu_n_malformed", "stpu_max_targets"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.stpu_ref_name.restype = ctypes.c_char_p
    lib.stpu_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.stpu_ref_len.restype = ctypes.c_int64
    lib.stpu_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.stpu_fill.restype = None
    lib.stpu_fill.argtypes = [ctypes.c_void_p] + [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 3
    lib.stpu_close.restype = None
    lib.stpu_close.argtypes = [ctypes.c_void_p]
    lib.stpu_stream_open.restype = ctypes.c_void_p
    lib.stpu_stream_open.argtypes = [ctypes.c_char_p]
    lib.stpu_stream_open2.restype = ctypes.c_void_p
    lib.stpu_stream_open2.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.stpu_stream_error.restype = ctypes.c_char_p
    lib.stpu_stream_error.argtypes = [ctypes.c_void_p]
    lib.stpu_stream_file.restype = ctypes.c_void_p
    lib.stpu_stream_file.argtypes = [ctypes.c_void_p]
    for fn in ("stpu_stream_grouped", "stpu_stream_eof"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.stpu_stream_avg_len.restype = ctypes.c_int64
    lib.stpu_stream_avg_len.argtypes = [ctypes.c_void_p]
    lib.stpu_stream_next.restype = ctypes.c_int64
    lib.stpu_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.stpu_stream_take.restype = None
    lib.stpu_stream_take.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 3
    lib.stpu_stream_next_piece.restype = ctypes.c_int64
    lib.stpu_stream_next_piece.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.stpu_stream_take_v2.restype = None
    lib.stpu_stream_take_v2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_uint32, ctypes.c_uint32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
    ]
    lib.stpu_stream_take_v2x.restype = None
    lib.stpu_stream_take_v2x.argtypes = (
        lib.stpu_stream_take_v2.argtypes
        + [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)])
    lib.stpu_stream_close.restype = None
    lib.stpu_stream_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeAlignmentFile:
    """Native decoder with the same contract as io.sam.AlignmentFile."""

    def __init__(self, path: str, hash_names: bool = False,
                 single_thread: bool = False):
        import sys

        lib = load_library()
        self._lib = lib
        self.path = path
        flags = (1 if hash_names else 0) | (2 if single_thread else 0)
        self._h = lib.stpu_open2(path.encode(), flags)
        err = lib.stpu_error(self._h).decode()
        if err == "cannot open file":
            lib.stpu_close(self._h)
            self._h = None
            raise FileNotFoundError(f"Could not open {path}!")
        warn = lib.stpu_warning(self._h).decode()
        if warn:
            print(f"[WARNING] {path}: {warn}", file=sys.stderr)
        self.n_malformed = int(lib.stpu_n_malformed(self._h))
        if self.n_malformed:
            print(f"[WARNING] {path}: skipped {self.n_malformed} malformed "
                  "SAM lines", file=sys.stderr)
        n_refs = lib.stpu_n_refs(self._h)
        self.contig_names = [lib.stpu_ref_name(self._h, i).decode()
                             for i in range(n_refs)]
        self.contig_lengths = np.asarray(
            [lib.stpu_ref_len(self._h, i) for i in range(n_refs)], np.int64)

    def load(self):
        from .sam import RecordBatch

        lib = self._lib
        err = lib.stpu_error(self._h).decode()
        if err == "no records with sequences":
            raise ZeroDivisionError("no records with sequences (misc.hpp:521)")
        if err:
            raise ValueError(f"{self.path}: {err}")
        n_targets = lib.stpu_n_targets(self._h)
        read_id = np.empty(n_targets, np.int32)
        rid = np.empty(n_targets, np.int32)
        pos = np.empty(n_targets, np.int32)
        lib.stpu_fill(self._h, read_id, rid, pos)
        return RecordBatch(
            read_id=read_id.astype(np.int64), rid=rid, pos=pos,
            n_reads=int(lib.stpu_n_reads(self._h)),
            hits_count=int(lib.stpu_hits(self._h)),
            avg_read_length=int(lib.stpu_avg_read_len(self._h)),
            max_targets=int(lib.stpu_max_targets(self._h)))

    def close(self):
        if self._h is not None:
            self._lib.stpu_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeStreamReader:
    """Chunk-streaming decoder: dedup'd targets in READ-COMPLETE chunks.

    qname-grouped input (mapper output order) streams with flat decoder
    memory: shipped targets are compacted away in C++.  Non-grouped input
    (samtools' default coordinate sort) is handled too — no read is
    provably complete before EOF, so the decoder ingests to EOF, regroups
    the dedup'd targets with one counting sort (host memory O(targets)),
    and serves chunks from the grouped result; `grouped` stays True
    because the OUTPUT arrays are grouped.  The only fallback left is the
    mid-stream edge where the input stops being grouped after chunks were
    already shipped (error mentions "not qname-grouped"; callers fall
    back to NativeAlignmentFile).
    """

    def __init__(self, path: str, hash_names: bool = False,
                 single_thread: bool = False):
        lib = load_library()
        self._lib = lib
        self.path = path
        flags = (1 if hash_names else 0) | (2 if single_thread else 0)
        self._h = lib.stpu_stream_open2(path.encode(), flags)
        err = lib.stpu_stream_error(self._h).decode()
        if err == "cannot open file":
            lib.stpu_stream_close(self._h)
            self._h = None
            raise FileNotFoundError(f"Could not open {path}!")
        if err:
            lib.stpu_stream_close(self._h)
            self._h = None
            raise ValueError(f"{path}: {err}")
        f = lib.stpu_stream_file(self._h)
        self._f = f
        n_refs = lib.stpu_n_refs(f)
        self.contig_names = [lib.stpu_ref_name(f, i).decode()
                             for i in range(n_refs)]
        self.contig_lengths = np.asarray(
            [lib.stpu_ref_len(f, i) for i in range(n_refs)], np.int64)

    @property
    def grouped(self) -> bool:
        return bool(self._lib.stpu_stream_grouped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.stpu_stream_eof(self._h))

    @property
    def avg_read_length(self) -> int:
        return int(self._lib.stpu_stream_avg_len(self._h))

    @property
    def max_targets(self) -> int:
        """Longest per-read target run (final once eof; 0 = not grouped)."""
        return int(self._lib.stpu_max_targets(self._f))

    def totals(self):
        """(n_reads, hits_count, malformed) — final once eof."""
        f = self._f
        return (int(self._lib.stpu_n_reads(f)), int(self._lib.stpu_hits(f)),
                int(self._lib.stpu_n_malformed(f)))

    def warning(self) -> str:
        return self._lib.stpu_warning(self._f).decode()

    def next_piece_v2(self, cap: int, n_pad: int, lengths_u32, half: int,
                      bin_width: int, rid_dtype, with_plan: bool = False):
        """One read-complete piece of <= cap targets, already in the v2
        compact transfer format, encoded inside the C++ decode pipeline:
        (bitpacked boundaries uint8[n_pad/8], rid rid_dtype[n_pad], local
        bin uint16[n_pad], n_valid).  With `with_plan` the tuple gains
        (n_reads, max_run) for the piece — computed in C++ from the
        boundary bits (the overlap path's per-piece segment plan and
        read-id offsets; the numpy equivalent cost ~1 ms/piece on the
        thread that also feeds the decoder).  None at EOF.  Raises
        ValueError on decode errors / non-grouped input and OverflowError
        when a single read's targets exceed cap (callers fall back)."""
        n = self._lib.stpu_stream_next_piece(self._h, cap)
        if n == -1:
            raise ValueError(
                f"{self.path}: "
                f"{self._lib.stpu_stream_error(self._h).decode()}")
        if not self.grouped:
            raise ValueError(
                f"{self.path}: input is not qname-grouped; streaming "
                "decode needs mapper output order (use the whole-file "
                "decoder)")
        if n == -2:
            raise OverflowError("single read exceeds the piece cap")
        if n == 0 and self.eof:
            return None
        bnd = np.empty(n_pad // 8, np.uint8)
        rid_p = np.empty(n_pad, rid_dtype)
        bin_p = np.empty(n_pad, np.uint16)
        code = {np.uint8: 0, np.int16: 1, np.int32: 2}[rid_dtype]
        lengths = np.ascontiguousarray(lengths_u32, np.uint32)
        if not with_plan:
            self._lib.stpu_stream_take_v2(
                self._h, n, n_pad, lengths, np.uint32(half),
                np.uint32(bin_width), bnd,
                rid_p.ctypes.data_as(ctypes.c_void_p), code, bin_p)
            return bnd, rid_p, bin_p, np.int32(n)
        n_reads = ctypes.c_int64()
        max_run = ctypes.c_int64()
        self._lib.stpu_stream_take_v2x(
            self._h, n, n_pad, lengths, np.uint32(half),
            np.uint32(bin_width), bnd,
            rid_p.ctypes.data_as(ctypes.c_void_p), code, bin_p,
            ctypes.byref(n_reads), ctypes.byref(max_run))
        return (bnd, rid_p, bin_p, np.int32(n), int(n_reads.value),
                int(max_run.value))

    def next_chunk(self, min_targets: int):
        """(read_id, rid, pos) int32 arrays of >= min_targets targets cut at
        a read boundary, or None at EOF.  Raises on decode errors and on
        non-grouped input."""
        n = self._lib.stpu_stream_next(self._h, min_targets)
        if n < 0:
            raise ValueError(
                f"{self.path}: "
                f"{self._lib.stpu_stream_error(self._h).decode()}")
        if not self.grouped:
            raise ValueError(
                f"{self.path}: input is not qname-grouped; streaming "
                "decode needs mapper output order (use the whole-file "
                "decoder)")
        if n == 0 and self.eof:
            return None
        read_id = np.empty(n, np.int32)
        rid = np.empty(n, np.int32)
        pos = np.empty(n, np.int32)
        self._lib.stpu_stream_take(self._h, n, read_id, rid, pos)
        return read_id, rid, pos

    def close(self):
        if self._h is not None:
            self._lib.stpu_stream_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def acc2taxid_scan(path: str, accessions: list, batch: int = 1000000):
    """Resolve accessions against one accession2taxid TSV in C++
    (native stpu_acc2taxid_scan; plain, gzip or BGZF input), replicating
    the reference's batched semantics (slimm_build.cpp:175-278).  Returns
    {accession: taxid} for the resolved subset."""
    lib = load_library()
    if not hasattr(lib.stpu_acc2taxid_scan, "_configured"):
        lib.stpu_acc2taxid_scan.restype = ctypes.c_int64
        lib.stpu_acc2taxid_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.stpu_acc2taxid_scan._configured = True
    accs = list(accessions)
    raw = [a.encode() for a in accs]
    offs = np.zeros(len(raw) + 1, np.int64)
    np.cumsum([len(r) for r in raw], out=offs[1:])
    blob = b"".join(raw)
    out_idx = np.empty(max(len(raw), 1), np.int64)
    out_tax = np.empty(max(len(raw), 1), np.uint32)
    err = ctypes.create_string_buffer(512)
    k = lib.stpu_acc2taxid_scan(path.encode(), blob, offs, len(raw),
                                batch, out_idx, out_tax, err, len(err))
    if k < 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return {accs[int(out_idx[i])]: int(out_tax[i]) for i in range(k)}


def propagate(n_contigs: int, lineage, tax, cnt, rnk, ctax, coff, cch,
              c2idx, c2cnt):
    """Ancestor propagation (ProfileState.propagate_counts semantics) in
    C++ (stpu_propagate_run) — the host-finalize hot path at full-RefSeq
    cardinality.  Returns (taxids, counts, flags, choff, cch) arrays, or
    None when the native path declines (missing/empty children — the
    Python loop raises there, so callers must fall back to it)."""
    lib = load_library()
    if not hasattr(lib.stpu_propagate_run, "_configured"):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.stpu_propagate_run.restype = ctypes.c_void_p
        lib.stpu_propagate_run.argtypes = [
            ctypes.c_int32, i64p,
            ctypes.c_int64, i64p, i64p, i32p,
            ctypes.c_int64, i64p, i64p, i32p,
            ctypes.c_int64, i32p, i64p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.stpu_propagate_take.restype = None
        lib.stpu_propagate_take.argtypes = [
            ctypes.c_void_p, i64p, i64p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            i64p, i32p,
        ]
        lib.stpu_propagate_run._configured = True
    lineage = np.ascontiguousarray(lineage, np.int64)
    tax = np.ascontiguousarray(tax, np.int64)
    cnt = np.ascontiguousarray(cnt, np.int64)
    rnk = np.ascontiguousarray(rnk, np.int32)
    ctax = np.ascontiguousarray(ctax, np.int64)
    coff = np.ascontiguousarray(coff, np.int64)
    cch = np.ascontiguousarray(cch, np.int32)
    c2idx = np.ascontiguousarray(c2idx, np.int32)
    c2cnt = np.ascontiguousarray(c2cnt, np.int64)
    n_slots = ctypes.c_int64()
    n_elems = ctypes.c_int64()
    h = lib.stpu_propagate_run(
        np.int32(n_contigs), lineage, len(tax), tax, cnt, rnk,
        len(ctax), ctax, coff, cch, len(c2idx), c2idx, c2cnt,
        ctypes.byref(n_slots), ctypes.byref(n_elems))
    if not h:
        return None
    k = int(n_slots.value)
    out_tax = np.empty(k, np.int64)
    out_cnt = np.empty(k, np.int64)
    out_flags = np.empty(k, np.uint8)
    out_choff = np.empty(k + 1, np.int64)
    out_cch = np.empty(max(int(n_elems.value), 1), np.int32)
    lib.stpu_propagate_take(h, out_tax, out_cnt, out_flags, out_choff,
                            out_cch)
    return out_tax, out_cnt, out_flags, out_choff, out_cch[:int(n_elems.value)]
