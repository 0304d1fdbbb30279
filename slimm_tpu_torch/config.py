# Copied from slimm_tpu/config.py (the port imports nothing of slimm_tpu).
"""Configuration dataclasses.

One dataclass per CLI surface, mirroring the reference option names and
defaults exactly (profiler: src/slimm.cpp:60-180 + slimm.hpp:75-86;
builder: src/slimm_build.cpp:54-114).  No config files / env vars in the
reference; we add optional TPU-execution knobs in EngineOptions which do not
change results (integer-exact merges make shard count invisible).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ProfileOptions:
    """Options of the `slimm` profiler CLI (reference slimm.hpp:49-87)."""

    database_path: str = ""
    input_path: str = ""
    output_prefix: str = ""
    bin_width: int = 0           # 0 → auto: avg read length (slimm.hpp:412-413)
    min_reads: int = 0           # 0 → auto: 1 + (matches-1)/10000 (slimm.hpp:458-459)
    rank: str = "species"
    cov_cut_off: float = 0.95    # quantile in [0, 1] (slimm.cpp:91-96)
    abundance_cut_off: float = 0.01  # in [0, 10] (slimm.cpp:98-102)
    is_directory: bool = False
    raw_output: bool = False
    coverage_output: bool = False
    verbose: bool = False


@dataclass
class BuildOptions:
    """Options of the `slimm_build` DB-builder CLI (slimm_build.cpp:54-70)."""

    fasta_path: str = ""
    ac__taxid_paths: list[str] = field(default_factory=list)
    names_path: str = ""
    nodes_path: str = ""
    output_path: str = "slimm_db.sldb"
    batch: int = 1000000
    verbose: bool = False
    # Use the native C++ acc2taxid scanner when built (same resolution
    # semantics as the python fallback; ~50x on RefSeq-scale mapping files).
    use_native: bool = True


@dataclass
class EngineOptions:
    """TPU execution knobs (no reference analogue; results are invariant)."""

    # Data-parallel shards over the read axis; None → all local devices.
    num_shards: int | None = None
    # Pad record batches to multiples of this (static shapes for jit).
    batch_pad: int = 8192
    # Use the native C++ decoder when available.
    use_native: bool = True
    # Fetch the full coverage histograms to the host (needed for -ro/-co
    # reports and oracle-parity checks; the hot path only needs the small
    # per-contig stats).
    fetch_coverage: bool = True
    # Directory mode: files profiled per fused device dispatch (a jit'ed
    # lax.scan over the file axis; amortizes the per-dispatch round trip).
    files_per_dispatch: int = 8
    # Whole-file mode: overlap decode with the host->device record upload
    # for files at least this large (bytes) by streaming fixed-size v2
    # pieces to the device during decode and fusing them in ONE dispatch.
    # 0 disables the overlap path.
    overlap_min_bytes: int = 64 << 20
    # Targets per uploaded piece in the overlap path (multiple of 2048).
    # At the default value the engine auto-scales it UP on large files so
    # the final dispatch stays under ~64 pieces; any explicit value is
    # honored exactly.
    overlap_piece_targets: int = 262144
    # Chunk-streaming decode+profile: targets per device chunk (0 = off,
    # whole-file single dispatch).  Bounds device memory for files whose
    # record arrays exceed HBM and overlaps decode with dispatch; requires
    # qname-grouped input (falls back to whole-file otherwise).
    stream_chunk: int = 0
    # Streaming: keep uploaded chunk arrays device-resident up to this many
    # bytes so pass B skips the host->device re-transfer; chunks past the
    # budget re-upload from host copies (device memory stays bounded).
    stream_device_cache_bytes: int = 2 << 30
    # Billion-read scale mode: intern read keys as 64-bit hashes instead of
    # storing the name arena (~12 B/read vs ~40+).  Distinct names that
    # collide on the hash merge into one read (birthday bound ~3% chance of
    # a single merged pair at 1e9 reads) — opt-in, off by default.
    hash_read_names: bool = False
    # Emit a jax.profiler trace directory when set.
    trace_dir: str | None = None
    # Per-phase timing log to stderr, same shape as the reference.
    phase_log: bool = True
