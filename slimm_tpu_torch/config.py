# Copied from slimm_tpu/config.py (the port imports nothing of slimm_tpu).
"""Configuration dataclasses.

One dataclass per CLI surface, mirroring the reference option names and
defaults exactly (profiler: src/slimm.cpp:60-180 + slimm.hpp:75-86;
builder: src/slimm_build.cpp:54-114).  No config files / env vars in the
reference; EngineOptions holds the port's execution settings, which do not
change results.
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
    """How the port runs a profile (no reference analogue; results are
    invariant).  The grid of devices is the caller's: `--shards` builds a
    ShardedRunner (slimm_tpu_torch.parallel)."""

    # Quantum of the streamed path's piece cap: chunk targets are rounded
    # up from it in 1.25x steps (engine.pipeline._bucket).
    batch_pad: int = 8192
    # Decode with the native C++ decoder (built at first use; a failed
    # build raises); False takes the pure-Python reference decoder.
    use_native: bool = True
    # Fetch the full coverage histograms to the host (needed for -ro/-co
    # reports and oracle-parity checks; the hot path only needs the small
    # per-contig stats).
    fetch_coverage: bool = True
    # Directory mode: files profiled as one (engine.pipeline.
    # profile_files_batched: one profile per group of files with one
    # header, so one launch per histogram and one cutoff sync a group).
    files_per_dispatch: int = 8
    # Whole-file mode: files at least this large (bytes) take the overlap
    # path, pass A on each v2 piece on the device while the decoder goes
    # on with the rest; 0 turns it off.
    overlap_min_bytes: int = 64 << 20
    # Targets per uploaded piece in the overlap path (multiple of 2048).
    # At the default value it is scaled UP on large files so that a file
    # makes at most ~56 pieces; any explicit value is used exactly.
    overlap_piece_targets: int = 262144
    # Chunk-streaming decode+profile (profile_file_streaming): targets per
    # piece (0 = off, the whole-file path).  Bounds device memory for
    # files whose records exceed it, and overlaps decode with pass A;
    # falls back to the whole-file path where the input stops being
    # qname-grouped partway.
    stream_chunk: int = 0
    # Streaming: keep uploaded pieces on the device up to this many bytes
    # so pass B skips the host->device copy; pieces past the budget are
    # uploaded again from host copies (device memory stays bounded).
    stream_device_cache_bytes: int = 2 << 30
    # Billion-read scale mode: intern read keys as 64-bit hashes instead of
    # storing the name arena (~12 B/read vs ~40+).  Distinct names that
    # collide on the hash merge into one read (birthday bound ~3% chance of
    # a single merged pair at 1e9 reads) — opt-in, off by default.
    hash_read_names: bool = False
    # Write a torch.profiler Chrome trace per input file here when set (the
    # CLI's --trace-dir).
    trace_dir: str | None = None
    # Per-phase timing log to stderr, same shape as the reference.
    phase_log: bool = True
