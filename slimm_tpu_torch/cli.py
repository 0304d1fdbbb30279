"""Command-line front-end of the port: `python -m slimm_tpu_torch`.

  profile  — the profiler on one device (`--device cuda`, the default, or
             `--device cpu`); the options of slimm_tpu's profile parser
  build    — the DB builder, as slimm_tpu's (the port's own copy)
  collect  — the multi-sample merge, as slimm_tpu's, without pandas

A missing GPU under `--device cuda` is an error, never a silent run on the
CPU.  `--stream N` profiles each file by chunk streaming; files of 64 MB or
more take the overlap path by default.  `--shards D` / `--model-shards M`
above 1 profile over a (data x model) grid of devices
(slimm_tpu_torch.parallel): cuda:0 .. cuda:D*M-1, more than the host has
being an error, or the CPU D*M times over with `--device cpu`.  `-d` on one
device profiles the directory's files in groups of
`EngineOptions.files_per_dispatch`, each group as one profile
(engine.pipeline.profile_files_batched), as slimm_tpu's `-d` does.  Under
the multi-process launcher (`python -m slimm_tpu_torch.parallel.multihost`)
each process profiles its round-robin share of the directory's files, and
a single input file is profiled by process 0 alone.  `--trace-dir DIR`
runs each file's profile inside torch.profiler and writes one Chrome trace
per input into DIR (CUDA activity too on the card); it profiles file by
file, as in slimm_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys

from . import __version__
from .config import BuildOptions, EngineOptions, ProfileOptions
from .taxonomy import RANK_LIST


# copied from slimm_tpu/cli.py:21-123 (parsers) and 291-340 (stats, build,
# collect)
def _range_float(lo, hi):
    def parse(s):
        v = float(s)
        if not (lo <= v <= hi):
            raise argparse.ArgumentTypeError(
                f"value {v} not in range [{lo}, {hi}]")
        return v
    return parse


def build_profile_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser(
        "profile",
        help="Species Level Identification of Microbes from Metagenomes",
        description="Taxonomic profiling of SAM/BAM alignments against a "
                    ".sldb database (PyTorch engine).")
    p.add_argument("DB", help="taxonomy database (.sldb or .sldb.npz)")
    p.add_argument("IN", help="SAM/BAM file (or directory with -d)")
    p.add_argument("-o", "--output-prefix", default=None,
                   help="output path prefix.")
    p.add_argument("-w", "--bin-width", type=int, default=0,
                   help="Set the width of a single bin in neuclotides.")
    p.add_argument("-mr", "--min-reads", type=int, default=0,
                   help="Minimum number of matching reads to consider a "
                        "reference present.")
    p.add_argument("-r", "--rank", default="species", choices=RANK_LIST,
                   help="The taxonomic rank of identification")
    p.add_argument("-cc", "--cov-cut-off", type=_range_float(0.0, 1.0),
                   default=0.95,
                   help="the quantile of coverages to use as a cutoff "
                        "smaller value means bigger threshold.")
    p.add_argument("-ac", "--abundance-cut-off", type=_range_float(0.0, 10.0),
                   default=0.01, help="do not report abundances below this value")
    p.add_argument("-d", "--directory", action="store_true",
                   help="Input is a directory.")
    p.add_argument("-ro", "--raw-output", action="store_true",
                   help="Output raw reference statstics")
    p.add_argument("-co", "--coverage-output", action="store_true",
                   help="Output raw coverage statstics")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Enable verbose output.")
    # execution knobs (no reference analogue; results are invariant)
    p.add_argument("--shards", type=int, default=None,
                   help="data-parallel device shards (default: all devices)")
    p.add_argument("--hash-read-names", action="store_true",
                   help="intern read names as 64-bit hashes (billion-read "
                        "scale mode: ~1/4 the dictionary memory; colliding "
                        "names merge, ~3%% chance of one merged pair at "
                        "1e9 reads)")
    p.add_argument("--stream", type=int, default=0, metavar="TARGETS",
                   help="chunk-streaming decode+profile with this many "
                        "alignment targets per device chunk (bounds device "
                        "memory for huge files; 0 = whole-file dispatch)")
    p.add_argument("--model-shards", type=int, default=1,
                   help="shard the coverage-state bin axis over this many "
                        "devices (for databases whose bin tables exceed "
                        "one device; results are bit-identical)")
    p.add_argument("--no-device", action="store_true",
                   help="run the scalar oracle instead of the device engine")
    p.add_argument("--trace-dir", default=None,
                   help="write a profiler trace here")
    p.add_argument("--json-stats", default=None,
                   help="append one JSON line of counters per input file "
                        "(structured observability alongside the reference's "
                        "stderr phase log)")
    return p


def build_build_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser(
        "build",
        help="gets a reduced taxonomic information given a multi-fasta file "
             "using accession numbers")
    p.add_argument("FASTA", help="A multi-fasta file used as a reference "
                                 "for mapping")
    p.add_argument("ACC2TAXID", nargs="+",
                   help="one or more accession to taxa id mapping files "
                        "downloaded from ncbi (separated by space.)")
    p.add_argument("-o", "--output-file", default="slimm_db.sldb",
                   help="The path to the output file (default slimm_db.sldb)")
    p.add_argument("-nm", "--names", required=True,
                   help="NCBI's names.dmp file which contains the mapping "
                        "of taxaid to name")
    p.add_argument("-nd", "--nodes", required=True,
                   help="NCBI's nodes.dmp file which contains the taxonomic "
                        "tree.")
    p.add_argument("-b", "--batch", type=int, default=1000000,
                   help="maximum number of mapping to load to memory. "
                        "(default=1000000)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Enable verbose output.")
    return p


def build_collect_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("collect",
                       help="merge multiple _profile.tsv files into "
                            "merged_profile.tsv")
    p.add_argument("PROFILES", nargs="+", help="per-sample _profile.tsv files")
    p.add_argument("-o", "--output", default="merged_profile.tsv")
    return p


def _print_matches_stat(state) -> None:
    # (slimm.hpp:621-630)
    print(f"  {state.hits_count} records processed.", file=sys.stderr)
    print(f"    {state.matches_count} matching reads", file=sys.stderr)
    print(f"    {state.uniq_matches_count} uniquily matching reads",
          file=sys.stderr)
    print(f"  references with reads = {state.reference_count}", file=sys.stderr)
    print(f"  expected bins coverage = {state.expected_coverage():.6g}",
          file=sys.stderr)
    print(f"  bins coverage cut-off = {state.coverage_cut_off():.6g} "
          f"({state.options.cov_cut_off} quantile)", file=sys.stderr)
    print(f"  uniq bins coverage cut-off = {state.uniq_coverage_cut_off():.6g}"
          f" ({state.options.cov_cut_off} quantile)\n", file=sys.stderr)


def _print_filter_stat(state) -> None:
    # (slimm.hpp:613-619)
    print(f"  {len(state.valid_ref_ids)} passed the threshould coverage.",
          file=sys.stderr)
    print(f"  {state.failed_byCov} ref's couldn't pass the coverage "
          "threshould.", file=sys.stderr)
    print(f"  {state.failed_byUniqCov} ref's couldn't pass the uniq coverage "
          "threshould.", file=sys.stderr)
    print(f"  uniquily matching reads increased from "
          f"{state.uniq_matches_count} to {state.uniq_matches_count2}\n",
          file=sys.stderr)


def cmd_build(args) -> int:
    from .database import build_database

    options = BuildOptions(
        fasta_path=args.FASTA, ac__taxid_paths=args.ACC2TAXID,
        names_path=args.names, nodes_path=args.nodes,
        output_path=args.output_file, batch=args.batch, verbose=args.verbose)
    db = build_database(options)
    db.save_sldb(options.output_path)
    db.save_npz(options.output_path + ".npz")
    print(f"[MSG] database written to {options.output_path} "
          f"(+ .npz cache)", file=sys.stderr)
    return 0


def cmd_collect(args) -> int:
    from .tools.collect import collect_profiles

    collect_profiles(args.PROFILES, args.output)
    return 0


@contextlib.contextmanager
def _traced(trace_dir, path, cuda):
    """The body inside torch.profiler, then its Chrome trace written to
    <trace_dir>/<input file name>.pt.trace.json: the counterpart of
    slimm_tpu's jax.profiler.start_trace/stop_trace around each file
    (slimm_tpu/cli.py:223-246).  CPU activity always, CUDA activity with
    `cuda`.  A trace that cannot be written raises OSError."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    out = os.path.join(trace_dir, os.path.basename(path) + ".pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(out)
    if not os.path.isfile(out):
        raise OSError(f"--trace-dir: no trace written to {out}")


def _json_stats(state, path) -> dict:
    return {
        "file": path,
        "hits_count": state.hits_count,
        "matches_count": state.matches_count,
        "uniq_matches_count": state.uniq_matches_count,
        "uniq_matches_count2": state.uniq_matches_count2,
        "reference_count": state.reference_count,
        "valid_refs": len(state.valid_ref_ids),
        "failed_by_cov": state.failed_byCov,
        "failed_by_uniq_cov": state.failed_byUniqCov,
        "failed_by_min_read": state.failed_by_min_read,
        "avg_read_length": state.avg_read_length,
        "coverage_cut_off": float(state.coverage_cut_off()),
        "uniq_coverage_cut_off": float(state.uniq_coverage_cut_off()),
    }


def _process_share() -> tuple:
    """(rank, world size) of this process's torch.distributed group, set up
    by the launcher (parallel/multihost.py); (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def cmd_profile(args) -> int:
    import torch

    if not args.no_device and args.device == "cuda" \
            and not torch.cuda.is_available():
        print("[ERROR] --device cuda: no CUDA device is available "
              "(run with --device cpu to profile on the CPU)", file=sys.stderr)
        return 1

    runner = None
    if not args.no_device and ((args.shards is not None and args.shards > 1)
                               or args.model_shards > 1):
        # slimm_tpu/cli.py:184-190; a grid past the device count raises
        from .parallel import ShardedRunner
        runner = ShardedRunner(num_shards=args.shards,
                               model_shards=args.model_shards,
                               device=args.device)

    from .database import SlimmDatabase
    from .engine.pipeline import (profile_file, profile_file_streaming,
                                  profile_files_batched)
    from .engine.reports import write_abundance, write_coverage, write_raw_stat
    from .io import AlignmentFile, collect_bam_files
    from .io.files import get_directory
    from .oracle import OracleProfiler
    from .utils.timer import Timer

    options = ProfileOptions(
        database_path=args.DB, input_path=args.IN,
        output_prefix=args.output_prefix if args.output_prefix is not None
        else args.IN,
        bin_width=args.bin_width, min_reads=args.min_reads, rank=args.rank,
        cov_cut_off=args.cov_cut_off, abundance_cut_off=args.abundance_cut_off,
        is_directory=args.directory, raw_output=args.raw_output,
        coverage_output=args.coverage_output, verbose=args.verbose)
    # the bin-resolution histograms are only needed for -ro/-co output
    engine = EngineOptions(trace_dir=args.trace_dir,
                           fetch_coverage=args.raw_output
                           or args.coverage_output,
                           stream_chunk=args.stream,
                           hash_read_names=args.hash_read_names)
    device = torch.device(args.device)
    on_card = not args.no_device and device.type == "cuda"

    stop_watch = Timer()
    paths = collect_bam_files(options.input_path, options.is_directory,
                              options.verbose)
    rank, world = _process_share()
    if world > 1:
        # under the multi-process launcher: each process profiles its own
        # share of the inputs, round-robin in collect_bam_files' order; one
        # input file is process 0's
        from .parallel.multihost import shard_paths
        if options.is_directory:
            paths = shard_paths(paths, rank, world)
        elif rank != 0:
            paths = []
        print(f"[MSG] process {rank} of {world}: profiling {len(paths)} of "
              "the input files", file=sys.stderr)
        if not paths:
            return 0
    db = SlimmDatabase.load(options.database_path)

    # directory mode on one device (slimm_tpu/cli.py:195-215): groups of
    # files_per_dispatch files, each profiled as one; grouped by size as
    # slimm_tpu groups them
    batched = None
    if (not args.no_device and runner is None and len(paths) > 1
            and args.trace_dir is None and not engine.stream_chunk):
        batched = {}
        group = max(1, engine.files_per_dispatch)
        by_size = sorted(paths, key=os.path.getsize)
        for i in range(0, len(by_size), group):
            batched.update(profile_files_batched(
                copy.deepcopy(options), db, by_size[i:i + group],
                device=device, engine=engine))

    total_hits = 0
    for n, path in enumerate(paths):
        print(f"\nReading {n + 1} of {len(paths)} files ... "
              f"({path.rsplit('/', 1)[-1]})\n"
              "=================================================================",
              file=sys.stderr)
        per_file_options = copy.deepcopy(options)
        with _traced(args.trace_dir, path, on_card):
            if batched is not None:
                state = batched[path]
            elif args.no_device:
                af = AlignmentFile(path)
                prof = OracleProfiler(per_file_options, db.ac__taxid,
                                      db.taxid__name,
                                      list(zip(af.contig_names,
                                               af.contig_lengths.tolist())))
                state = prof.run(af.raw_records())
            elif engine.stream_chunk:
                state = profile_file_streaming(
                    per_file_options, db, path,
                    device=None if runner else device, engine=engine,
                    sharded_runner=runner)
            else:
                state = profile_file(per_file_options, db, path,
                                     device=None if runner else device,
                                     engine=engine, sharded_runner=runner)
        total_hits += state.hits_count
        if state.hits_count == 0:
            continue
        if options.verbose:
            _print_matches_stat(state)
        if options.raw_output:
            write_raw_stat(state, options.output_prefix, path)
        if options.coverage_output:
            write_coverage(state, options.output_prefix, path)
        write_abundance(state, options.output_prefix, path)
        if options.verbose:
            _print_filter_stat(state)
        if args.json_stats:
            with open(args.json_stats, "a") as jf:
                jf.write(json.dumps(_json_stats(state, path)) + "\n")

    print("\n*****************************************************************",
          file=sys.stderr)
    print(f"{total_hits} SAM/BAM alignment records are proccessed.",
          file=sys.stderr)
    print("Taxonomic profiles are written to: \n   "
          f"{get_directory(options.output_prefix)}", file=sys.stderr)
    print(f"Total time elapsed: {stop_watch.elapsed():.6g} secs",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="slimm-tpu-torch",
        description="SLIMM on PyTorch/CUDA — Species Level Identification of "
                    "Microbes from Metagenomes")
    parser.add_argument("--version", action="version",
                        version=f"slimm-tpu-torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    p = build_profile_parser(sub)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the profile core (default cuda; a "
                        "missing GPU is an error)")
    build_build_parser(sub)
    build_collect_parser(sub)
    args = parser.parse_args(argv)
    try:
        if args.command == "profile":
            return cmd_profile(args)
        if args.command == "build":
            return cmd_build(args)
        return cmd_collect(args)
    except (ValueError, OSError, ZeroDivisionError, OverflowError) as e:
        # decode/DB errors surface as a message + exit 1 (slimm_tpu.cli), as
        # does a bin table past int32 (tables.DeviceTables.from_numpy)
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
