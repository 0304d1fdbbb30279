"""Command-line front-end of the port: `python -m slimm_tpu_torch`.

  profile  — the profiler on one device (`--device cuda`, the default, or
             `--device cpu`); the options of slimm_tpu's profile parser
  build    — slimm_tpu.cli.cmd_build, unchanged
  collect  — slimm_tpu.cli.cmd_collect, unchanged

A missing GPU under `--device cuda` is an error, never a silent run on the
CPU.  `--stream N` profiles each file by chunk streaming; files of 64 MB or
more take the overlap path by default.  `--shards D` / `--model-shards M`
above 1 profile over a (data x model) grid of devices
(slimm_tpu_torch.parallel): cuda:0 .. cuda:D*M-1, more than the host has
being an error, or the CPU D*M times over with `--device cpu`.  The option
of slimm_tpu's parser that the port does not have yet (`--trace-dir`) is
refused.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

from slimm_tpu.cli import (_print_filter_stat, _print_matches_stat,
                           build_build_parser, build_collect_parser,
                           build_profile_parser, cmd_build, cmd_collect)
from slimm_tpu.config import EngineOptions, ProfileOptions

from . import __version__


def _not_ported(args) -> str | None:
    """The first given option that belongs to a later part of the port."""
    if args.trace_dir is not None:
        return "--trace-dir"
    return None


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


def cmd_profile(args) -> int:
    option = _not_ported(args)
    if option is not None:
        print(f"[ERROR] {option} is not yet ported to slimm_tpu_torch",
              file=sys.stderr)
        return 1
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

    from slimm_tpu.database import SlimmDatabase
    from slimm_tpu.io import AlignmentFile, collect_bam_files
    from slimm_tpu.io.files import get_directory
    from slimm_tpu.oracle import OracleProfiler
    from slimm_tpu.utils.timer import Timer

    from .engine.pipeline import profile_file, profile_file_streaming
    from .engine.reports import write_abundance, write_coverage, write_raw_stat

    options = ProfileOptions(
        database_path=args.DB, input_path=args.IN,
        output_prefix=args.output_prefix if args.output_prefix is not None
        else args.IN,
        bin_width=args.bin_width, min_reads=args.min_reads, rank=args.rank,
        cov_cut_off=args.cov_cut_off, abundance_cut_off=args.abundance_cut_off,
        is_directory=args.directory, raw_output=args.raw_output,
        coverage_output=args.coverage_output, verbose=args.verbose)
    # the bin-resolution histograms are only needed for -ro/-co output
    engine = EngineOptions(fetch_coverage=args.raw_output
                           or args.coverage_output,
                           stream_chunk=args.stream,
                           hash_read_names=args.hash_read_names)
    device = torch.device(args.device)

    stop_watch = Timer()
    paths = collect_bam_files(options.input_path, options.is_directory,
                              options.verbose)
    db = SlimmDatabase.load(options.database_path)

    total_hits = 0
    for n, path in enumerate(paths):
        print(f"\nReading {n + 1} of {len(paths)} files ... "
              f"({path.rsplit('/', 1)[-1]})\n"
              "=================================================================",
              file=sys.stderr)
        per_file_options = copy.deepcopy(options)
        if args.no_device:
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
    except (ValueError, OSError, ZeroDivisionError) as e:
        # decode/DB errors surface as a message + exit 1 (slimm_tpu.cli)
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
