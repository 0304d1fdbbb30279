"""Multi-process runs over torch.distributed: counterpart of
slimm_tpu/parallel/multihost.py.

Every process decodes its own input (whole files, or a file of complete
reads), so per-read dedup, uniqueness and the LCA stay process-local, and
the merged quantities are integer sums: `all_reduce(SUM)` after the local
merges of engine.pipeline._core_after_a (the pair presence as an int32
count).  Every process issues the same collectives in the same order, one
with no records included, so N processes give the profile of one.  Each
process holds the merged results and can write the reports.

In code: `initialize()` in every process, then `MultiHostRunner()` as the
`sharded_runner` of engine.pipeline's profile functions, each process
giving its own reads.  Both default to the card: NCCL, and the GPU
cuda:LOCAL_RANK.  A run on the CPU asks for it,
`initialize(backend="gloo")` and `MultiHostRunner(devices=["cpu"])`, and
without a GPU the defaults raise.  The launcher, one command per process,

    python -m slimm_tpu_torch.parallel.multihost \\
        --init-method tcp://host0:29500 --world-size 4 --rank $RANK -- \\
        profile DB.sldb reads_dir -d -o out/

is the reference's thin wrapper: it initialises the process group and runs
the ordinary CLI, which reaches neither MultiHostRunner nor shard_paths, so
every process profiles every input (ROADMAP C2).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .runner import ShardedRunner


def _local_gpu(rank: int) -> torch.device:
    """cuda:LOCAL_RANK (else the global rank); raises without a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: multi-process runs default to NCCL on the GPU; "
            "ask for the CPU with initialize(backend='gloo') and "
            "MultiHostRunner(devices=['cpu'])")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))


def initialize(backend: str = "nccl", init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None
               ) -> None:
    """torch.distributed.init_process_group with this repository's
    defaults: world size and rank from WORLD_SIZE and RANK when not given,
    `env://` as the init method, NCCL with each process on its GPU
    cuda:LOCAL_RANK.  gloo runs only when `backend` asks for it."""
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if backend == "nccl":
        torch.cuda.set_device(_local_gpu(rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def shard_paths(paths: list, rank: int | None = None,
                world_size: int | None = None) -> list:
    """Directory mode: round-robin file assignment across processes."""
    if rank is None or world_size is None:
        on = dist.is_initialized()
        rank = (dist.get_rank() if on else 0) if rank is None else rank
        world_size = ((dist.get_world_size() if on else 1)
                      if world_size is None else world_size)
    return [p for i, p in enumerate(paths) if i % world_size == rank]


def _all_reduce(x: torch.Tensor) -> None:
    dist.all_reduce(x, op=dist.ReduceOp.SUM)


class MultiHostRunner(ShardedRunner):
    """`sharded_runner` spanning every process of the initialized group.

    Each process feeds the records of ITS reads only (read ids local to the
    process) and runs them on `devices`, its data shards (default: one, the
    process's GPU cuda:LOCAL_RANK; the CPU only when given, as "cpu").
    Without an initialized group it is a one-process ShardedRunner."""

    def __init__(self, devices=None):
        if devices is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
            devices = [_local_gpu(rank)]
        super().__init__(devices=[[torch.device(d)] for d in devices])
        self.distributed = dist.is_available() and dist.is_initialized()
        self.reduce = _all_reduce if self.distributed else None
        self._dev = self.devices[0][0]

    def broadcast(self, value: int) -> int:
        """Process 0's value, on every process."""
        if not self.distributed:
            return value
        x = torch.tensor([value], dtype=torch.int64, device=self._dev)
        dist.broadcast(x, src=0)
        return int(x.item())

    def sum_totals(self, *values) -> tuple:
        """The sums of integer totals over the processes."""
        if not self.distributed:
            return values
        x = torch.tensor(values, dtype=torch.int64, device=self._dev)
        _all_reduce(x)
        return tuple(int(v) for v in x.tolist())


def main(argv=None):
    """Per-process CLI launcher: initialize the process group, then run the
    ordinary `slimm_tpu_torch` CLI (multihost.py:192-210)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="slimm_tpu_torch.parallel.multihost")
    p.add_argument("--init-method", default=None,
                   help="tcp://host:port of process 0 (default env://)")
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                   help="the process group's backend (default nccl, on the "
                        "GPUs; gloo for a run with --device cpu)")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- followed by the ordinary slimm_tpu_torch CLI "
                        "arguments")
    args = p.parse_args(argv)

    world = (int(os.environ.get("WORLD_SIZE", 1)) if args.world_size is None
             else args.world_size)
    if world > 1:
        initialize(args.backend, args.init_method, world, args.rank)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    from ..cli import main as cli_main
    try:
        rc = cli_main(rest)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(rc)


if __name__ == "__main__":
    main()
