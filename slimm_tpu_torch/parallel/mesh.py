"""Device grids and read routing: counterpart of slimm_tpu/parallel/mesh.py.

The profile is data-parallel over READS (every record of a read stays on
one data shard, so per-read dedup, uniqueness and the LCA are shard-local)
and may split the bin axis over model shards.  A grid is a (data, model)
list of lists of torch.devices; the same device may appear more than once,
which is how one card runs every sharded path.
"""

from __future__ import annotations

import torch

# the Fibonacci multiplier 0x9E3779B97F4A7C15 as an int64
_FIB = 0x9E3779B97F4A7C15 - (1 << 64)


# slimm_tpu/parallel/mesh.py:18-30 (its module imports jax), on torch tensors
def route_shard(read_id: torch.Tensor, S: int) -> torch.Tensor:
    """Shard assignment (int64 in [0, S)) for each record's read: a
    multiplicative hash of the read id instead of plain `read_id % S`, so
    periodic inputs (multi-hit reads recurring every S reads, .1/.2 pair
    keys in lock-step) spread over the shards.  Routing never affects
    results: the merges are exact integer sums.

    The JAX package hashes in uint64; here the int64 product wraps to the
    same bits, and the mask turns the arithmetic shift into a logical one."""
    h = read_id.to(torch.int64) * _FIB
    h = (h >> 17) & ((1 << 47) - 1)
    return h % S


def device_grid(data: int, model: int = 1, device="cuda") -> list:
    """A (data, model) grid of torch.devices: `cuda:0 .. cuda:n-1` for cuda,
    raising ValueError past torch.cuda.device_count() (make_mesh and
    make_mesh2, mesh.py:33-56); `cpu` repeated for cpu."""
    device = torch.device(device)
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"shard counts must be positive, got data={data} "
                         f"model={model}")
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"requested {n} devices ({data} data x {model} "
                             f"model shards), have {have} CUDA devices")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif device.type == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        raise ValueError(f"unsupported device {device}")
    return [devs[d * model:(d + 1) * model] for d in range(data)]
