"""Sharded chunk streaming: counterpart of slimm_tpu/parallel/streaming.py.

The piece loop is engine.pipeline.profile_file_streaming's: each decoded
piece is routed over the runner's data shards on its home device, and every
(data, model) shard adds its part's pass A into accumulators of its own,
with no merge per piece.  The merges come once per pass, after EOF, as in
the JAX package (streaming.py:17-24): the pass-A partials before the
cutoffs, the pass-B outputs before packing.  Parts stay on the device up to
the device-cache budget and are uploaded again for pass B past it
(streaming.py:237-242, 369-370).

Across processes (MultiHostRunner) each process streams its own input of
complete reads; process 0's sampled average read length is broadcast so
that every process bins alike (streaming.py:486-493), and the totals are
summed before the early return on no hits (184-190).  Each process plans
its own pieces: eager dispatch has no static shapes to agree on, so the
JAX per-round plan agreement (`chunk_plan`) has no counterpart.
"""

from __future__ import annotations

from ..config import EngineOptions, ProfileOptions
from ..database import SlimmDatabase
from ..state import ProfileState

from ..engine.pipeline import profile_file_streaming


def profile_file_streaming_sharded(options: ProfileOptions,
                                   db: SlimmDatabase, path: str, runner,
                                   engine: EngineOptions | None = None,
                                   chunk_targets: int | None = None
                                   ) -> ProfileState:
    """The JAX package's entry point: profile_file_streaming over the grid
    of `runner` (ShardedRunner or MultiHostRunner)."""
    return profile_file_streaming(options, db, path, engine=engine,
                                  chunk_targets=chunk_targets,
                                  sharded_runner=runner)
