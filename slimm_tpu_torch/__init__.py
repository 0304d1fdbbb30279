"""slimm_tpu_torch — the profiler in PyTorch, with CUDA kernels for Hopper.

A port of slimm_tpu; slimm_tpu stays the reference it is held to.  Nothing
here imports jax or anything of slimm_tpu: the host layer (options,
database, profile state, oracle, taxonomy, decoders, collect) is the port's
own copy of slimm_tpu's, each module naming its source at its top.

Layout:
  cli              `python -m slimm_tpu_torch profile|build|collect`
  config, database, state, oracle, taxonomy, io, tools.collect
                   the host layer (copies)
  tables           the per-contig and taxonomy tables on the device
  engine.pipeline  pass A, cutoffs, pass B, packing, host glue
  engine.reports   the TSV writers
  ops.hist         hist1 / hist2: plain PyTorch versions, CUDA wrappers and
                   their launch plan
  csrc/hist.cu     the Hopper histogram kernels (built at first use)
  parallel         sharded and multi-process profiles
  utils            CUDA-event timing, phase timers, the bench workload
"""

__version__ = "0.1.0"
