"""slimm_tpu_torch — the profiler in PyTorch, with CUDA kernels for Hopper.

A port of slimm_tpu's device path; slimm_tpu stays the reference it is held
to.  The host layer (options, database, profile state, oracle, decoders,
report rows) is slimm_tpu's own jax-free code, imported as it is; nothing
here imports jax or slimm_tpu.engine / ops / parallel.

Layout:
  cli              `python -m slimm_tpu_torch profile|build|collect`
  tables           the per-contig and taxonomy tables on the device
  engine.pipeline  pass A, cutoffs, pass B, packing, host glue
  engine.reports   the TSV writers
  ops.hist         hist1 / hist2: plain PyTorch versions + CUDA wrappers
  csrc/hist.cu     the Hopper histogram kernels (built at first use)
  utils.devbench   CUDA-event timing
"""

__version__ = "0.1.0"
