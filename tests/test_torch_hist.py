"""slimm_tpu_torch.ops.hist against the JAX histograms: the plain PyTorch
versions (what the wrappers run on CPU tensors) against `mxu_hist` /
`mxu_hist2` in interpret mode, `_reference_hist` and the engine's `_hist2`.
Every comparison is exact: the histograms are integer counts."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimm_tpu.engine.pipeline import _hist2
from slimm_tpu.ops.hist import CHUNK, _reference_hist, mxu_hist, mxu_hist2
from slimm_tpu_torch.ops import _build
from slimm_tpu_torch.ops import hist as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,density", [(0, 0.9), (1, 0.0), (2, 1.0)])
def test_hist2_matches_mxu_hist2(seed, density):
    rng = np.random.default_rng(seed)
    n, bp = 4 * CHUNK, 2048
    idx = rng.integers(0, bp, n).astype(np.int32)
    w1 = rng.random(n) < density
    w2 = rng.random(n) < 0.5
    j1, j2 = mxu_hist2(jnp.asarray(idx), jnp.asarray(w1), jnp.asarray(w2),
                       n_bins_pad=bp, interpret=True)
    h1, h2 = th.hist2(_t(idx), _t(w1), _t(w2), bp)
    assert h1.dtype == h2.dtype == torch.int32
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(
        h1.numpy(), np.asarray(_reference_hist(jnp.asarray(idx),
                                               jnp.asarray(w1), bp)))


@pytest.mark.parametrize("seed,density", [(3, 0.7), (4, 0.0), (5, 1.0)])
def test_hist1_matches_mxu_hist(seed, density):
    rng = np.random.default_rng(seed)
    n, bp = 2 * CHUNK, 1024
    idx = rng.integers(0, bp, n).astype(np.int32)
    w = rng.random(n) < density
    j = mxu_hist(jnp.asarray(idx), jnp.asarray(w), n_bins_pad=bp,
                 interpret=True)
    h = th.hist1(_t(idx), _t(w), bp)
    np.testing.assert_array_equal(h.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(_reference_hist(jnp.asarray(idx),
                                              jnp.asarray(w), bp)))


def test_hist1_heavy_bin_counts():
    # one bin taking > 127 hits (the int8 one-hot limit of the TPU kernel)
    n, bp = CHUNK, 1024
    idx = np.zeros(n, np.int32)
    w = np.ones(n, bool)
    j = mxu_hist(jnp.asarray(idx), jnp.asarray(w), n_bins_pad=bp,
                 interpret=True)
    h = th.hist1(_t(idx), _t(w), bp)
    np.testing.assert_array_equal(h.numpy(), np.asarray(j))
    assert int(h[0]) == n and int(h[1:].sum()) == 0


def test_hist2_deep_bin_matches_engine_scatter():
    # >= 2^16 hits in one bin: the JAX engine's packed 16|16 scatter
    # overflows and falls back; the port counts in int32 directly
    bp = 1024
    rng = np.random.default_rng(4)
    n = 80_000
    idx = np.full(n, 3, np.int32)
    idx[70_000:] = rng.integers(0, bp, n - 70_000)
    w1 = np.ones(n, bool)
    w2 = rng.random(n) < 0.4
    j1, j2 = _hist2(jnp.asarray(idx), jnp.asarray(w1), jnp.asarray(w2), bp,
                    use_pallas=False)
    h1, h2 = th.hist2(_t(idx), _t(w1), _t(w2), bp)
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2))
    assert int(h1[3]) == 70_000 + int((idx[70_000:] == 3).sum())


def test_out_of_range_indices_dropped():
    # negative and too-large indices with a true weight add nothing (the
    # JAX scatter's mode="drop"; the TPU kernel's one-hots miss them)
    rng = np.random.default_rng(6)
    n, bp = 2 * CHUNK, 1024
    idx = rng.integers(-600, bp + 600, n).astype(np.int32)
    w = rng.random(n) < 0.8
    keep = w & (idx >= 0) & (idx < bp)
    want = np.bincount(idx[keep], minlength=bp).astype(np.int32)
    j = mxu_hist(jnp.asarray(idx), jnp.asarray(w), n_bins_pad=bp,
                 interpret=True)
    np.testing.assert_array_equal(np.asarray(j), want)
    np.testing.assert_array_equal(th.hist1(_t(idx), _t(w), bp).numpy(), want)
    h1, h2 = th.hist2(_t(idx), _t(w), _t(~w), bp)
    np.testing.assert_array_equal(h1.numpy(), want)
    keep2 = ~w & (idx >= 0) & (idx < bp)
    np.testing.assert_array_equal(
        h2.numpy(), np.bincount(idx[keep2], minlength=bp))


def test_wrappers_reject_bad_inputs():
    idx = torch.zeros(8, dtype=torch.int32)
    w = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        th.hist1(idx.to(torch.int64), w, 4)
    with pytest.raises(ValueError):
        th.hist1(idx, w.to(torch.uint8), 4)
    with pytest.raises(ValueError):
        th.hist2(idx, w, w[:4], 4)
    with pytest.raises(ValueError):
        th.hist1(idx[::2], w[::2], 4)
    with pytest.raises(ValueError):
        th.hist1(idx.to("meta"), w.to("meta"), 4)


def test_cpu_import_needs_no_nvcc():
    # importing the ops and running them on CPU tensors neither builds the
    # kernels nor looks for nvcc: run with nvcc out of reach
    code = (
        "import sys, torch\n"
        "from slimm_tpu_torch.ops import hist\n"
        "i = torch.tensor([0, 2, 2, 5], dtype=torch.int32)\n"
        "w = torch.tensor([1, 1, 0, 1], dtype=torch.bool)\n"
        "assert hist.hist1(i, w, 4).tolist() == [1, 0, 1, 0]\n"
        "a, b = hist.hist2(i, w, ~w, 4)\n"
        "assert a.tolist() == [1, 0, 1, 0] and b.tolist() == [0, 0, 1, 0]\n"
        "assert hist.hist1_launches == hist.hist2_launches == 0\n"
        "assert 'slimm_tpu_torch.ops._build' not in sys.modules\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_without_nvcc_raises(monkeypatch):
    # no nvcc: the build is an error, not a fallback
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_path_keyed_by_source_hash():
    path = _build.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "slimm_tpu_torch",
                                                 "_build")
    assert path == _build.library_path()
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# -- the launch plan (ops/hist.py launch_plan; csrc/hist.cu's variants) -------

H100 = dict(sms=132, smem_limit=232_448)


@pytest.mark.parametrize("n,n_bins,hists,variant,blocks", [
    # whole-file main path, 8M records: pass B [contigs | taxa] and the pair
    # presence (1,000 contigs: 37,888 bins) in shared memory, pass A and the
    # -ro/-co [uniq_cov2 | taxa] domain with global atomics
    (8_000_000, 1_024, 1, "shared", 264),
    (8_000_000, 7_103, 1, "shared", 264),
    (8_000_000, 37_888, 1, "shared", 132),
    (8_000_000, 396_190, 2, "global", 264),
    (8_000_000, 403_243, 1, "global", 264),
    (8_000_000, 8_366_436, 2, "global", 264),
    (8_000_000, 16_384, 2, "shared", 132),
    # an overlap-path piece: one quad per thread on 64 blocks
    (1 << 18, 1_024, 1, "shared", 64),
    (1 << 18, 7_103, 1, "shared", 64),
    (1 << 18, 37_888, 1, "shared", 64),
    (1 << 18, 57_000, 1, "global", 64),
    (1 << 18, 396_190, 2, "global", 64),
    (1 << 18, 403_243, 1, "global", 64),
    (1 << 18, 8_366_436, 2, "global", 64),
    # a toy file: too few records per bin for a private histogram
    (1_000, 1_024, 1, "global", 1),
])
def test_launch_plan_variants(n, n_bins, hists, variant, blocks):
    plan = th.launch_plan(n, n_bins, hists, **H100)
    assert th.VARIANT_NAMES[plan.variant] == variant
    assert plan.blocks == blocks and plan.threads == th.THREADS == 1024
    word = 4 * hists
    assert plan.smem == (n_bins * word if variant == "shared" else 0)


def test_launch_plan_stays_within_limits():
    rng = np.random.default_rng(12)
    for _ in range(2000):
        n = int(rng.integers(1, 1 << 24))
        n_bins = int(rng.integers(1, 1 << 23))
        hists = int(rng.integers(1, 3))
        sms = int(rng.integers(1, 200))
        smem_limit = int(rng.integers(1 << 10, 1 << 18))
        plan = th.launch_plan(n, n_bins, hists, sms, smem_limit)
        assert 0 <= plan.smem <= smem_limit
        assert 1 <= plan.blocks <= max(1, sms * 2)
        # no more threads than one quad of records each, beyond one block
        assert plan.blocks == 1 or plan.blocks * plan.threads * 4 < n + 4096
        if plan.variant == th.SHARED:
            assert plan.smem == n_bins * 4 * hists
            resident = (smem_limit + 1024) // (plan.smem + 1024)
            assert plan.blocks <= sms * min(2, resident)
        else:
            assert plan.variant == th.GLOBAL and plan.smem == 0
