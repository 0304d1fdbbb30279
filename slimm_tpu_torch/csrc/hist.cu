// Histogram kernels for the profiler's coverage and LCA counts (Hopper, sm_90a).
//
// Replaces slimm_tpu/ops/hist.py `mxu_hist2` (pass A: cov + uniq_cov over one
// bin index) and `mxu_hist` (pass B: the [per-contig uniq2 | LCA taxon] counts,
// the [uniq_cov2 | LCA taxon] counts with -ro/-co, and the contig x code pair
// presence).  The TPU kernels rewrite the scatter as int8 one-hot matmuls
// because scatters are slow there and the matrix unit sits idle.  On the H100
// a scatter with integer atomics is the direct form, so nothing of the one-hot
// layout is kept.
//
// Contract (the JAX `mode="drop"` scatter): out[idx[r]] += 1 for every record r
// with w[r] != 0 and 0 <= idx[r] < n_bins; every other record adds nothing.
// Integer atomics are exact and integer addition commutes, so the result is
// bit-equal to the plain torch.bincount version on every run.
//
// What bounds them.  Reading the records is cheap: 8M records of a 4-byte
// index and 1-byte weights are 40-48 MB, 12-15 us at 3.35 TB/s.  Both kernels
// are bound by their atomics instead (times against that bound, the PyTorch
// library call and the earlier design: PERF.md, section 6).
//   slimm_hist2, pass A (396,190 bins at 50 contigs, 8.4M at 1000): one
//     read-modify-write in the L2 per kept record and histogram, spread over
//     a domain far past shared memory.  The design halves them: both counts of
//     a bin live in one 64-bit word (count1 in the low half, count2 in the
//     high half), and a record adds w1 | (w2 << 32) with ONE 64-bit atomic.
//     A count stays below 2^31 (the wrapper refuses n >= 2^31), so the low
//     half never carries into the high half.  A split kernel writes the two
//     int32 outputs.  A domain within one block's shared memory (up to 29k
//     bins) is counted there instead, in two int32 counters per bin: 64-bit
//     shared-memory atomics are compare-and-swap loops.
//   slimm_hist1, pass B (1,024 to 37,888 bins on the default path): atomics
//     on a few hot bins.  About 90% of the default pass-B counts land on the
//     50 contig bins, and the bench's Dirichlet(0.3) contig weights put most
//     of those on a few addresses.  The domain fits shared memory (227 KB
//     hold 58k int32 counters), so every block keeps a private histogram
//     there, zeroed once and flushed once (nonzero bins only) into the
//     output; hot-bin atomics then stay on the SM.  Past shared memory (the
//     -ro/-co [uniq_cov2 | taxa] domain, 403,243 bins) the atomics go to the
//     L2, where one hot address serialises them: there equal bins of a warp
//     step are added once (warp aggregation, __match_any_sync).  In shared
//     memory the match costs more than it saves, on the main path's real
//     input too, so it is not done there.
//
// Variants (kShared, kGlobal), chosen by `launch_plan` of
// slimm_tpu_torch/ops/hist.py, which passes the variant, blocks, threads and
// dynamic shared-memory bytes to the C entry points below.  Every variant
// loads 16 bytes of index (4 records) and 4 bytes of each weight per thread
// and step where the pointers allow it, with several loads in flight per
// thread, on a grid as large as is resident on the card (read once per
// device, slimm_hist_init) but no larger than one quad of records per
// thread: a piece of the overlap path (2^18 records) then spreads over 64
// SMs.  A thread-block-cluster variant for pass A (each block of a 16-block
// cluster owning 1/16 of the bins in distributed shared memory) was measured
// at 2-4 times the packed global variant's time and is not kept.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (slimm_tpu_torch/ops/_build.py).  Python calls the plain C
// functions at the bottom through ctypes; each returns cudaGetLastError()
// after its launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

enum Variant : int { kGlobal = 0, kShared = 1 };

constexpr int kThreads = 1024;   // ops/hist.py THREADS
constexpr int kUnroll = 4;       // quads a lane loads before it adds any

// Calls f(b, x, y) for every record: b its bin, x and y its two weight bytes
// (y is 0 for one histogram).  The loops are warp-uniform (every lane of a
// warp calls f the same number of times, past the end with b = -1), so f may
// use warp-synchronous intrinsics with the full mask.  Records go in quads
// (an int4 of indices and 4 bytes of each weight) where `aligned`, then one
// by one for the tail.  A lane loads kUnroll quads, one grid stride apart,
// before it adds any: at large n that keeps several loads in flight per
// thread, and at small n every thread of the grid gets a quad.
template <int kHists, typename F>
__device__ __forceinline__ void for_each_record(
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ w1,
    const uint8_t* __restrict__ w2, int64_t n, int aligned, F f) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nq = aligned ? n / 4 : 0;
  for (int64_t base = warp * 32; base < nq; base += step * kUnroll) {
    int4 b[kUnroll];
    uint32_t x[kUnroll];
    uint32_t y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = base + u * step + lane;
      b[u] = make_int4(-1, -1, -1, -1);
      x[u] = 0;
      y[u] = 0;
      if (q < nq) {
        b[u] = __ldcs(reinterpret_cast<const int4*>(idx) + q);
        x[u] = __ldcs(reinterpret_cast<const unsigned int*>(w1) + q);
        if constexpr (kHists == 2) {
          y[u] = __ldcs(reinterpret_cast<const unsigned int*>(w2) + q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      f(b[u].x, x[u] & 0xffu, y[u] & 0xffu);
      f(b[u].y, (x[u] >> 8) & 0xffu, (y[u] >> 8) & 0xffu);
      f(b[u].z, (x[u] >> 16) & 0xffu, (y[u] >> 16) & 0xffu);
      f(b[u].w, x[u] >> 24, y[u] >> 24);
    }
  }
  for (int64_t base = nq * 4 + warp * 32; base < n; base += step) {
    const int64_t r = base + lane;
    int32_t b = -1;
    uint32_t x = 0;
    uint32_t y = 0;
    if (r < n) {
      b = idx[r];
      x = w1[r];
      if constexpr (kHists == 2) y = w2[r];
    }
    f(b, x, y);
  }
}

__device__ __forceinline__ bool in_domain(int32_t b, int32_t n_bins) {
  return static_cast<uint32_t>(b) < static_cast<uint32_t>(n_bins);
}

// The packed value of one record: w1 in the low half, w2 in the high half.
__device__ __forceinline__ u64 packed(uint32_t x, uint32_t y) {
  return static_cast<u64>(x != 0) | (static_cast<u64>(y != 0) << 32);
}

// ---- slimm_hist2 -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    hist2_global(const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ w1,
                 const uint8_t* __restrict__ w2, int64_t n,
                 int aligned, u64* __restrict__ acc,
                 int32_t n_bins) {
  for_each_record<2>(idx, w1, w2, n, aligned,
                     [&](int32_t b, uint32_t x, uint32_t y) {
                       const u64 v = packed(x, y);
                       if (v && in_domain(b, n_bins)) atomicAdd(acc + b, v);
                     });
}

__global__ void __launch_bounds__(kThreads)
    hist2_shared(const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ w1,
                 const uint8_t* __restrict__ w2, int64_t n,
                 int aligned, u64* __restrict__ acc,
                 int32_t n_bins) {
  // 64-bit atomics on shared memory are compare-and-swap loops: keep two
  // int32 counters per bin (interleaved) and pack them in the flush
  extern __shared__ uint32_t counts2[];
  for (int i = threadIdx.x; i < 2 * n_bins; i += blockDim.x) counts2[i] = 0;
  __syncthreads();
  for_each_record<2>(idx, w1, w2, n, aligned,
                     [&](int32_t b, uint32_t x, uint32_t y) {
                       if (!in_domain(b, n_bins)) return;
                       if (x) atomicAdd(counts2 + 2 * b, 1u);
                       if (y) atomicAdd(counts2 + 2 * b + 1, 1u);
                     });
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const u64 c = counts2[2 * i] | static_cast<u64>(counts2[2 * i + 1]) << 32;
    if (c) atomicAdd(acc + i, c);
  }
}

// out1[i] = low half of acc[i], out2[i] = high half.  The index is 64-bit:
// past 2^30 bins, i + stride would pass int32.
__global__ void __launch_bounds__(kThreads)
    split_packed(const u64* __restrict__ acc, int32_t n_bins,
                 int32_t* __restrict__ out1,
                 int32_t* __restrict__ out2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_bins; i += stride) {
    const u64 c = acc[i];
    out1[i] = static_cast<int32_t>(c & 0xffffffffu);
    out2[i] = static_cast<int32_t>(c >> 32);
  }
}

// ---- slimm_hist1 -----------------------------------------------------------

// Global atomics on one address serialise in the L2, so equal bins within a
// warp's step are added once, by their lowest lane (__match_any_sync).
__global__ void __launch_bounds__(kThreads)
    hist1_global(const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ w, int64_t n,
                 int aligned, int32_t* __restrict__ out,
                 int32_t n_bins) {
  const unsigned lane = threadIdx.x & 31;
  for_each_record<1>(idx, w, nullptr, n, aligned,
                     [&](int32_t b, uint32_t x, uint32_t) {
                       const bool ok = x && in_domain(b, n_bins);
                       const unsigned peers =
                           __match_any_sync(0xffffffffu, ok ? b : -1);
                       if (ok && lane == __ffs(peers) - 1u) {
                         atomicAdd(out + b, __popc(peers));
                       }
                     });
}

// Shared-memory atomics on one address are cheap enough that a match per
// record costs more than it saves, so each record adds its own 1.
__global__ void __launch_bounds__(kThreads)
    hist1_shared(const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ w, int64_t n,
                 int aligned, int32_t* __restrict__ out,
                 int32_t n_bins) {
  extern __shared__ int32_t counts1[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) counts1[i] = 0;
  __syncthreads();
  for_each_record<1>(idx, w, nullptr, n, aligned,
                     [&](int32_t b, uint32_t x, uint32_t) {
                       if (x && in_domain(b, n_bins)) atomicAdd(counts1 + b, 1);
                     });
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t c = counts1[i];
    if (c) atomicAdd(out + i, c);
  }
}

// Records reach the quad loads only when every pointer allows them.
int quads_aligned(const void* idx, const void* w1, const void* w2) {
  const auto a = [](const void* p, uintptr_t m) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (m - 1)) == 0;
  };
  return a(idx, 16) && a(w1, 4) && a(w2, 4);
}

}  // namespace

extern "C" {

// The current device's SM count and the shared memory a block may opt into,
// after allowing the shared-memory kernels that much (once per device).
int slimm_hist_init(int* sms, int* smem_optin) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  const void* kernels[] = {reinterpret_cast<const void*>(hist1_shared),
                           reinterpret_cast<const void*>(hist2_shared)};
  for (const void* k : kernels) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_optin);
    }
  }
  return static_cast<int>(err);
}

// One histogram: out[idx[r]] += (w[r] != 0), records outside [0, n_bins)
// dropped.  `out` arrives zeroed.
int slimm_hist1(const int32_t* idx, const uint8_t* w, int64_t n, int32_t* out,
                int32_t n_bins, int variant, int blocks, int threads,
                int smem, cudaStream_t stream) {
  const int aligned = quads_aligned(idx, w, nullptr);
  if (variant == kShared) {
    hist1_shared<<<blocks, threads, smem, stream>>>(idx, w, n, aligned, out,
                                                    n_bins);
  } else if (variant == kGlobal) {
    hist1_global<<<blocks, threads, 0, stream>>>(idx, w, n, aligned, out,
                                                 n_bins);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Two histograms over one index vector in one pass over `idx`, through the
// packed scratch `acc` (n_bins 64-bit words, zeroed here); out1 and out2 are
// written whole.
int slimm_hist2(const int32_t* idx, const uint8_t* w1, const uint8_t* w2,
                int64_t n, u64* acc, int32_t* out1, int32_t* out2,
                int32_t n_bins, int variant, int blocks, int threads,
                int smem, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(u64) * n_bins, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aligned = quads_aligned(idx, w1, w2);
  if (variant == kShared) {
    hist2_shared<<<blocks, threads, smem, stream>>>(idx, w1, w2, n, aligned,
                                                    acc, n_bins);
  } else if (variant == kGlobal) {
    hist2_global<<<blocks, threads, 0, stream>>>(idx, w1, w2, n, aligned, acc,
                                                 n_bins);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // in 64 bits: n_bins + kThreads - 1 passes int32 near 2^31 bins
  const int split_blocks = static_cast<int>(
      (static_cast<int64_t>(n_bins) + kThreads - 1) / kThreads);
  split_packed<<<split_blocks, kThreads, 0, stream>>>(acc, n_bins, out1, out2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
