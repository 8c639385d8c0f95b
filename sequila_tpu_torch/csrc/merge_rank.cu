// Hopper (sm_90a) kernels of the count(*) merge path.
//
// Replaces the TPU merge-rank kernel sequila_tpu/ops/pallas/merge_count.py:110
// ::_merge_rank_sorted (B1, kernel body _make_kernel :65) and the XLA glue
// _pack_view (:158) that feeds it.
//
// pack_view_kernel: monotone (key code, int32 value) -> u32 packing of one
//   cached sorted view: out = (c_tab[k] + v) mod 2^32, PAD rows
//   (k == 2^31 - 1) map to the side's sentinel.  Elementwise; bound by the
//   12 bytes a row it reads and writes.
//
// merge_rank_kernel: rank of each sorted u32 query q[i] in the sorted u32
//   table a[0, n): #{a < q} when strict, #{a <= q} otherwise (unsigned
//   compare).  One thread per query runs a branch-free lower/upper bound.
//   The TPU kernel swept host-computed chunk windows because Mosaic has no
//   vector gather; a GPU thread gathers freely, so no windows are needed.
//   What bounds it on an H100: log2(n) dependent loads per query.  The
//   queries are sorted, so neighbouring threads walk nearly the same path
//   and the upper levels of the search tree stay in L1/L2; the whole table
//   (7.7 M rows, 31 MB at genome scale) fits the 50 MB L2.  Measured at
//   that shape (2.35 M queries) on an H100 80GB HBM3 at a 700 W power
//   limit: 0.07 ms, about 17 % of the HBM bound, so latency, not
//   bandwidth, limits it.  The ranks can be written out (ranks != nullptr)
//   and/or summed into one 64-bit total (total != nullptr: warp shuffles,
//   one shared-memory pass and one atomicAdd per block), so count(*) reads
//   back a single scalar.  A block-cooperative merge path over
//   shared-memory tiles is the next step for speed.
//
// Plain C interface for ctypes.  Each entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kPadKey = 0x7FFFFFFF;

__global__ void pack_view_kernel(const int32_t* __restrict__ k,
                                 const int32_t* __restrict__ v,
                                 const uint32_t* __restrict__ c_tab,
                                 int32_t n_tab, uint32_t pad_sentinel,
                                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t key = k[i];
    uint32_t packed = pad_sentinel;
    if (key != kPadKey) {
      const int32_t safe = min(max(key, 0), n_tab - 1);
      packed = c_tab[safe] + static_cast<uint32_t>(v[i]);
    }
    out[i] = packed;
  }
}

template <bool kStrict>
__device__ __forceinline__ int64_t rank_in(const uint32_t* __restrict__ a,
                                           int64_t n, uint32_t q) {
  // first position whose element is >= q (strict) or > q (non-strict)
  int64_t lo = 0;
  int64_t len = n;
  while (len > 0) {
    const int64_t half = len >> 1;
    const uint32_t x = __ldg(a + lo + half);
    const bool right = kStrict ? (x < q) : (x <= q);
    lo = right ? lo + half + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo;
}

template <bool kStrict>
__global__ void __launch_bounds__(kThreads)
merge_rank_kernel(const uint32_t* __restrict__ a, int64_t n,
                  const uint32_t* __restrict__ q, int64_t m,
                  int32_t* __restrict__ ranks,
                  unsigned long long* __restrict__ total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned long long r = 0;
  if (i < m) {
    r = static_cast<unsigned long long>(rank_in<kStrict>(a, n, q[i]));
    if (ranks != nullptr) ranks[i] = static_cast<int32_t>(r);
  }
  if (total == nullptr) return;  // uniform across the block
  block_sum_to<kThreads>(r, total);
}

}  // namespace

extern "C" int seq_pack_view(const void* k, const void* v, const void* c_tab,
                             int32_t n_tab, uint32_t pad_sentinel, void* out,
                             int64_t n, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks/SM
  pack_view_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(k), static_cast<const int32_t*>(v),
      static_cast<const uint32_t*>(c_tab), n_tab, pad_sentinel,
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seq_merge_rank(const void* a, int64_t n, const void* q, int64_t m,
                              int32_t strict, void* ranks, void* total,
                              void* stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a_ = static_cast<const uint32_t*>(a);
  const auto* q_ = static_cast<const uint32_t*>(q);
  auto* r_ = static_cast<int32_t*>(ranks);
  auto* t_ = static_cast<unsigned long long*>(total);
  if (strict) {
    merge_rank_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a_, n, q_, m, r_, t_);
  } else {
    merge_rank_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a_, n, q_, m, r_, t_);
  }
  return static_cast<int>(cudaGetLastError());
}
