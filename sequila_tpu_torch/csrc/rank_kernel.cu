// Hopper (sm_90a) kernel: lexicographic rank against a resident build that
// finds its own windows.
//
// Replaces the TPU kernel sequila_tpu/ops/pallas/rank_kernel.py:126
// ::_pallas_rank_sorted (B3, kernel body _make_kernel :50).
//
// resident_rank_kernel: rank of sorted signed int32 (key, value) queries in
//   a sorted (key, value) build of n_pad rows (a multiple of kChunk, at most
//   kMaxBuild), #{a < q} when strict, #{a <= q} otherwise.  Unlike the
//   stream kernel it takes no host windows.  The TPU kernel held the whole
//   build in VMEM; an SM's 228 KB of shared memory cannot hold 2^20 rows
//   (8 MB), but the kernel's search structure fits: the build's chunk-
//   boundary elements, at most 512 (key, value) pairs (4 KB).  Each block
//   loads them into shared memory and finds its window of chunks [c_lo,
//   c_hi) there, with the TPU kernel's rule (:89-97): c_lo is one less than
//   the number of boundaries strictly below the block's first query, c_hi
//   the number at or below its last.  Every element before c_lo * kChunk is
//   below every query of the block; nothing from c_hi * kChunk on can count.
//   Each thread then binary-searches its query inside the window, reading
//   the build from global memory: 8 MB stays in the 50 MB L2.
//   What bounds it on an H100: the strided boundary loads (512 scattered
//   words a block, from L2) and then a dependent-load binary search of
//   log2(window) steps a query, so latency, not bandwidth.
//   The ranks can be written out (ranks != nullptr) and/or summed into one
//   64-bit total (total != nullptr).
//
// Plain C interface for ctypes.  The entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kBlock = 256;                      // queries a block (BLOCK)
constexpr int kChunk = 2048;                     // rows a chunk (CHUNK)
constexpr int kMaxBuild = 1 << 20;               // MAX_VMEM_BUILD
constexpr int kMaxChunks = kMaxBuild / kChunk;   // 512 boundary pairs

template <bool kStrict>
__device__ __forceinline__ bool before(int32_t ak, int32_t av, int32_t qk, int32_t qv) {
  return ak < qk || (ak == qk && (kStrict ? av < qv : av <= qv));
}

// #{c < n : (bk[c], bv[c]) < (qk, qv)} (strict) or <= (non-strict)
template <bool kStrict>
__device__ int count_before(const int32_t* bk, const int32_t* bv, int n,
                            int32_t qk, int32_t qv) {
  int lo = 0;
  int len = n;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = lo + half;
    const bool right = before<kStrict>(bk[mid], bv[mid], qk, qv);
    lo = right ? mid + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo;
}

template <bool kStrict>
__global__ void __launch_bounds__(kBlock)
resident_rank_kernel(const int32_t* __restrict__ a_k, const int32_t* __restrict__ a_v,
                     int64_t n_pad, const int32_t* __restrict__ q_k,
                     const int32_t* __restrict__ q_v, int64_t m,
                     int32_t* __restrict__ ranks,
                     unsigned long long* __restrict__ total) {
  __shared__ int32_t bnd_k[kMaxChunks];
  __shared__ int32_t bnd_v[kMaxChunks];
  __shared__ int64_t window[2];
  const int n_chunks = static_cast<int>(n_pad / kChunk);
  for (int c = threadIdx.x; c < n_chunks; c += kBlock) {
    bnd_k[c] = __ldg(a_k + static_cast<int64_t>(c) * kChunk);
    bnd_v[c] = __ldg(a_v + static_cast<int64_t>(c) * kChunk);
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int64_t last = (first + kBlock < m ? first + kBlock : m) - 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int lo = count_before<true>(bnd_k, bnd_v, n_chunks, q_k[first], q_v[first]) - 1;
    const int hi = count_before<false>(bnd_k, bnd_v, n_chunks, q_k[last], q_v[last]);
    window[0] = static_cast<int64_t>(lo > 0 ? lo : 0) * kChunk;
    window[1] = static_cast<int64_t>(hi) * kChunk;
  }
  __syncthreads();

  const int64_t i = first + threadIdx.x;
  const bool valid = i < m;
  int64_t rank = 0;
  if (valid) {
    const int32_t qk = q_k[i];
    const int32_t qv = q_v[i];
    int64_t lo = window[0];
    int64_t len = window[1] > lo ? window[1] - lo : 0;
    while (len > 0) {
      const int64_t half = len >> 1;
      const int64_t mid = lo + half;
      const bool right = before<kStrict>(__ldg(a_k + mid), __ldg(a_v + mid), qk, qv);
      lo = right ? mid + 1 : lo;
      len = right ? len - half - 1 : half;
    }
    rank = lo;
    if (ranks != nullptr) ranks[i] = static_cast<int32_t>(rank);
  }
  if (total == nullptr) return;  // uniform across the block
  block_sum_to<kBlock>(static_cast<unsigned long long>(rank), total);
}

}  // namespace

extern "C" int seq_resident_rank(const void* a_k, const void* a_v, int64_t n_pad,
                                 const void* q_k, const void* q_v, int64_t m,
                                 int32_t strict, void* ranks, void* total,
                                 void* stream) {
  if (m <= 0) return 0;
  if (n_pad < 0 || n_pad > kMaxBuild || n_pad % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (m + kBlock - 1) / kBlock;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ak = static_cast<const int32_t*>(a_k);
  const auto* av = static_cast<const int32_t*>(a_v);
  const auto* qk = static_cast<const int32_t*>(q_k);
  const auto* qv = static_cast<const int32_t*>(q_v);
  auto* r = static_cast<int32_t*>(ranks);
  auto* t = static_cast<unsigned long long*>(total);
  if (strict) {
    resident_rank_kernel<true><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        ak, av, n_pad, qk, qv, m, r, t);
  } else {
    resident_rank_kernel<false><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        ak, av, n_pad, qk, qv, m, r, t);
  }
  return static_cast<int>(cudaGetLastError());
}
