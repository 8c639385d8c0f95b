// Hopper (sm_90a) kernel of the `stream` count(*) route.
//
// Replaces the TPU kernel sequila_tpu/ops/pallas/stream_rank.py:86
// ::_stream_rank_sorted (B2, kernel body _make_kernel :42).
//
// stream_rank_kernel: lexicographic rank of sorted signed int32 (key, value)
//   queries against a sorted (key, value) build of n_pad rows (a multiple of
//   kChunk), #{a < q} when strict, #{a <= q} otherwise.  The contract is the
//   TPU kernel's: the host (ops/cuda/stream_rank.py::host_windows) gives each
//   block of kBlock queries a window of build chunks [c_lo, c_lo + n_chunks),
//   and the result is c_lo * kChunk + #{a in the window before q}.  One
//   thread block takes one query block and stages each chunk of its window,
//   keys and values (2 x 8 KB), through shared memory with 16-byte loads;
//   each thread then binary-searches its query in the staged slab (11
//   steps; neighbouring threads hold neighbouring sorted queries, so they
//   mostly read the same words, which shared memory broadcasts).
//   What bounds it on an H100: sorted probes make the windows about one or
//   two chunks a block at the main path's shapes, so each block reads
//   16-32 KB of build and 2 KB of queries, and the kernel is bound by those
//   bytes and by the two block barriers a chunk.  The TPU kernel double-
//   buffered its DMA; plain loads are enough for a first version, and
//   cp.async double buffering is the next step for speed.
//   The ranks can be written out (ranks != nullptr) and/or summed into one
//   64-bit total (total != nullptr), as the merge-rank kernel does.
//
// Plain C interface for ctypes.  The entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kBlock = 256;   // queries a block (the TPU kernel's BLOCK)
constexpr int kChunk = 2048;  // build rows a staged slab (the TPU kernel's CHUNK)

template <bool kStrict>
__device__ __forceinline__ bool before(int32_t ak, int32_t av, int32_t qk, int32_t qv) {
  return ak < qk || (ak == qk && (kStrict ? av < qv : av <= qv));
}

template <bool kStrict>
__global__ void __launch_bounds__(kBlock)
stream_rank_kernel(const int32_t* __restrict__ a_k, const int32_t* __restrict__ a_v,
                   int64_t n_chunks_total,
                   const int32_t* __restrict__ c_lo, const int32_t* __restrict__ n_chunks,
                   const int32_t* __restrict__ q_k, const int32_t* __restrict__ q_v,
                   int64_t m, int32_t* __restrict__ ranks,
                   unsigned long long* __restrict__ total) {
  __shared__ int4 slab_k4[kChunk / 4];
  __shared__ int4 slab_v4[kChunk / 4];
  const int32_t* slab_k = reinterpret_cast<const int32_t*>(slab_k4);
  const int32_t* slab_v = reinterpret_cast<const int32_t*>(slab_v4);

  const int64_t g = blockIdx.x;
  const int64_t i = g * kBlock + threadIdx.x;
  const bool valid = i < m;
  const int32_t qk = valid ? q_k[i] : 0;
  const int32_t qv = valid ? q_v[i] : 0;
  const int64_t c0 = c_lo[g];
  // the window is the host's; clamping it only keeps reads inside the build
  const int64_t c_begin = c0 < 0 ? 0 : c0;
  int64_t c_end = c0 + (n_chunks[g] > 0 ? n_chunks[g] : 0);
  if (c_end > n_chunks_total) c_end = n_chunks_total;

  int64_t count = 0;
  for (int64_t c = c_begin; c < c_end; ++c) {
    const int4* gk = reinterpret_cast<const int4*>(a_k + c * kChunk);
    const int4* gv = reinterpret_cast<const int4*>(a_v + c * kChunk);
    for (int j = threadIdx.x; j < kChunk / 4; j += kBlock) {
      slab_k4[j] = __ldg(gk + j);
      slab_v4[j] = __ldg(gv + j);
    }
    __syncthreads();
    int lo = 0;
    int len = kChunk;
    while (len > 0) {
      const int half = len >> 1;
      const int mid = lo + half;
      const bool right = before<kStrict>(slab_k[mid], slab_v[mid], qk, qv);
      lo = right ? mid + 1 : lo;
      len = right ? len - half - 1 : half;
    }
    count += lo;
    __syncthreads();  // the slab is overwritten by the next chunk
  }

  const int64_t rank = c0 * kChunk + count;
  if (valid && ranks != nullptr) ranks[i] = static_cast<int32_t>(rank);
  if (total == nullptr) return;  // uniform across the block
  block_sum_to<kBlock>(valid ? static_cast<unsigned long long>(rank) : 0ull, total);
}

}  // namespace

extern "C" int seq_stream_rank(const void* a_k, const void* a_v, int64_t n_pad,
                               const void* c_lo, const void* n_chunks,
                               const void* q_k, const void* q_v, int64_t m,
                               int32_t strict, void* ranks, void* total,
                               void* stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kBlock - 1) / kBlock;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ak = static_cast<const int32_t*>(a_k);
  const auto* av = static_cast<const int32_t*>(a_v);
  const auto* lo = static_cast<const int32_t*>(c_lo);
  const auto* nc = static_cast<const int32_t*>(n_chunks);
  const auto* qk = static_cast<const int32_t*>(q_k);
  const auto* qv = static_cast<const int32_t*>(q_v);
  auto* r = static_cast<int32_t*>(ranks);
  auto* t = static_cast<unsigned long long*>(total);
  if (strict) {
    stream_rank_kernel<true><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        ak, av, n_pad / kChunk, lo, nc, qk, qv, m, r, t);
  } else {
    stream_rank_kernel<false><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        ak, av, n_pad / kChunk, lo, nc, qk, qv, m, r, t);
  }
  return static_cast<int>(cudaGetLastError());
}
