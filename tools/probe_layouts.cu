// Other designs of the per-probe counts' un-permute, kept beside the
// package's plane-major reduction (unpermute_counts_kernel) for
// tools/probe_layouts.py.  Each computes out[i] = src[inv_e[i]] -
// src[n + inv_s[i]] from the two view-order rank planes of B1's per-probe
// launch.  The two planes together (8 n bytes, 61.5 MB at the genome
// shape) outgrow the H100's 50 MB L2, where one plane (4 n bytes) fits.
#include "../sequila_tpu_torch/csrc/merge_rank.cu"

namespace {

// one pass: each row reads both planes, so the random reads span 8 n bytes
__global__ void __launch_bounds__(kThreads)
counts_one_pass_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ inv_e,
                       const int32_t* __restrict__ inv_s, int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t e = __ldg(src + __ldcs(inv_e + i));
  const int32_t s = __ldg(src + n + __ldcs(inv_s + i));
  __stcs(out + i, e - s);
}

// one plane a launch: the first stores its term, the second subtracts its
// own from what the first stored (the output read once more)
__global__ void __launch_bounds__(kThreads)
counts_plane_kernel(const int32_t* __restrict__ plane, const int32_t* __restrict__ inv,
                    int32_t* __restrict__ out, int64_t n, int first) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t r = __ldg(plane + __ldcs(inv + i));
  __stcs(out + i, first ? r : __ldcs(out + i) - r);
}

// the package's plane-major reduction with an L2 evict-first policy on
// the reductions, so the output's lines do not push the plane out of L2
__global__ void __launch_bounds__(kThreads)
counts_red_evict_first_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ inv_e,
                              const int32_t* __restrict__ inv_s, int32_t* __restrict__ out,
                              int64_t n, int64_t blocks_per_plane) {
  const int64_t p = blockIdx.x / blocks_per_plane;
  const int64_t i = (blockIdx.x - p * blocks_per_plane) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t r = __ldg(src + p * n + __ldcs((p ? inv_s : inv_e) + i));
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("red.global.add.L2::cache_hint.s32 [%0], %1, %2;"
               :: "l"(out + i), "r"(p ? -r : r), "l"(policy) : "memory");
}

// one launch, plane-major by ticket: each block draws a ticket (atomicAdd)
// as it starts; tickets 0 .. chunks - 1 store plane 0's term of chunk t,
// tickets chunks .. 2 chunks - 1 wait until plane 0's block of the same
// chunk has stored, then subtract plane 1's term from it (the output read
// once more, no zeroing).  A block waits only on a block with a smaller
// ticket, which started before it and waits on nothing, so it cannot
// deadlock.  sync: [0] the ticket counter, [1 + c] chunk c's flag, zeroed
// before the launch.
constexpr int kTicketRows = 4;  // rows a thread
constexpr int64_t kTicketChunk = static_cast<int64_t>(kThreads) * kTicketRows;

__global__ void __launch_bounds__(kThreads)
counts_ticket_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ inv_e,
                     const int32_t* __restrict__ inv_s, int32_t* __restrict__ out, int64_t n,
                     int32_t* __restrict__ sync, int64_t chunks) {
  __shared__ int64_t ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int64_t p = ticket >= chunks;
  const int64_t c = ticket - p * chunks;
  if (p) {  // uniform across the block
    if (threadIdx.x == 0) {
      while (atomicAdd(sync + 1 + c, 0) == 0) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
  }
  const int32_t* plane = src + p * n;
  const int32_t* inv = p ? inv_s : inv_e;
  const int64_t base = c * kTicketChunk + threadIdx.x;
  int32_t r[kTicketRows];
#pragma unroll
  for (int k = 0; k < kTicketRows; ++k) {
    const int64_t i = base + k * kThreads;
    r[k] = i < n ? __ldg(plane + __ldcs(inv + i)) : 0;
  }
#pragma unroll
  for (int k = 0; k < kTicketRows; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < n) __stcg(out + i, p ? __ldcg(out + i) - r[k] : r[k]);
  }
  if (!p) {  // publish the chunk: every thread's stores, then the flag
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(sync + 1 + c, 1);
  }
}

unsigned blocks_of(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// src: 2 n int32; inv_e, inv_s: n int32 view slots; out: n int32.
extern "C" int pl_counts_one_pass(const void* src, const void* inv_e, const void* inv_s,
                                  void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  counts_one_pass_kernel<<<blocks_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(inv_e),
      static_cast<const int32_t*>(inv_s), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pl_counts_two_launches(const void* src, const void* inv_e, const void* inv_s,
                                      void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* planes = static_cast<const int32_t*>(src);
  counts_plane_kernel<<<blocks_of(n), kThreads, 0, st>>>(
      planes, static_cast<const int32_t*>(inv_e), static_cast<int32_t*>(out), n, 1);
  counts_plane_kernel<<<blocks_of(n), kThreads, 0, st>>>(
      planes + n, static_cast<const int32_t*>(inv_s), static_cast<int32_t*>(out), n, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pl_counts_red_evict_first(const void* src, const void* inv_e, const void* inv_s,
                                         void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, n * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_red_evict_first_kernel<<<2 * blocks_of(n), kThreads, 0, st>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(inv_e),
      static_cast<const int32_t*>(inv_s), static_cast<int32_t*>(out), n, blocks_of(n));
  return static_cast<int>(cudaGetLastError());
}

// sync: 1 + ceil(n / 1024) int32 of scratch, zeroed here.
extern "C" int pl_counts_ticket(const void* src, const void* inv_e, const void* inv_s, void* out,
                                void* sync, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (n + kTicketChunk - 1) / kTicketChunk;
  const cudaError_t err = cudaMemsetAsync(sync, 0, (1 + chunks) * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_ticket_kernel<<<static_cast<unsigned>(2 * chunks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(inv_e),
      static_cast<const int32_t*>(inv_s), static_cast<int32_t*>(out), n,
      static_cast<int32_t*>(sync), chunks);
  return static_cast<int>(cudaGetLastError());
}
