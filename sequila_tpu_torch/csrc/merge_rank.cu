// Hopper (sm_90a) kernels of the merge route: count(*) and the emission
// bounds of the materializing join.
//
// Replaces the TPU merge-rank kernel sequila_tpu/ops/pallas/merge_count.py:110
// ::_merge_rank_sorted (B1, kernel body _make_kernel :65), its per-level
// caller _level_rank_pair (:615), and the XLA glue _pack_view (:158),
// merge_probe_count_passes' scatters and subtraction (:237-243) and
// merge_verb_rank4's scatter to probe row order (:345).
//
// pack_view_kernel: monotone (key code, int32 value) -> u32 packing of one
//   cached sorted view: out = (c_tab[k] + v) mod 2^32, PAD rows
//   (k == 2^31 - 1) map to the side's sentinel.  Elementwise; bound by the
//   12 bytes a row it reads and writes.
//
// merge_path_kernel: S independent rank problems in one launch.  Segment s
//   ranks its sorted u32 queries q_s[0, m_s) in its sorted u32 table
//   a_s[0, n_s): #{a < q} when strict, #{a <= q} otherwise (unsigned).  Each
//   segment sums its ranks into a u64 total and/or writes them, directly or
//   through an int64 order (out[ord[j]] = rank(j), for j < n_real; the
//   view's PAD tail is not written).  A table is packed u32, or raw key
//   codes and values packed on load with pack_view's arithmetic.
//
//   The first design ran one thread a query through a binary search of the
//   whole table: log2(7.7 M) = 23 dependent loads a query, 17 % of the HBM
//   bound at the genome count shape, and 2L latency-bound launches for the
//   L levels of the emission bounds.  Both inputs are sorted, so this one is
//   a merge path (Green, McColl and Bader, "GPU merge path", 2012): segment
//   s's merge of n_s + m_s elements is cut into tiles of kTile diagonals,
//   kTiles tiles a block, the blocks of all segments in one flat grid (the
//   host computes each segment's first block, block0).  A block finds the
//   table rows at its kTiles + 1 tile boundaries in global memory, one warp
//   a boundary, all at once, 32-ary (a round costs one load latency, about
//   5 rounds at 7.7 M rows); then it walks its tiles double buffered: while
//   tile t is merged, tile t + 1's slices of table and queries (kTile
//   elements together) are copied into shared memory (cp.async for packed
//   arrays; a raw table is packed on the load).  Each thread finds its own
//   diagonal of the tile in shared memory and merges kItems elements
//   sequentially, putting the rank of each query it passes in shared
//   memory; the block then stores the tile's ranks with neighbouring
//   threads on neighbouring queries (a thread's own queries are kItems
//   apart from its neighbour's, which would cost a sector a store).  Ties: a table
//   element goes before an equal query when non-strict and after it when
//   strict; the boundary searches and the merge apply the same rule.  Every
//   input element is read about once (plus the boundary searches),
//   whatever the shapes: a 7-row level against 300 k queries, or an empty
//   table (every rank 0).  What bounds it on an H100: the bytes, and for
//   scattered ranks the random 4-byte stores through the order.
//
// unpermute_planes_kernel: the genomic verbs' four rank passes back to
//   probe row order.  B1 stores them direct, in view order (coalesced):
//   src[p * n + j] is rank row p of view slot j, rows p = 0, 2 ranking the
//   (key, end) view and p = 1, 3 the (key, start) view.  out[p * n + i] =
//   src[p * n + inv[i]], inv = inv_e for even p and inv_s for odd p: the
//   views' int32 inverse orders.  One thread a row and plane, the blocks
//   plane-major, so the random 4-byte reads of one plane at a time (n int32,
//   30.7 MB at the genome shape) find it in the 50 MB L2 once read, while
//   the orders and the output stream through (evict-first loads and
//   stores).  It replaces the XLA scatter of
//   sequila_tpu/ops/pallas/merge_count.py:345 (merge_verb_rank4's scat),
//   which the first port folded into B1 as random 4-byte stores through
//   the orders: 1.58 of B1's 1.81 ms on an H100.  The first redesign stored
//   the ranks as int32 pairs, one pair a view slot, and gathered 8 bytes
//   a view and row; its 61.5 MB sources outgrow L2, and it took longer
//   (tools/verb_layouts.py).  What bounds it: the random sector reads of
//   L2 (one 32-byte sector for 4 bytes), then the bytes.
//
// unpermute_counts_kernel: the per-probe counts' two rank passes back to
//   probe row order, the BITS subtraction fused.  B1 stores them direct, in
//   view order: src[j] ranks slot j of the (key, end) view and src[n + j]
//   slot j of the (key, start) view.  out[i] = src[inv_e[i]] -
//   src[n + inv_s[i]], the views' int32 inverse orders.  The two planes
//   together (61.5 MB at the genome shape) outgrow the 50 MB L2, one (30.7
//   MB) fits: so the blocks run plane-major, as in unpermute_planes_kernel,
//   and each adds its plane's term (+ for plane 0, - for plane 1) into the
//   output, zeroed first, with a reduction to global memory (red.add, done
//   in L2; int32 addition wraps, so the order of the two terms does not
//   matter).  The random 4-byte reads of one plane at a time hit L2 once
//   read; the inverse orders stream through (evict-first loads).  It
//   replaces the two XLA scatters and the subtraction of
//   sequila_tpu/ops/pallas/merge_count.py:237-243, which the first port
//   folded into B1 as random 4-byte stores through int64 orders (0.60 of
//   that launch's 0.73 ms on an H100).  tools/probe_layouts.py times the
//   other designs at the genome shape on an H100: one pass that reads both
//   planes for each row 0.32 ms against this one's 0.20 (its reads miss
//   L2); two launches of one plane each, the second reading the output
//   back instead of a zeroing, 0.19 ms, but two launches a call; one
//   launch ordered by tickets (plane 1's blocks wait for plane 0's) 0.21.
//   What bounds it: the random sector reads of L2, then the bytes.
//
// Plain C interface for ctypes.  Each entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // merge diagonals a tile
constexpr int kTiles = kThreads / 32 - 1;  // tiles a block: a warp a boundary
constexpr int64_t kSpan = static_cast<int64_t>(kTiles) * kTile;  // diagonals a block
constexpr int kBases = 6;                 // per-call tensors a launch names
constexpr int kInline = 2;                // segments passed as parameters
constexpr int32_t kPadKey = 0x7FFFFFFF;

__device__ __forceinline__ uint32_t pack_one(int32_t key, int32_t v,
                                             const uint32_t* __restrict__ c_tab,
                                             int32_t n_tab, uint32_t pad_sentinel) {
  if (key == kPadKey) return pad_sentinel;
  const int32_t safe = min(max(key, 0), n_tab - 1);
  return __ldg(c_tab + safe) + static_cast<uint32_t>(v);
}

__global__ void pack_view_kernel(const int32_t* __restrict__ k,
                                 const int32_t* __restrict__ v,
                                 const uint32_t* __restrict__ c_tab,
                                 int32_t n_tab, uint32_t pad_sentinel,
                                 uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = pack_one(k[i], v[i], c_tab, n_tab, pad_sentinel);
  }
}

// One row of the descriptor table (int64 fields; the field order of
// ops/cuda/merge_count.py's _F_* constants).  A "slot" names one of the
// launch's per-call base tensors; offsets count elements.
struct Segment {
  int64_t a_slot, a_off;        // packed table; a_slot < 0: raw
  int64_t raw_k, raw_v, c_tab;  // raw table: device addresses
  int64_t n_tab, pad;           // C table entries, PAD sentinel
  int64_t n;                    // table rows
  int64_t q_slot, q_off, m;     // packed queries
  int64_t strict;
  int64_t out_slot, out_off;    // int32 ranks; out_slot < 0: none
  int64_t ord;                  // int64 order (address), 0: direct
  int64_t n_real;               // ranks written for j < n_real
  int64_t total_slot, total_off;  // u64 sum; total_slot < 0: none
  int64_t block0;               // first block of the segment
  int64_t unused;
};
static_assert(sizeof(Segment) == 20 * sizeof(int64_t), "descriptor layout");

struct Params {
  Segment inl[kInline];  // the segments when segs is null
  const Segment* segs;   // device table of n_segs descriptors
  int32_t n_segs;
  uint64_t base[kBases];
};

struct Table {  // a segment's table, packed or raw
  const uint32_t* a;
  const int32_t* k;
  const int32_t* v;
  const uint32_t* c_tab;
  int32_t n_tab;
  uint32_t pad;
  __device__ __forceinline__ uint32_t operator[](int64_t i) const {
    return a != nullptr ? __ldg(a + i) : pack_one(__ldg(k + i), __ldg(v + i), c_tab, n_tab, pad);
  }
};

__device__ __forceinline__ bool before(uint32_t a, uint32_t q, bool strict) {
  // does table element a precede query q in the merged order?
  return strict ? a < q : a <= q;
}

// The table rows among the first d elements of the merge of a[0, n) and
// q[0, m): the first i on the diagonal whose table element does not
// precede the query at d - 1 - i.  One warp searches 32-ary, one load a
// lane a round, so a round costs one global load latency where a binary
// search pays log2 of them (23 at 7.7 M rows).  Every lane gets it.
__device__ int64_t warp_split(const Table& a, int64_t n, const uint32_t* q, int64_t m,
                              int64_t d, bool strict) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > m ? d - m : 0;
  int64_t hi = d < n ? d : n;
  while (lo < hi) {  // uniform across the warp
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t pos = lo + lane * step;
    const bool pred = pos < hi && before(a[pos], __ldg(q + d - 1 - pos), strict);
    // the rule is monotone along a diagonal: the first c samples hold it
    const int c = __popc(__ballot_sync(0xffffffffu, pred));
    const int64_t cut = lo + c * step;
    lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = cut < hi ? cut : hi;
  }
  return lo;
}

struct TileSpan {  // one tile's slices: a[i0, i0 + na), q[j0, j0 + nq)
  int64_t i0, j0;
  int na, nq;
};

__device__ __forceinline__ TileSpan tile_span(const int64_t* split, int t, int64_t d_begin,
                                              int64_t total_d) {
  const int64_t d0 = d_begin + static_cast<int64_t>(t) * kTile;
  const int64_t d1 = d0 + kTile < total_d ? d0 + kTile : total_d;
  const int na = static_cast<int>(split[t + 1] - split[t]);
  return {split[t], d0 - split[t], na, static_cast<int>(d1 - d0) - na};
}

// stage a tile's table slice at buf[0, na) and its queries at buf[na, na + nq)
__device__ __forceinline__ void stage(uint32_t* buf, const TileSpan& s, const Table& a,
                                      const uint32_t* q) {
  if (a.a != nullptr) {
    for (int t = threadIdx.x; t < s.na; t += kThreads) __pipeline_memcpy_async(buf + t, a.a + s.i0 + t, 4);
  } else {
    for (int t = threadIdx.x; t < s.na; t += kThreads) buf[t] = a[s.i0 + t];
  }
  for (int t = threadIdx.x; t < s.nq; t += kThreads) __pipeline_memcpy_async(buf + s.na + t, q + s.j0 + t, 4);
  __pipeline_commit();
}

// One thread's kItems diagonals of a staged tile: its own split by a
// binary search in shared memory, then a sequential merge that keeps the
// current table element and query in registers (one shared load a step),
// putting the rank of each query it passes at ranks[j] (the tile's query
// j) when ranks is not null; returns their sum.
template <bool kStrict>
__device__ __forceinline__ unsigned long long merge_tile(const uint32_t* buf, const TileSpan& s,
                                                         int32_t* ranks) {
  const int na = s.na, nq = s.nq, total = na + nq;
  const int dl = min(static_cast<int>(threadIdx.x) * kItems, total);
  const int end = min(dl + kItems, total);
  int lo = dl > nq ? dl - nq : 0;
  int hi = dl < na ? dl : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(buf[mid], buf[na + dl - 1 - mid], kStrict)) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = dl - lo;
  uint32_t av = i < na ? buf[i] : 0u;
  uint32_t qv = j < nq ? buf[na + j] : 0u;
  unsigned long long sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (dl + k < end) {
      if (j >= nq || (i < na && before(av, qv, kStrict))) {
        ++i;
        av = i < na ? buf[i] : 0u;
      } else {
        const int64_t r = s.i0 + i;
        sum += static_cast<unsigned long long>(r);
        if (ranks != nullptr) ranks[j] = static_cast<int32_t>(r);
        ++j;
        qv = j < nq ? buf[na + j] : 0u;
      }
    }
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const __grid_constant__ Params p) {
  __shared__ Segment sg;
  __shared__ int64_t split[kTiles + 1];
  __shared__ uint32_t tiles_buf[2][kTile];
  __shared__ int32_t ranks[kTile];  // a tile's ranks, stored out coalesced
  const int64_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    // the last segment whose first block is <= b (empty ones share block0)
    const Segment* segs = p.segs != nullptr ? p.segs : p.inl;
    int lo = 0, hi = p.n_segs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (segs[mid].block0 <= b) lo = mid; else hi = mid - 1;
    }
    sg = segs[lo];
  }
  __syncthreads();
  const int64_t n = sg.n, m = sg.m, total_d = n + m;
  const bool strict = sg.strict != 0;
  const Table a{
      sg.a_slot >= 0 ? reinterpret_cast<const uint32_t*>(p.base[sg.a_slot]) + sg.a_off : nullptr,
      reinterpret_cast<const int32_t*>(sg.raw_k), reinterpret_cast<const int32_t*>(sg.raw_v),
      reinterpret_cast<const uint32_t*>(sg.c_tab), static_cast<int32_t>(sg.n_tab),
      static_cast<uint32_t>(sg.pad)};
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p.base[sg.q_slot]) + sg.q_off;
  int32_t* out = sg.out_slot >= 0
      ? reinterpret_cast<int32_t*>(p.base[sg.out_slot]) + sg.out_off : nullptr;
  const int64_t* ord = reinterpret_cast<const int64_t*>(sg.ord);
  const int64_t n_real = sg.n_real;
  const int64_t d_begin = (b - sg.block0) * kSpan;
  const int64_t left = (total_d - d_begin + kTile - 1) / kTile;
  const int tiles = left < kTiles ? static_cast<int>(left) : kTiles;

  // the tiles' kTiles + 1 splits, one warp each, all at once
  for (int s = threadIdx.x >> 5; s <= tiles; s += kThreads / 32) {
    const int64_t d = d_begin + static_cast<int64_t>(s) * kTile;
    const int64_t r = warp_split(a, n, q, m, d < total_d ? d : total_d, strict);
    if ((threadIdx.x & 31) == 0) split[s] = r;
  }
  __syncthreads();

  // double buffered: tile t + 1 is copied in while tile t is merged
  unsigned long long sum = 0;
  stage(tiles_buf[0], tile_span(split, 0, d_begin, total_d), a, q);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(tiles_buf[(t + 1) & 1], tile_span(split, t + 1, d_begin, total_d), a, q);
    } else {
      __pipeline_commit();  // an empty group keeps the count of groups in step
    }
    __pipeline_wait_prior(1);  // all but the newest group: tile t is in
    __syncthreads();
    const TileSpan s = tile_span(split, t, d_begin, total_d);
    int32_t* tile_ranks = out != nullptr ? ranks : nullptr;
    sum += strict ? merge_tile<true>(tiles_buf[t & 1], s, tile_ranks)
                  : merge_tile<false>(tiles_buf[t & 1], s, tile_ranks);
    if (out != nullptr) {  // uniform across the block
      // neighbouring threads store neighbouring queries' ranks: coalesced
      // when direct, one random 4-byte store a query through an order
      __syncthreads();
      const int64_t stop = n_real - s.j0 < s.nq ? n_real - s.j0 : s.nq;
      for (int k = threadIdx.x; k < stop; k += kThreads) {
        const int64_t jg = s.j0 + k;
        out[ord != nullptr ? __ldg(ord + jg) : jg] = ranks[k];
      }
    }
    __syncthreads();  // the buffers are free for tile t + 2
  }
  if (sg.total_slot < 0) return;  // uniform across the block
  block_sum_to<kThreads>(
      sum, reinterpret_cast<unsigned long long*>(p.base[sg.total_slot]) + sg.total_off);
}

__global__ void __launch_bounds__(kThreads)
unpermute_planes_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ inv_e,
                        const int32_t* __restrict__ inv_s, int32_t* __restrict__ out,
                        int64_t n, int64_t blocks_per_plane) {
  const int64_t p = blockIdx.x / blocks_per_plane;
  const int64_t i = (blockIdx.x - p * blocks_per_plane) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t j = __ldcs(((p & 1) ? inv_s : inv_e) + i);
  __stcs(out + p * n + i, __ldg(src + p * n + j));
}

__global__ void __launch_bounds__(kThreads)
unpermute_counts_kernel(const int32_t* __restrict__ src, const int32_t* __restrict__ inv_e,
                        const int32_t* __restrict__ inv_s, int32_t* __restrict__ out,
                        int64_t n, int64_t blocks_per_plane) {
  const int64_t p = blockIdx.x / blocks_per_plane;
  const int64_t i = (blockIdx.x - p * blocks_per_plane) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t r = __ldg(src + p * n + __ldcs((p ? inv_s : inv_e) + i));
  atomicAdd(out + i, p ? -r : r);  // no result used: compiled to red.global.add
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

// segs: a device table of n_segs descriptors, or null and then
// inline_segs: n_segs <= kInline descriptors in host memory, passed as
// kernel parameters.  bases: kBases device addresses in host memory.
// blocks: the segments' blocks in all (the last block0 plus its blocks).
extern "C" int seq_merge_path(const void* inline_segs, const void* segs, int32_t n_segs,
                              int64_t blocks, const void* bases, void* stream) {
  if (blocks <= 0) return 0;
  if (n_segs <= 0 || blocks > 0x7FFFFFFF || (segs == nullptr && n_segs > kInline)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  if (segs == nullptr) memcpy(p.inl, inline_segs, n_segs * sizeof(Segment));
  p.segs = static_cast<const Segment*>(segs);
  p.n_segs = n_segs;
  memcpy(p.base, bases, sizeof(p.base));
  merge_path_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// src, out: 4 n int32 (planes of n); inv_e, inv_s: n int32 slots in [0, n).
extern "C" int seq_unpermute_planes(const void* src, const void* inv_e, const void* inv_s,
                                    void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t per_plane = (n + kThreads - 1) / kThreads;
  if (4 * per_plane > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  unpermute_planes_kernel<<<static_cast<unsigned>(4 * per_plane), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(inv_e),
      static_cast<const int32_t*>(inv_s), static_cast<int32_t*>(out), n, per_plane);
  return static_cast<int>(cudaGetLastError());
}

// src: 2 n int32 (two planes of n); inv_e, inv_s: n int32 slots in [0, n);
// out: n int32, zeroed here on the stream before the launch.
extern "C" int seq_unpermute_counts(const void* src, const void* inv_e, const void* inv_s,
                                    void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t per_plane = (n + kThreads - 1) / kThreads;
  if (2 * per_plane > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, n * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  unpermute_counts_kernel<<<static_cast<unsigned>(2 * per_plane), kThreads, 0, st>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(inv_e),
      static_cast<const int32_t*>(inv_s), static_cast<int32_t*>(out), n, per_plane);
  return static_cast<int>(cudaGetLastError());
}
