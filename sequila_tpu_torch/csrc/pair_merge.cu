// Hopper (sm_90a) merge path over sorted signed int32 (key, value) pairs:
// the rank kernel of the stream count(*) route and of the resident rank.
//
// Replaces the TPU kernels sequila_tpu/ops/pallas/stream_rank.py:86
// ::_stream_rank_sorted (B2, kernel body _make_kernel :42) and
// sequila_tpu/ops/pallas/rank_kernel.py:126::_pallas_rank_sorted (B3,
// kernel body _make_kernel :50).
//
// pair_merge_kernel: S independent rank problems in one launch.  Segment s
//   ranks its sorted queries (q_k, q_v)[0, m_s) in its sorted table
//   (a_k, a_v)[0, n_s), pairs compared signed-lexicographically: #{a < q}
//   when strict, #{a <= q} otherwise.  A segment may carry B2's windows
//   (c_lo, n_chunks, int32, one per kBlock queries): query j's rank r then
//   becomes min(max(r, w0), max(w1, w0)) with w0 = c_lo[j / kBlock] *
//   kChunk and w1 = min((c_lo + max(n_chunks, 0)) * kChunk, n), which is
//   the TPU kernel's c_lo * kChunk + #{window rows before q} for c_lo >= 0
//   (for host_windows' exact windows, the global rank).  Each segment writes
//   its int32 ranks and/or adds their sum into a u64.
//
//   The first designs searched: B3 loaded the build's 512 chunk-boundary
//   pairs into every block (a scattered 4-byte load each, 8 KB apart), ran
//   two serial searches there, then ~11 dependent binary-search steps a
//   query into L2 (9 % of the HBM bound at its cap); B2 staged every chunk
//   of a block's window through shared memory with no overlap (16 KB and
//   two barriers a chunk), so at the genome shape each build chunk was read
//   about 26 times, and the two count passes were two launches (12 %).
//   Both inputs are sorted, so this is B1's merge path (merge_rank.cu, Green,
//   McColl and Bader, "GPU merge path", 2012) over pairs: segment s's merge
//   of n_s + m_s elements is cut into tiles of kTile diagonals, kTiles
//   tiles a block, the blocks of all segments in one flat grid.  A block
//   finds the table rows at its kTiles + 1 tile boundaries in global
//   memory, one warp a boundary, 32-ary.  Each pair becomes one int64
//   composite (key << 32 | (value ^ 2^31), the order of ops/ranks.composite)
//   once, when its tile is stored into shared memory, so the searches and
//   the merge compare one 8-byte word where two 4-byte halves would cost two
//   shared loads and the arithmetic each time; tile t + 1's pairs are loaded
//   into registers (coalesced) while tile t is merged.  Each thread finds its
//   diagonal in the tile by a binary search in shared memory and merges
//   kItems elements, reading its queries' windows (at most two) once before
//   the merge; ranks go through shared memory and out coalesced.  Ties: a
//   table element goes before an equal query when non-strict and after it
//   when strict, in the boundary searches and the merge alike.  Every input
//   pair is read about once, whatever the shapes and windows: the windows
//   only clamp.  What bounds it on an H100: the bytes (8 a pair read, 4 a
//   rank written).  The first cut was B1's design as it stands (keys and
//   values double-buffered with cp.async, 7 tiles a block, a window load a
//   rank): 0.128 ms at B2's genome pass u against 0.085 for this one
//   (PERF.md, PR 5), which takes the composites, the windows read once a
//   thread, and 4 tiles a block at 5 blocks an SM (a register cap of 51),
//   each of which measured faster than the choice it replaced.
//
// Plain C interface for ctypes.  The entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // merge diagonals a tile
constexpr int kTiles = 4;  // tiles a block: a warp a boundary, 5 of 8 warps
constexpr int64_t kSpan = static_cast<int64_t>(kTiles) * kTile;  // diagonals a block
constexpr int kBases = 16;                // per-call tensors a launch names
constexpr int kInline = 2;                // segments passed as parameters
constexpr int kBlock = 256;               // queries a window (the TPU kernels' BLOCK)
constexpr int kChunk = 2048;              // table rows a window chunk (CHUNK)

// One row of the descriptor table (int64 fields, in the order of
// ops/cuda/pair_merge.py's FIELDS).  A "slot" names one of the
// launch's per-call base tensors; offsets count int32 elements.
struct Segment {
  int64_t ak_slot, ak_off, av_slot, av_off;  // table keys, values
  int64_t n;                                 // table rows
  int64_t qk_slot, qk_off, qv_slot, qv_off;  // query keys, values
  int64_t m;                                 // queries
  int64_t strict;
  int64_t lo_slot, lo_off, nch_slot, nch_off;  // windows; lo_slot < 0: none
  int64_t out_slot, out_off;                 // int32 ranks; out_slot < 0: none
  int64_t total_slot, total_off;             // u64 sum; total_slot < 0: none
  int64_t block0;                            // first block of the segment
};
static_assert(sizeof(Segment) == 20 * sizeof(int64_t), "descriptor layout");

struct Params {
  Segment inl[kInline];  // the segments when segs is null
  const Segment* segs;   // device table of n_segs descriptors
  int32_t n_segs;
  uint64_t base[kBases];
};

// (key, value) as one int64 whose signed order is the pair's
__device__ __forceinline__ int64_t pair(int32_t k, int32_t v) {
  const uint64_t hi = static_cast<uint64_t>(static_cast<uint32_t>(k)) << 32;
  return static_cast<int64_t>(hi | (static_cast<uint32_t>(v) ^ 0x80000000u));
}

struct Pairs {  // a sorted sequence of pairs in global memory
  const int32_t* k;
  const int32_t* v;
  __device__ __forceinline__ int64_t operator[](int64_t i) const {
    return pair(__ldg(k + i), __ldg(v + i));
  }
};

struct Window {  // B2's windows; lo == nullptr: none
  const int32_t* lo;
  const int32_t* nch;
  int64_t n, m;
  // [w0, w1) of query block blk; an empty window at w0 when w1 < w0
  __device__ __forceinline__ void bounds(int64_t blk, int64_t& w0, int64_t& w1) const {
    const int64_t c0 = __ldg(lo + blk);
    const int32_t c = __ldg(nch + blk);
    w0 = c0 * kChunk;
    w1 = (c0 + (c > 0 ? c : 0)) * kChunk;
    w1 = w1 < n ? w1 : n;
    w1 = w1 > w0 ? w1 : w0;
  }
};

__device__ __forceinline__ bool before(int64_t a, int64_t q, bool strict) {
  // does table pair a precede query q in the merged order?
  return strict ? a < q : a <= q;
}

// The table rows among the first d elements of the merge of a[0, n) and
// q[0, m): the first i on the diagonal whose table pair does not precede
// the query at d - 1 - i.  One warp searches 32-ary, one pair a lane a
// round, so a round costs one global load latency.  Every lane gets it.
__device__ int64_t warp_split(const Pairs& a, int64_t n, const Pairs& q, int64_t m,
                              int64_t d, bool strict) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > m ? d - m : 0;
  int64_t hi = d < n ? d : n;
  while (lo < hi) {  // uniform across the warp
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t pos = lo + lane * step;
    const bool pred = pos < hi && before(a[pos], q[d - 1 - pos], strict);
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

// one thread's share of a tile in registers: elements threadIdx.x + r * kThreads
struct Staged {
  int32_t k[kItems];
  int32_t v[kItems];
};

__device__ __forceinline__ void load_tile(Staged& st, const TileSpan& s, const Pairs& a,
                                          const Pairs& q) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    if (idx < s.na) {
      st.k[r] = __ldg(a.k + s.i0 + idx);
      st.v[r] = __ldg(a.v + s.i0 + idx);
    } else if (idx < s.na + s.nq) {
      st.k[r] = __ldg(q.k + s.j0 + (idx - s.na));
      st.v[r] = __ldg(q.v + s.j0 + (idx - s.na));
    }
  }
}

__device__ __forceinline__ void store_tile(int64_t* tile, const Staged& st, const TileSpan& s) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    if (idx < s.na + s.nq) tile[idx] = pair(st.k[r], st.v[r]);
  }
}

// One thread's kItems diagonals of a tile of composites (the table slice,
// then the queries): its own split by a binary search in shared memory,
// then a sequential merge that keeps the current table pair and query in
// registers, putting the (clamped) rank of each query it passes at
// ranks[j] (the tile's query j) when ranks is not null; returns their sum.
template <bool kStrict, bool kWindow>
__device__ __forceinline__ long long merge_tile(const int64_t* buf, const TileSpan& s,
                                                const Window& w, int32_t* ranks) {
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
  // a thread's queries lie in at most two query blocks: both windows now
  int64_t blk = 0, w0 = 0, w1 = 0, x0 = 0, x1 = 0;
  if (kWindow && j < nq) {
    blk = (s.j0 + j) / kBlock;
    w.bounds(blk, w0, w1);
    if ((blk + 1) * kBlock < w.m) w.bounds(blk + 1, x0, x1);
  }
  int64_t av = i < na ? buf[i] : 0;
  int64_t qv = j < nq ? buf[na + j] : 0;
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (dl + k < end) {
      if (j >= nq || (i < na && before(av, qv, kStrict))) {
        ++i;
        av = i < na ? buf[i] : 0;
      } else {
        int64_t r = s.i0 + i;
        if (kWindow) {
          const bool same = (s.j0 + j) / kBlock == blk;
          const int64_t lo_w = same ? w0 : x0, hi_w = same ? w1 : x1;
          r = r > lo_w ? r : lo_w;
          r = r < hi_w ? r : hi_w;
        }
        sum += r;
        if (ranks != nullptr) ranks[j] = static_cast<int32_t>(r);
        ++j;
        qv = j < nq ? buf[na + j] : 0;
      }
    }
  }
  return sum;
}

template <bool kStrict>
__device__ __forceinline__ long long merge_windowed(const int64_t* buf, const TileSpan& s,
                                                    const Window& w, int32_t* ranks) {
  return w.lo != nullptr ? merge_tile<kStrict, true>(buf, s, w, ranks)
                         : merge_tile<kStrict, false>(buf, s, w, ranks);
}

template <typename T>
__device__ __forceinline__ T* at(const Params& p, int64_t slot, int64_t off) {
  return slot >= 0 ? reinterpret_cast<T*>(p.base[slot]) + off : nullptr;
}

__global__ void __launch_bounds__(kThreads, 5)  // 5 blocks an SM
pair_merge_kernel(const __grid_constant__ Params p) {
  __shared__ Segment sg;
  __shared__ int64_t split[kTiles + 1];
  __shared__ int64_t tile[kTile];  // composites: table slice, then queries
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
  const Pairs a{at<const int32_t>(p, sg.ak_slot, sg.ak_off), at<const int32_t>(p, sg.av_slot, sg.av_off)};
  const Pairs q{at<const int32_t>(p, sg.qk_slot, sg.qk_off), at<const int32_t>(p, sg.qv_slot, sg.qv_off)};
  const Window w{at<const int32_t>(p, sg.lo_slot, sg.lo_off),
                 at<const int32_t>(p, sg.nch_slot, sg.nch_off), n, m};
  int32_t* out = at<int32_t>(p, sg.out_slot, sg.out_off);
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

  // tile t + 1 is loaded into registers while tile t is merged
  long long sum = 0;
  Staged st;
  TileSpan cur = tile_span(split, 0, d_begin, total_d);
  load_tile(st, cur, a, q);
  for (int t = 0; t < tiles; ++t) {
    store_tile(tile, st, cur);
    __syncthreads();
    TileSpan nxt = cur;
    if (t + 1 < tiles) {
      nxt = tile_span(split, t + 1, d_begin, total_d);
      load_tile(st, nxt, a, q);
    }
    int32_t* tile_ranks = out != nullptr ? ranks : nullptr;
    sum += strict ? merge_windowed<true>(tile, cur, w, tile_ranks)
                  : merge_windowed<false>(tile, cur, w, tile_ranks);
    if (out != nullptr) {  // uniform across the block
      __syncthreads();  // neighbouring threads store neighbouring queries' ranks
      for (int k = threadIdx.x; k < cur.nq; k += kThreads) out[cur.j0 + k] = ranks[k];
    }
    __syncthreads();  // the tile is free for tile t + 1
    cur = nxt;
  }
  if (sg.total_slot < 0) return;  // uniform across the block
  // a clamped rank may be negative (c_lo < 0): the u64 sum wraps as int64
  block_sum_to<kThreads>(static_cast<unsigned long long>(sum),
                         at<unsigned long long>(p, sg.total_slot, sg.total_off));
}

}  // namespace

// segs: a device table of n_segs descriptors, or null and then
// inline_segs: n_segs <= kInline descriptors in host memory, passed as
// kernel parameters.  bases: kBases device addresses in host memory.
// blocks: the segments' blocks in all (the last block0 plus its blocks).
extern "C" int seq_pair_merge(const void* inline_segs, const void* segs, int32_t n_segs,
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
  pair_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
