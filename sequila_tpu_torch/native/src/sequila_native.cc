// sequila-tpu native host index — C++17 interval index for the CPU
// execution path.
//
// Role-equivalent of the reference's vendored superintervals C++ library
// (reference superintervals/src/superintervals.hpp: flat sorted arrays,
// branchless binary search, SIMD count loops) but an original design
// shared with the engine's device kernels: a (key,start)-sorted view with
// a per-key-segment running max of ends (the candidate-window lower
// bound), an independently (key,end)-sorted array for BITS counting
// (#start<=qe - #end<qs), and a key-segment directory so every binary
// search runs over segment-local int32 arrays (half the memory traffic
// of the composite-int64 layout and the enabler for multithreading).
//
// The hot entry points (count / emit / coverage / nearest / expansion)
// are parallelized over probe chunks with std::thread — the engine's
// analog of the reference's SIMD count loops (superintervals.rs:395-638):
// same goal (host-side counting/emission at memory-bandwidth speed),
// different axis (4-16 cores instead of 8 SIMD lanes, because the probe
// loop here is bandwidth-bound across cache-missing binary searches, not
// lane-parallel compares).  SEQUILA_NATIVE_THREADS caps the pool.
//
// Exposed as a C ABI consumed through ctypes (sequila_tpu/native/loader.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

struct Index {
  int64_t n = 0;
  // (key, start, end)-sorted view
  std::vector<int32_t> keys, starts, ends, pos;
  // per-SEGMENT running max of ends in (key,start) order (resets per key)
  std::vector<int32_t> cummax_end;
  // per-segment ends ascending (ties: start desc, row desc) + source rows
  std::vector<int32_t> ends_sorted;
  std::vector<int32_t> end_pos;
  // segment directory: ascending unique keys, [seg_off[s], seg_off[s+1])
  std::vector<int32_t> seg_keys;
  std::vector<int64_t> seg_off;
  bool has_inverted = false;  // any end < start: BITS count invalid
  // Eytzinger (BFS-order) layout of the three per-probe search arrays —
  // the engine's analog of the reference's experimental
  // SuperIntervalsEytz variant (reference superintervals/src/variants/
  // superintervals_var.hpp:770-816 swaps the start upper-bound for an
  // Eytzinger descent).  Per segment: slots [eytz_off[s]+1,
  // eytz_off[s]+len] hold the segment's values in BFS order (slot 0 of
  // each block unused), *_rank maps a BFS slot back to the value's rank
  // within the sorted segment.  The first ~4 tree levels share a cache
  // line and the descent prefetches 4 levels ahead, so large segments
  // (L2-resident and beyond) search 1.8-2.7x faster than segment-local
  // std::lower_bound on this host (5M x 5M count: 849 -> 507 ms;
  // 100k x 100k: 8.1 -> 3.0 ms; build cost is noise).  DEFAULT layout;
  // SEQUILA_NATIVE_LAYOUT=segment at si_build time opts out.
  bool eytz = false;
  std::vector<int32_t> eytz_starts, eytz_starts_rank;
  std::vector<int32_t> eytz_ends, eytz_ends_rank;
  std::vector<int32_t> eytz_cummax, eytz_cummax_rank;
  std::vector<int64_t> eytz_off;  // per-segment block offsets (len+1 each)
  // AIList-style level decomposition (emission; the published AIList
  // technique, Feng/Ratan/Sheffield 2019 — no counterpart in the
  // reference, whose emit walks per-row tree queries,
  // joins/interval_join.rs:1580-1640): within one (segment,
  // level) run, starts AND ends both ascend, so the overlap set of any
  // query — including degenerate stabbing (qs > qe) and inverted build
  // rows — is the contiguous run [lower_bound(ends, qs),
  // upper_bound(starts, qe)).  Emission copies exactly the matches; the
  // cummax-window scan it replaces touched ~20x more candidates than
  // matches on long-tailed genomic tracks (measured on the databio-like
  // chain tables).  Levels are assigned greedily first-fit in (start,
  // end, row) order — the patience-sorting argument keeps the per-level
  // tail ends non-increasing across levels, so placement is a binary
  // search and the level count is the MINIMUM possible (the length of
  // the longest strictly-decreasing end subsequence per segment).
  std::vector<int32_t> lvl_starts, lvl_ends, lvl_pos;
  // flat per-(segment, level) bounds: segment s's level l spans
  // [lvl_bounds[lvl_dir[s]+l], lvl_bounds[lvl_dir[s]+l+1]); lvl_dir has
  // nseg+1 entries so a segment's level count is dir[s+1]-dir[s]-1.
  std::vector<int64_t> lvl_bounds;
  std::vector<int64_t> lvl_dir;
  // Bucketed search hints per (segment, level), one grid over starts and
  // one over ends: hint[b] = lower_bound(values, base + (b << g)), so a
  // query's bound is a hint load plus a short gallop — genomic
  // coordinates are near-uniform within a contig, so the expected gallop
  // is O(1) where a cold per-level binary search costs ~12 cache-missing
  // steps.  Grids are sized to ~2 rows per bucket (<= 8 bytes/row).
  // Indexed by the same flat slot `d` as lvl_bounds.
  std::vector<int32_t> lvl_hints;          // shared hint pool
  std::vector<int64_t> hint_s_off, hint_e_off;  // slot -> pool offset
  std::vector<int32_t> hint_s_nb, hint_e_nb;    // slot -> bucket count
  std::vector<int32_t> hint_s_base, hint_e_base;  // slot -> grid origin
  std::vector<int8_t> hint_s_g, hint_e_g;         // slot -> log2 bucket
  // Lazily-built exclusive prefix sums of `starts` (in (key,start)
  // order) and `ends_sorted` (per-segment end order), both n+1 int64 —
  // the coverage rank decomposition's lookup tables (si_coverage).
  // call_once so concurrent first coverage calls build them once.
  mutable std::vector<int64_t> pfx_start, pfx_end;
  mutable std::once_flag pfx_once;
};

// first index in [0,len) with v[i] > x, seeded by the bucket grid
inline int64_t hint_ub32(const int32_t* v, int64_t len, const int32_t* hints,
                         int64_t nb, int32_t base, int32_t g, int32_t x) {
  if (x < base) return 0;
  int64_t b = (int64_t(x) - base) >> g;
  if (b >= nb) b = nb - 1;
  int64_t i = hints[b];  // v[i-1] < bucket base <= x
  int64_t step = 1;
  while (i + step <= len && v[i + step - 1] <= x) {
    i += step;
    step <<= 1;
  }
  const int64_t hi = std::min(i + step - 1, len);
  return i + (std::upper_bound(v + i, v + hi, x) - (v + i));
}

// first index in [0,len) with v[i] >= x, seeded by the bucket grid
inline int64_t hint_lb32(const int32_t* v, int64_t len, const int32_t* hints,
                         int64_t nb, int32_t base, int32_t g, int32_t x) {
  if (x <= base) return 0;  // base == v[0], so v[0] >= x
  int64_t b = (int64_t(x) - base) >> g;
  if (b >= nb) b = nb - 1;
  int64_t i = hints[b];  // v[i-1] < bucket base <= x  ->  v[i-1] < x
  int64_t step = 1;
  while (i + step <= len && v[i + step - 1] < x) {
    i += step;
    step <<= 1;
  }
  const int64_t hi = std::min(i + step - 1, len);
  return i + (std::lower_bound(v + i, v + hi, x) - (v + i));
}

// first index in [0,len) with v[i] >= x
inline int64_t lb32(const int32_t* v, int64_t len, int32_t x) {
  return std::lower_bound(v, v + len, x) - v;
}

// first index in [0,len) with v[i] > x
inline int64_t ub32(const int32_t* v, int64_t len, int32_t x) {
  return std::upper_bound(v, v + len, x) - v;
}

int num_threads(int64_t work, int64_t grain) {
  const char* env = std::getenv("SEQUILA_NATIVE_THREADS");
  if (env != nullptr) {
    int v = std::atoi(env);
    if (v >= 1) return std::min(v, 64);
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = int(hw ? hw : 4);
  int64_t chunks = (work + grain - 1) / grain;
  if (chunks < nt) nt = int(chunks);
  return std::max(nt, 1);
}

// f(lo, hi) over [0, m) split into contiguous chunks, one per thread.
template <class F>
void parallel_chunks(int64_t m, int64_t grain, F f) {
  int nt = num_threads(m, grain);
  if (nt <= 1 || m <= grain) {
    f(int64_t(0), m);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  const int64_t per = (m + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per;
    const int64_t hi = std::min(m, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=] { f(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

// Stable parallel LSD radix permutation over multiple int32 key arrays,
// least-significant array first (the build-time engine behind both index
// orders; same histogram/scan/scatter scheme as si_argsort64 below).
// Carries (current 16-bit-digit source, index) pairs and re-gathers when
// switching key arrays; digit passes where all elements share one bucket
// are skipped (common for high halves of small key spaces).  Returns the
// permutation that sorts lexicographically by (keys.back(), ...,
// keys.front(), original index) — i.e. ties are deterministic, original
// order.  Comparator std::sort measured 3.1 s for the 7.7M-row build;
// this runs the same order in ~6 digit passes, each bandwidth-bound.
void radix_perm32(int64_t n, const std::vector<const int32_t*>& keys,
                  int32_t* out_perm) {
  struct KV {
    uint32_t key;
    int32_t idx;
  };
  std::vector<KV> a(n), b(n);
  parallel_chunks(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) a[i].idx = int32_t(i);
  });
  const int nt = num_threads(n, 1 << 16);
  const int64_t per = (n + nt - 1) / nt;
  std::vector<std::vector<int64_t>> hist(nt);
  KV* src = a.data();
  KV* dst = b.data();
  constexpr uint32_t BIAS = uint32_t(1) << 31;  // int32 -> order-preserving
  for (const int32_t* karr : keys) {
    // refill the carried key from this array (gather via current perm)
    parallel_chunks(n, 1 << 16, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i)
        src[i].key = uint32_t(karr[src[i].idx]) + BIAS;
    });
    for (int pass = 0; pass < 2; ++pass) {
      const int shift = pass * 16;
      {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) {
          const int64_t lo = int64_t(t) * per, hi = std::min(n, lo + per);
          if (lo >= hi) {
            hist[t].assign(65536, 0);
            continue;
          }
          ts.emplace_back([=, &hist] {
            auto& h = hist[t];
            h.assign(65536, 0);
            for (int64_t i = lo; i < hi; ++i)
              ++h[(src[i].key >> shift) & 0xFFFF];
          });
        }
        for (auto& th : ts) th.join();
      }
      int nonzero = 0;
      for (int d = 0; d < 65536 && nonzero < 2; ++d) {
        int64_t s = 0;
        for (int t = 0; t < nt; ++t) s += hist[t][d];
        if (s) ++nonzero;
      }
      if (nonzero < 2) continue;
      int64_t run = 0;
      for (int d = 0; d < 65536; ++d) {
        for (int t = 0; t < nt; ++t) {
          const int64_t c = hist[t][d];
          hist[t][d] = run;
          run += c;
        }
      }
      {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) {
          const int64_t lo = int64_t(t) * per, hi = std::min(n, lo + per);
          if (lo >= hi) break;
          ts.emplace_back([=, &hist] {
            auto& h = hist[t];
            for (int64_t i = lo; i < hi; ++i)
              dst[h[(src[i].key >> shift) & 0xFFFF]++] = src[i];
          });
        }
        for (auto& th : ts) th.join();
      }
      std::swap(src, dst);
    }
  }
  parallel_chunks(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out_perm[i] = src[i].idx;
  });
}

// In-order fill of one segment's Eytzinger block: BFS slot k gets the
// i-th smallest value (and records i as its rank).  Recursion depth is
// the tree height (<= 31 for int32-indexed segments).
int64_t eytz_fill(const int32_t* sorted_vals, int64_t len, int32_t* ev,
                  int32_t* er, int64_t i, int64_t k) {
  if (k <= len) {
    i = eytz_fill(sorted_vals, len, ev, er, i, 2 * k);
    ev[k] = sorted_vals[i];
    er[k] = int32_t(i);
    ++i;
    i = eytz_fill(sorted_vals, len, ev, er, i, 2 * k + 1);
  }
  return i;
}

// Branchless Eytzinger descent.  `ge`: rank of the first value >= x
// (lower bound); `gt`: first > x (upper bound).  Returns len on miss.
// The BFS layout keeps the first ~4 levels in one cache line and makes
// the +4-levels-ahead prefetch exact — the point of the variant.
inline int64_t eytz_rank_ge(const int32_t* v, const int32_t* rank,
                            int64_t len, int32_t x) {
  uint64_t k = 1;
  while (int64_t(k) <= len) {
    __builtin_prefetch(v + k * 16);
    k = 2 * k + uint64_t(v[k] < x);
  }
  k >>= __builtin_ctzll(~k) + 1;
  return k == 0 ? len : rank[k];
}

inline int64_t eytz_rank_gt(const int32_t* v, const int32_t* rank,
                            int64_t len, int32_t x) {
  uint64_t k = 1;
  while (int64_t(k) <= len) {
    __builtin_prefetch(v + k * 16);
    k = 2 * k + uint64_t(v[k] <= x);
  }
  k >>= __builtin_ctzll(~k) + 1;
  return k == 0 ? len : rank[k];
}

// Segment-local bound ranks, routed through the index's layout.  All
// return a rank in [0, len] relative to the segment base `lo`.
inline int64_t rank_start_gt(const Index* idx, int64_t sgi, int64_t lo,
                             int64_t len, int32_t x) {
  if (idx->eytz) {
    const int64_t eo = idx->eytz_off[sgi];
    return eytz_rank_gt(idx->eytz_starts.data() + eo,
                        idx->eytz_starts_rank.data() + eo, len, x);
  }
  return ub32(idx->starts.data() + lo, len, x);
}

inline int64_t rank_ends_ge(const Index* idx, int64_t sgi, int64_t lo,
                            int64_t len, int32_t x) {
  if (idx->eytz) {
    const int64_t eo = idx->eytz_off[sgi];
    return eytz_rank_ge(idx->eytz_ends.data() + eo,
                        idx->eytz_ends_rank.data() + eo, len, x);
  }
  return lb32(idx->ends_sorted.data() + lo, len, x);
}

inline int64_t rank_start_ge(const Index* idx, int64_t sgi, int64_t lo,
                             int64_t len, int32_t x) {
  if (idx->eytz) {
    const int64_t eo = idx->eytz_off[sgi];
    return eytz_rank_ge(idx->eytz_starts.data() + eo,
                        idx->eytz_starts_rank.data() + eo, len, x);
  }
  return lb32(idx->starts.data() + lo, len, x);
}

inline int64_t rank_ends_gt(const Index* idx, int64_t sgi, int64_t lo,
                            int64_t len, int32_t x) {
  if (idx->eytz) {
    const int64_t eo = idx->eytz_off[sgi];
    return eytz_rank_gt(idx->eytz_ends.data() + eo,
                        idx->eytz_ends_rank.data() + eo, len, x);
  }
  return ub32(idx->ends_sorted.data() + lo, len, x);
}

inline int64_t rank_cummax_ge(const Index* idx, int64_t sgi, int64_t lo,
                              int64_t len, int32_t x) {
  if (idx->eytz) {
    const int64_t eo = idx->eytz_off[sgi];
    return eytz_rank_ge(idx->eytz_cummax.data() + eo,
                        idx->eytz_cummax_rank.data() + eo, len, x);
  }
  return lb32(idx->cummax_end.data() + lo, len, x);
}

// Segment of key `k`, or -1.  `last` caches the previous hit — probe
// batches are usually key-clustered, making the directory search free.
inline int64_t find_seg(const Index* idx, int32_t k, int64_t* last) {
  if (*last >= 0 && idx->seg_keys[*last] == k) return *last;
  const auto& sk = idx->seg_keys;
  auto it = std::lower_bound(sk.begin(), sk.end(), k);
  if (it == sk.end() || *it != k) return -1;
  *last = it - sk.begin();
  return *last;
}

// Shared emission walk: level-run enumeration with the size-gated
// (key, qs)-sorted traversal and per-level monotone gallop cursors (see
// si_emit_at's doc).  ``per_run(i, w, rows, run)`` handles one match run
// (rows = level-view position slice); ``per_span(i, w0, w)`` runs once
// per query after its runs (w0..w = the query's whole output span).
// The pair emitter and the fused column emitter instantiate it — one
// copy of the walk, two innermost writers.
template <class PerRun, class PerSpan>
int64_t emit_walk(const Index* idx, const int32_t* qk, const int32_t* qs,
                  const int32_t* qe, int64_t m, const int64_t* offs,
                  int64_t grain, PerRun per_run, PerSpan per_span) {
  std::vector<int32_t> order;
  const char* sw_env = std::getenv("SEQUILA_EMIT_SORTED_WALK");
  const bool sorted_walk =
      sw_env != nullptr
          ? (sw_env[0] == '1' && m >= 2)
          : (m >= 4096 && idx->n >= (int64_t(1) << 19));
  if (sorted_walk) {
    order.resize(size_t(m));
    radix_perm32(m, {qs, qk}, order.data());
  }
  std::atomic<int64_t> written{0};
  parallel_chunks(m, grain, [&](int64_t j0, int64_t j1) {
    int64_t local = 0;
    int64_t last = -1;
    int64_t cur_seg = -1;
    std::vector<int64_t> lb_cur;  // per-level monotone cursors (sorted walk)
    const int32_t* pos = idx->lvl_pos.data();
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t i = sorted_walk ? order[j] : j;
      const int64_t w0 = offs[i];
      int64_t w = w0;
      const int64_t w_end = offs[i + 1];
      if (w >= w_end) continue;
      const int64_t sgi = find_seg(idx, qk[i], &last);
      if (sgi < 0) continue;
      const int32_t qsi = qs[i], qei = qe[i];
      const int64_t d0 = idx->lvl_dir[sgi], d1 = idx->lvl_dir[sgi + 1];
      if (sorted_walk && sgi != cur_seg) {
        cur_seg = sgi;
        lb_cur.assign(size_t(d1 - d0), -1);
      }
      for (int64_t d = d0; d + 1 < d1 && w < w_end; ++d) {
        const int64_t llo = idx->lvl_bounds[d];
        const int64_t llen = idx->lvl_bounds[d + 1] - llo;
        const int64_t ub = hint_ub32(
            idx->lvl_starts.data() + llo, llen,
            idx->lvl_hints.data() + idx->hint_s_off[d], idx->hint_s_nb[d],
            idx->hint_s_base[d], idx->hint_s_g[d], qei);
        int64_t lb;
        if (sorted_walk) {
          // qs ascends within the segment: gallop forward from the
          // cursor (the level's first query seeds it from the grid)
          const int32_t* ends = idx->lvl_ends.data() + llo;
          int64_t c = lb_cur[size_t(d - d0)];
          if (c < 0) {
            c = hint_lb32(ends, llen,
                          idx->lvl_hints.data() + idx->hint_e_off[d],
                          idx->hint_e_nb[d], idx->hint_e_base[d],
                          idx->hint_e_g[d], qsi);
          } else {
            int64_t step = 1;
            while (c + step <= llen && ends[c + step - 1] < qsi) {
              c += step;
              step <<= 1;
            }
            const int64_t wh = std::min(c + step - 1, llen);
            c += std::lower_bound(ends + c, ends + wh, qsi) - (ends + c);
          }
          lb_cur[size_t(d - d0)] = c;
          lb = c;
        } else {
          lb = hint_lb32(
              idx->lvl_ends.data() + llo, llen,
              idx->lvl_hints.data() + idx->hint_e_off[d], idx->hint_e_nb[d],
              idx->hint_e_base[d], idx->hint_e_g[d], qsi);
        }
        int64_t run = ub - lb;
        if (run <= 0) continue;
        if (run > w_end - w) run = w_end - w;  // belt-and-braces cap
        per_run(i, w, pos + llo + lb, run);
        w += run;
      }
      if (w > w0) per_span(i, w0, w);
      local += w - w0;
    }
    written.fetch_add(local, std::memory_order_relaxed);
  });
  return written.load();
}

// Bucket-hint grid over a sorted int64 array: hint[b] = lower_bound(v,
// base + (b << g)).  Shared by the subtract kernel below; same scheme as
// the inline grid in si_searchsorted64 (one O(n + buckets) build sweep
// turns each search into a hint load + short gallop).
struct HintGrid64 {
  std::vector<int32_t> hints;
  int64_t base = 0, nb = 0;
  int32_t g = 0;
  bool ok = false;
};

HintGrid64 build_grid64(const int64_t* v, int64_t n, int64_t nqueries) {
  HintGrid64 hg;
  if (nqueries >= 4096 && n >= 2 && n <= 32 * nqueries && n <= INT32_MAX &&
      v[n - 1] > v[0]) {
    hg.base = v[0];
    const uint64_t span = uint64_t(v[n - 1] - hg.base);
    while ((span >> hg.g) > uint64_t(2 * n)) ++hg.g;
    hg.nb = int64_t(span >> hg.g) + 1;
    hg.hints.assign(size_t(hg.nb), 0);
    int64_t i = 0;
    for (int64_t b = 0; b < hg.nb; ++b) {
      const int64_t thresh = hg.base + (int64_t(b) << hg.g);
      while (i < n && v[i] < thresh) ++i;
      hg.hints[b] = int32_t(i);
    }
    hg.ok = true;
  }
  return hg;
}

// first index in [0,n) with v[i] >= x, seeded by the grid when built
inline int64_t grid_lb64(const HintGrid64& hg, const int64_t* v, int64_t n,
                         int64_t x) {
  if (!hg.ok) return std::lower_bound(v, v + n, x) - v;
  if (x <= hg.base) return 0;  // base == v[0]
  int64_t b = int64_t(uint64_t(x - hg.base) >> hg.g);
  if (b >= hg.nb) b = hg.nb - 1;
  int64_t i = hg.hints[b];  // v[i-1] < bucket base <= x
  int64_t step = 1;
  while (i + step <= n && v[i + step - 1] < x) {
    i += step;
    step <<= 1;
  }
  const int64_t hi = std::min(i + step - 1, n);
  return i + (std::lower_bound(v + i, v + hi, x) - (v + i));
}

}  // namespace

extern "C" {

void* si_build(const int32_t* k, const int32_t* s, const int32_t* e,
               int64_t n) {
  auto* idx = new Index();
  idx->n = n;
  // (key, start, end, row)-order via the parallel radix: LSD over
  // end -> start -> key, starting from identity, so full-duplicate ties
  // land in ascending original row (deterministic, matching the device
  // kernels' canonical tie handling)
  std::vector<int32_t> order(n);
  if (n >= 4096) {
    radix_perm32(n, {e, s, k}, order.data());
  } else {
    for (int64_t i = 0; i < n; ++i) order[i] = int32_t(i);
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
      if (k[a] != k[b]) return k[a] < k[b];
      if (s[a] != s[b]) return s[a] < s[b];
      if (e[a] != e[b]) return e[a] < e[b];
      return a < b;
    });
  }
  idx->keys.resize(n);
  idx->starts.resize(n);
  idx->ends.resize(n);
  idx->pos.resize(n);
  idx->cummax_end.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t o = order[i];
    idx->keys[i] = k[o];
    idx->starts[i] = s[o];
    idx->ends[i] = e[o];
    idx->pos[i] = int32_t(o);
    if (e[o] < s[o]) idx->has_inverted = true;
  }
  // segment directory over the sorted keys
  idx->seg_off.push_back(0);
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || idx->keys[i] != idx->keys[i - 1]) {
      idx->seg_keys.push_back(idx->keys[i]);
      if (i != 0) idx->seg_off.push_back(i);
    }
  }
  if (n) idx->seg_off.push_back(n);
  if (idx->seg_off.size() < 2) idx->seg_off.assign(2, 0);
  // per-segment cummax of ends (the candidate-window floor)
  for (size_t sgi = 0; sgi + 1 < idx->seg_off.size(); ++sgi) {
    int32_t running = INT32_MIN;
    for (int64_t i = idx->seg_off[sgi]; i < idx->seg_off[sgi + 1]; ++i) {
      running = std::max(running, idx->ends[i]);
      idx->cummax_end[i] = running;
    }
  }
  // per-segment (end asc, start asc, row asc)-sorted ends + rows: the
  // BITS lower bound, and the predecessor of lower_bound(qs) is the
  // max-end-below-qs interval — the O(log n) upstream-nearest candidate.
  // The tie order keeps the LARGEST (start, row) last so the predecessor
  // is the canonical upstream pick max(end, start, row), matching the
  // device kernel (ops/interval_join.py nearest_from_bounds) and the
  // NumPy host index bit-for-bit.
  // Global stable radix by (key, end, start) over the sorted view: the
  // per-segment ranges are contiguous equal-key runs, so this yields each
  // segment's (end asc, start asc, pos asc) order in one pass set —
  // identity start keeps full-duplicate ties pos-ascending because the
  // main order above already placed them that way.
  std::vector<int32_t> eorder(n);
  idx->ends_sorted.resize(n);
  idx->end_pos.resize(n);
  if (n >= 4096) {
    radix_perm32(
        n, {idx->starts.data(), idx->ends.data(), idx->keys.data()},
        eorder.data());
  } else {
    for (int64_t i = 0; i < n; ++i) eorder[i] = int32_t(i);
    std::sort(eorder.begin(), eorder.end(), [&](int32_t a, int32_t b) {
      if (idx->keys[a] != idx->keys[b]) return idx->keys[a] < idx->keys[b];
      if (idx->ends[a] != idx->ends[b]) return idx->ends[a] < idx->ends[b];
      if (idx->starts[a] != idx->starts[b])
        return idx->starts[a] < idx->starts[b];
      return idx->pos[a] < idx->pos[b];
    });
  }
  parallel_chunks(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      idx->ends_sorted[i] = idx->ends[eorder[i]];
      idx->end_pos[i] = idx->pos[eorder[i]];
    }
  });
  // Level decomposition for emission (see Index comment).  Per segment:
  // greedy first-fit over the (start, end, row)-sorted rows, then a
  // stable counting sort into (level, start) order — appending in start
  // order keeps starts ascending per level, and the first-fit condition
  // (tail end <= this end) keeps ends ascending per level.
  {
    const int64_t nseg = int64_t(idx->seg_keys.size());
    std::vector<int32_t> level(size_t(n), 0);
    std::vector<int32_t> seg_nlvl(size_t(nseg), 0);
    parallel_chunks(nseg, 1, [&](int64_t s0, int64_t s1) {
      std::vector<int32_t> tails;  // non-increasing across levels
      for (int64_t sg = s0; sg < s1; ++sg) {
        tails.clear();
        for (int64_t i = idx->seg_off[sg]; i < idx->seg_off[sg + 1]; ++i) {
          const int32_t e_i = idx->ends[i];
          // first level whose tail is <= e_i
          auto it = std::partition_point(
              tails.begin(), tails.end(),
              [&](int32_t t) { return t > e_i; });
          if (it == tails.end()) {
            tails.push_back(e_i);
            level[i] = int32_t(tails.size()) - 1;
          } else {
            level[i] = int32_t(it - tails.begin());
            *it = e_i;
          }
        }
        seg_nlvl[sg] = int32_t(tails.size());
      }
    });
    idx->lvl_dir.resize(size_t(nseg) + 1);
    int64_t acc = 0;
    for (int64_t sg = 0; sg < nseg; ++sg) {
      idx->lvl_dir[sg] = acc;
      acc += seg_nlvl[sg] + 1;
    }
    idx->lvl_dir[nseg] = acc;
    idx->lvl_bounds.resize(size_t(acc));
    idx->lvl_starts.resize(size_t(n));
    idx->lvl_ends.resize(size_t(n));
    idx->lvl_pos.resize(size_t(n));
    parallel_chunks(nseg, 1, [&](int64_t s0, int64_t s1) {
      std::vector<int64_t> cnt, cursor;
      for (int64_t sg = s0; sg < s1; ++sg) {
        const int64_t lo = idx->seg_off[sg], hi = idx->seg_off[sg + 1];
        const int32_t nl = seg_nlvl[sg];
        cnt.assign(size_t(nl), 0);
        for (int64_t i = lo; i < hi; ++i) ++cnt[size_t(level[i])];
        int64_t* bounds = idx->lvl_bounds.data() + idx->lvl_dir[sg];
        bounds[0] = lo;
        for (int32_t l = 0; l < nl; ++l) bounds[l + 1] = bounds[l] + cnt[l];
        cursor.assign(bounds, bounds + nl);
        for (int64_t i = lo; i < hi; ++i) {
          const int64_t d = cursor[size_t(level[i])]++;
          idx->lvl_starts[size_t(d)] = idx->starts[i];
          idx->lvl_ends[size_t(d)] = idx->ends[i];
          idx->lvl_pos[size_t(d)] = idx->pos[i];
        }
      }
    });
    // bucketed search hints per (segment, level) over starts and ends
    const int64_t nslot = int64_t(idx->lvl_bounds.size());
    idx->hint_s_off.assign(size_t(nslot), 0);
    idx->hint_e_off.assign(size_t(nslot), 0);
    idx->hint_s_nb.assign(size_t(nslot), 0);
    idx->hint_e_nb.assign(size_t(nslot), 0);
    idx->hint_s_base.assign(size_t(nslot), 0);
    idx->hint_e_base.assign(size_t(nslot), 0);
    idx->hint_s_g.assign(size_t(nslot), 0);
    idx->hint_e_g.assign(size_t(nslot), 0);
    auto grid_shape = [](int64_t span, int64_t len, int32_t* g_out) {
      int32_t g = 0;
      while ((span >> g) > 2 * len) ++g;
      *g_out = g;
      return (span >> g) + 1;  // bucket count
    };
    int64_t pool = 0;
    for (int64_t sg = 0; sg < nseg; ++sg) {
      const int64_t d0 = idx->lvl_dir[sg], d1 = idx->lvl_dir[sg + 1];
      for (int64_t d = d0; d + 1 < d1; ++d) {
        const int64_t llo = idx->lvl_bounds[d];
        const int64_t llen = idx->lvl_bounds[d + 1] - llo;
        int32_t g;
        idx->hint_s_off[d] = pool;
        idx->hint_s_base[d] = idx->lvl_starts[llo];
        int64_t nb = grid_shape(
            int64_t(idx->lvl_starts[llo + llen - 1]) - idx->hint_s_base[d],
            llen, &g);
        idx->hint_s_g[d] = int8_t(g);
        idx->hint_s_nb[d] = int32_t(nb);
        pool += nb;
        idx->hint_e_off[d] = pool;
        idx->hint_e_base[d] = idx->lvl_ends[llo];
        nb = grid_shape(
            int64_t(idx->lvl_ends[llo + llen - 1]) - idx->hint_e_base[d],
            llen, &g);
        idx->hint_e_g[d] = int8_t(g);
        idx->hint_e_nb[d] = int32_t(nb);
        pool += nb;
      }
    }
    idx->lvl_hints.resize(size_t(pool));
    parallel_chunks(nseg, 1, [&](int64_t s0, int64_t s1) {
      auto fill = [&](const int32_t* v, int64_t len, int32_t* hints,
                      int64_t nb, int32_t base, int32_t g) {
        int64_t i = 0;
        for (int64_t b = 0; b < nb; ++b) {
          const int64_t thresh = int64_t(base) + (int64_t(b) << g);
          while (i < len && v[i] < thresh) ++i;
          hints[b] = int32_t(i);
        }
      };
      for (int64_t sg = s0; sg < s1; ++sg) {
        const int64_t d0 = idx->lvl_dir[sg], d1 = idx->lvl_dir[sg + 1];
        for (int64_t d = d0; d + 1 < d1; ++d) {
          const int64_t llo = idx->lvl_bounds[d];
          const int64_t llen = idx->lvl_bounds[d + 1] - llo;
          fill(idx->lvl_starts.data() + llo, llen,
               idx->lvl_hints.data() + idx->hint_s_off[d],
               idx->hint_s_nb[d], idx->hint_s_base[d], idx->hint_s_g[d]);
          fill(idx->lvl_ends.data() + llo, llen,
               idx->lvl_hints.data() + idx->hint_e_off[d],
               idx->hint_e_nb[d], idx->hint_e_base[d], idx->hint_e_g[d]);
        }
      }
    });
  }
  // Eytzinger layout (default; see Index comment for the measurements)
  const char* layout = std::getenv("SEQUILA_NATIVE_LAYOUT");
  const bool want_eytz =
      layout == nullptr || std::strcmp(layout, "segment") != 0;
  if (want_eytz && n) {
    idx->eytz = true;
    const int64_t nseg = int64_t(idx->seg_keys.size());
    idx->eytz_off.resize(nseg + 1);
    for (int64_t s = 0; s < nseg; ++s) idx->eytz_off[s] = idx->seg_off[s] + s;
    idx->eytz_off[nseg] = n + nseg;
    idx->eytz_starts.resize(n + nseg);
    idx->eytz_starts_rank.resize(n + nseg);
    idx->eytz_ends.resize(n + nseg);
    idx->eytz_ends_rank.resize(n + nseg);
    idx->eytz_cummax.resize(n + nseg);
    idx->eytz_cummax_rank.resize(n + nseg);
    parallel_chunks(nseg, 8, [&](int64_t s0, int64_t s1) {
      for (int64_t s = s0; s < s1; ++s) {
        const int64_t lo = idx->seg_off[s];
        const int64_t len = idx->seg_off[s + 1] - lo;
        const int64_t eo = idx->eytz_off[s];
        eytz_fill(idx->starts.data() + lo, len, idx->eytz_starts.data() + eo,
                  idx->eytz_starts_rank.data() + eo, 0, 1);
        eytz_fill(idx->ends_sorted.data() + lo, len,
                  idx->eytz_ends.data() + eo,
                  idx->eytz_ends_rank.data() + eo, 0, 1);
        eytz_fill(idx->cummax_end.data() + lo, len,
                  idx->eytz_cummax.data() + eo,
                  idx->eytz_cummax_rank.data() + eo, 0, 1);
      }
    });
  }
  return idx;
}

void si_free(void* h) { delete static_cast<Index*>(h); }

// Exact per-query overlap counts (BITS within the key segment; degenerate
// qs>qe rows and inverted-build indexes fall back to the window scan).
// Parallel over probe chunks.
void si_count(void* h, const int32_t* qk, const int32_t* qs,
              const int32_t* qe, int64_t m, int64_t* out) {
  const auto* idx = static_cast<const Index*>(h);
  const bool bits_ok = !idx->has_inverted;
  parallel_chunks(m, 16384, [&](int64_t i0, int64_t i1) {
    int64_t last = -1;
    for (int64_t i = i0; i < i1; ++i) {
      const int64_t sgi = find_seg(idx, qk[i], &last);
      if (sgi < 0) {
        out[i] = 0;
        continue;
      }
      const int64_t lo = idx->seg_off[sgi], len = idx->seg_off[sgi + 1] - lo;
      if (bits_ok && qs[i] <= qe[i]) {
        const int64_t ub = rank_start_gt(idx, sgi, lo, len, qe[i]);
        const int64_t lb = rank_ends_ge(idx, sgi, lo, len, qs[i]);
        out[i] = ub - lb;
      } else {
        // exact level-run count: stabbing probes (qs > qe) or inverted
        // build intervals (end < start), where the BITS subset argument
        // fails — the per-level contiguous-run identity holds for every
        // query and row shape (see the Index level comment)
        (void)lo;
        (void)len;
        const int64_t d0 = idx->lvl_dir[sgi], d1 = idx->lvl_dir[sgi + 1];
        int64_t c = 0;
        for (int64_t d = d0; d + 1 < d1; ++d) {
          const int64_t llo = idx->lvl_bounds[d];
          const int64_t llen = idx->lvl_bounds[d + 1] - llo;
          const int64_t ub = hint_ub32(
              idx->lvl_starts.data() + llo, llen,
              idx->lvl_hints.data() + idx->hint_s_off[d], idx->hint_s_nb[d],
              idx->hint_s_base[d], idx->hint_s_g[d], qe[i]);
          const int64_t lb = hint_lb32(
              idx->lvl_ends.data() + llo, llen,
              idx->lvl_hints.data() + idx->hint_e_off[d], idx->hint_e_nb[d],
              idx->hint_e_base[d], idx->hint_e_g[d], qs[i]);
          if (ub > lb) c += ub - lb;
        }
        out[i] = c;
      }
    }
  });
}

// Parallel exact pair emission at caller-provided offsets: probe row i's
// matches land at out[offs[i] .. offs[i+1]), probe-major, (level, start)-
// ascending — deterministic, level-minor like the device emit kernels
// (intra-probe order is not a contract; parity suites sort before
// comparing, as the reference's tests do).  The offsets come from an
// exclusive scan of si_count's results.  Each (segment, level) run is
// contiguous, so emission is two binary searches plus one memcpy per
// occupied level — it writes exactly the matches, where the previous
// cummax-window scan walked ~20x more candidates on long-tailed tracks.
// Returns the number of pairs written (== offs[m]; the caller asserts).
int64_t si_emit_at(void* h, const int32_t* qk, const int32_t* qs,
                   const int32_t* qe, int64_t m, const int64_t* offs,
                   int32_t* out_b, int32_t* out_p) {
  const auto* idx = static_cast<const Index*>(h);
  return emit_walk(
      idx, qk, qs, qe, m, offs, 4096,
      [&](int64_t, int64_t w, const int32_t* rows, int64_t run) {
        std::memcpy(out_b + w, rows, size_t(run) * sizeof(int32_t));
      },
      [&](int64_t i, int64_t w0, int64_t w) {
        std::fill(out_p + w0, out_p + w, int32_t(i));
      });
}

// Fused emission + output gather: materializes the join's OUTPUT COLUMNS
// directly from the level runs, never writing the (build_row, probe_row)
// index pair arrays at all (the reference emits index vectors and then
// take-gathers per column, interval_join.rs:1593-1632; the pair path
// here did the same).  Per match: build columns gather through the
// level-view position map (cache-resident for typical build sides);
// probe columns broadcast-fill the row's value across its whole run.
// Skipping the pair indices removes ~16 bytes/match of intermediate
// write+read traffic plus the per-column index reads of the take —
// the output writes (the unavoidable ~48 B/row of a 6-column SELECT *)
// become the only large stream.  Column widths are 4 or 8 bytes
// (int32/float32/int64/float64/dictionary codes); the caller routes
// anything else through the pair path.
int64_t si_emit_gather(void* h, const int32_t* qk, const int32_t* qs,
                       const int32_t* qe, int64_t m, const int64_t* offs,
                       int64_t nb_cols, void* const* b_srcs,
                       const int32_t* b_widths, void* const* b_outs,
                       int64_t nq_cols, void* const* q_srcs,
                       const int32_t* q_widths, void* const* q_outs) {
  const auto* idx = static_cast<const Index*>(h);
  return emit_walk(
      idx, qk, qs, qe, m, offs, 2048,
      [&](int64_t, int64_t w, const int32_t* rows, int64_t run) {
        for (int64_t c = 0; c < nb_cols; ++c) {
          if (b_widths[c] == 4) {
            const int32_t* src = static_cast<const int32_t*>(b_srcs[c]);
            int32_t* out = static_cast<int32_t*>(b_outs[c]) + w;
            for (int64_t r = 0; r < run; ++r) out[r] = src[rows[r]];
          } else {
            const int64_t* src = static_cast<const int64_t*>(b_srcs[c]);
            int64_t* out = static_cast<int64_t*>(b_outs[c]) + w;
            for (int64_t r = 0; r < run; ++r) out[r] = src[rows[r]];
          }
        }
      },
      [&](int64_t i, int64_t w0, int64_t w) {
        // probe columns: one value broadcast across the query's span
        for (int64_t c = 0; c < nq_cols; ++c) {
          if (q_widths[c] == 4) {
            const int32_t v = static_cast<const int32_t*>(q_srcs[c])[i];
            int32_t* out = static_cast<int32_t*>(q_outs[c]);
            std::fill(out + w0, out + w, v);
          } else {
            const int64_t v = static_cast<const int64_t*>(q_srcs[c])[i];
            int64_t* out = static_cast<int64_t*>(q_outs[c]);
            std::fill(out + w0, out + w, v);
          }
        }
      });
}

// Two-mode pair emission kept for API stability: if out_b == nullptr,
// only count (returns total); otherwise fill up to cap pairs
// (build_row, probe_row), probe-major.  New callers should use
// si_count + si_emit_at (parallel).
int64_t si_pairs(void* h, const int32_t* qk, const int32_t* qs,
                 const int32_t* qe, int64_t m, int32_t* out_b,
                 int32_t* out_p, int64_t cap) {
  const auto* idx = static_cast<const Index*>(h);
  int64_t written = 0;
  int64_t last = -1;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t sgi = find_seg(idx, qk[i], &last);
    if (sgi < 0) continue;
    const int64_t d0 = idx->lvl_dir[sgi], d1 = idx->lvl_dir[sgi + 1];
    for (int64_t d = d0; d + 1 < d1; ++d) {
      const int64_t llo = idx->lvl_bounds[d];
      const int64_t llen = idx->lvl_bounds[d + 1] - llo;
      const int64_t ub = hint_ub32(
          idx->lvl_starts.data() + llo, llen,
          idx->lvl_hints.data() + idx->hint_s_off[d], idx->hint_s_nb[d],
          idx->hint_s_base[d], idx->hint_s_g[d], qe[i]);
      const int64_t lb = hint_lb32(
          idx->lvl_ends.data() + llo, llen,
          idx->lvl_hints.data() + idx->hint_e_off[d], idx->hint_e_nb[d],
          idx->hint_e_base[d], idx->hint_e_g[d], qs[i]);
      const int64_t run = ub - lb;
      if (run <= 0) continue;
      if (out_b != nullptr) {
        if (written + run > cap) return -1;  // caller must grow and retry
        std::memcpy(out_b + written, idx->lvl_pos.data() + llo + lb,
                    size_t(run) * sizeof(int32_t));
        std::fill(out_p + written, out_p + written + run, int32_t(i));
      }
      written += run;
    }
  }
  return written;
}

// Nearest: first overlap else min-distance (ties upstream); -1 if no
// same-key interval exists.  Parallel over probe chunks.
void si_nearest(void* h, const int32_t* qk, const int32_t* qs,
                const int32_t* qe, int64_t m, int64_t* out) {
  const auto* idx = static_cast<const Index*>(h);
  parallel_chunks(m, 8192, [&](int64_t i0, int64_t i1) {
    int64_t last = -1;
    for (int64_t i = i0; i < i1; ++i) {
      out[i] = -1;
      const int64_t sgi = find_seg(idx, qk[i], &last);
      if (sgi < 0) continue;
      const int64_t lo = idx->seg_off[sgi], len = idx->seg_off[sgi + 1] - lo;
      // overlap scan over the candidate window
      const int64_t ub = lo + rank_start_gt(idx, sgi, lo, len, qe[i]);
      const int64_t wlo = lo + rank_cummax_ge(idx, sgi, lo, len, qs[i]);
      int64_t found = -1;
      for (int64_t j = wlo; j < ub; ++j) {
        if (idx->ends[j] >= qs[i]) {
          found = idx->pos[j];
          break;
        }
      }
      if (found >= 0) {
        out[i] = found;
        continue;
      }
      // nearest: best upstream (max end < qs, via the per-segment
      // end-sorted array — O(log n)) vs best downstream
      int64_t best_d = INT64_MAX;
      int64_t best = -1;
      const int64_t e_lb = rank_ends_ge(idx, sgi, lo, len, qs[i]);
      if (e_lb > 0) {
        best_d = int64_t(qs[i]) - idx->ends_sorted[lo + e_lb - 1];
        best = idx->end_pos[lo + e_lb - 1];
      }
      if (ub < lo + len) {
        const int64_t d = int64_t(idx->starts[ub]) - qe[i];
        if (d < best_d) {
          best_d = d;
          best = idx->pos[ub];
        }
      }
      out[i] = best;
    }
  });
}

// k closest build rows per probe (overlaps first at distance 0, then by
// genomic distance, ties upstream-first): the host half of the closest-k
// verb (ops/genomic.py closest_k contract; distances are contractual,
// overlap-tie row subsets are deterministic but not).  Requires clean
// inputs (qs <= qe, no inverted builds) — the Python caller routes
// degenerate/inverted data to the exact scan.  Per probe the three
// candidate rings partition the segment exactly:
//   overlap     start <= qe && end >= qs      distance 0
//   upstream    end < qs                      distance qs - end
//   downstream  start > qe                    distance start - qe
// and each ring enumerates in ascending distance (overlaps trivially;
// upstream walking the per-segment end-sorted array backward; downstream
// walking the start-sorted array forward), so a 3-pointer merge yields
// the exact top-k distance multiset in O(log n + k + window).
// out_rows int32[m*k] / out_d int64[m*k], -1 padded.  Parallel.
void si_closest_k(void* h, const int32_t* qk, const int32_t* qs,
                  const int32_t* qe, int64_t m, int64_t k,
                  int32_t* out_rows, int64_t* out_d) {
  const auto* idx = static_cast<const Index*>(h);
  constexpr int64_t INF = INT64_MAX;
  parallel_chunks(m, 4096, [&](int64_t i0, int64_t i1) {
    int64_t last = -1;
    for (int64_t i = i0; i < i1; ++i) {
      int32_t* rowo = out_rows + i * k;
      int64_t* disto = out_d + i * k;
      for (int64_t j = 0; j < k; ++j) {
        rowo[j] = -1;
        disto[j] = -1;
      }
      const int64_t sgi = find_seg(idx, qk[i], &last);
      if (sgi < 0) continue;
      const int64_t lo = idx->seg_off[sgi], len = idx->seg_off[sgi + 1] - lo;
      const int32_t qsi = qs[i], qei = qe[i];
      const int64_t ub = lo + rank_start_gt(idx, sgi, lo, len, qei);
      const int64_t wlo = lo + rank_cummax_ge(idx, sgi, lo, len, qsi);
      int64_t slot = 0;
      // overlap ring: distance-0 candidates in (key,start) order
      for (int64_t j = wlo; j < ub && slot < k; ++j) {
        if (idx->ends[j] >= qsi) {
          rowo[slot] = idx->pos[j];
          disto[slot] = 0;
          ++slot;
        }
      }
      if (slot >= k) continue;
      // upstream (backward from the last end < qs) / downstream (forward
      // from the first start > qe) merge, ties upstream-first
      int64_t ui = lo + rank_ends_ge(idx, sgi, lo, len, qsi) - 1;
      int64_t di = ub;
      const int64_t hi = lo + len;
      while (slot < k) {
        const int64_t du =
            ui >= lo ? int64_t(qsi) - idx->ends_sorted[ui] : INF;
        const int64_t dd = di < hi ? int64_t(idx->starts[di]) - qei : INF;
        if (du == INF && dd == INF) break;
        if (du <= dd) {
          rowo[slot] = idx->end_pos[ui];
          disto[slot] = du;
          --ui;
        } else {
          rowo[slot] = idx->pos[di];
          disto[slot] = dd;
          ++di;
        }
        ++slot;
      }
    }
  });
}

// Coverage: (count, sum(min(end,qe) - max(start,qs))) per query —
// superintervals coverage semantics.  Parallel over probe chunks.
//
// Fast path: the sum decomposes into rank windows over the two sorted
// views, so each probe costs four binary searches + two prefix-sum
// lookups instead of a candidate scan (the same 4-rank decomposition the
// device merge backend uses).  Over overlapping build rows
// (si <= qe AND ei >= qs, valid only for non-inverted builds and
// qs <= qe):
//   sum max(si,qs) = sum{si in [qs,qe]} si + qs * (C - #{si in [qs,qe]})
//     (si >= qs implies ei >= si >= qs, so those rows all overlap)
//   sum min(ei,qe) = sum{ei in [qs,qe]} ei + qe * (C - #{ei in [qs,qe]})
//     (ei <= qe implies si <= ei <= qe)
//   C = #{si <= qe} - #{ei < qs}  (the BITS count)
// Degenerate probes (qs > qe) and inverted-build indexes take the exact
// candidate scan — the same routing contract as every count entry point.
void si_coverage(void* h, const int32_t* qk, const int32_t* qs,
                 const int32_t* qe, int64_t m, int64_t* out_count,
                 int64_t* out_bases) {
  const auto* idx = static_cast<const Index*>(h);
  const bool ranks_ok = !idx->has_inverted;
  if (ranks_ok) {
    std::call_once(idx->pfx_once, [&] {
      idx->pfx_start.resize(size_t(idx->n) + 1);
      idx->pfx_end.resize(size_t(idx->n) + 1);
      idx->pfx_start[0] = idx->pfx_end[0] = 0;
      for (int64_t i = 0; i < idx->n; ++i) {
        idx->pfx_start[i + 1] = idx->pfx_start[i] + idx->starts[i];
        idx->pfx_end[i + 1] = idx->pfx_end[i] + idx->ends_sorted[i];
      }
    });
  }
  const int64_t* ps = ranks_ok ? idx->pfx_start.data() : nullptr;
  const int64_t* pe = ranks_ok ? idx->pfx_end.data() : nullptr;
  parallel_chunks(m, 8192, [&](int64_t i0, int64_t i1) {
    int64_t last = -1;
    for (int64_t i = i0; i < i1; ++i) {
      out_count[i] = 0;
      out_bases[i] = 0;
      const int64_t sgi = find_seg(idx, qk[i], &last);
      if (sgi < 0) continue;
      const int64_t lo = idx->seg_off[sgi], len = idx->seg_off[sgi + 1] - lo;
      if (ranks_ok && qs[i] <= qe[i]) {
        const int64_t ub_s = rank_start_gt(idx, sgi, lo, len, qe[i]);
        const int64_t lb_e = rank_ends_ge(idx, sgi, lo, len, qs[i]);
        const int64_t c = ub_s - lb_e;
        if (c <= 0) continue;
        const int64_t lb_s = rank_start_ge(idx, sgi, lo, len, qs[i]);
        const int64_t ub_e = rank_ends_gt(idx, sgi, lo, len, qe[i]);
        const int64_t sum_s = ps[lo + ub_s] - ps[lo + lb_s];
        const int64_t sum_e = pe[lo + ub_e] - pe[lo + lb_e];
        out_count[i] = c;
        out_bases[i] = (sum_e + int64_t(qe[i]) * (c - (ub_e - lb_e))) -
                       (sum_s + int64_t(qs[i]) * (c - (ub_s - lb_s)));
        continue;
      }
      const int64_t ub = lo + rank_start_gt(idx, sgi, lo, len, qe[i]);
      const int64_t wlo = lo + rank_cummax_ge(idx, sgi, lo, len, qs[i]);
      int64_t c = 0, bases = 0;
      for (int64_t j = wlo; j < ub; ++j) {
        if (idx->ends[j] >= qs[i]) {
          ++c;
          bases += std::min(int64_t(idx->ends[j]), int64_t(qe[i])) -
                   std::max(int64_t(idx->starts[j]), int64_t(qs[i]));
        }
      }
      out_count[i] = c;
      out_bases[i] = bases;
    }
  });
}

// Expand contiguous index runs into build rows: for each run i,
// out[j..j+cnt[i]) = pos[g0[i] .. g0[i]+cnt[i]) — the host half of the
// device join's run-compacted emission (ops/interval_join.py ships
// (run start, length) pairs over the device link and expands here).
// Parallel two-pass: per-chunk run totals, then chunk-local memcpy loops.
void si_expand_runs(const int32_t* g0, const int32_t* cnt, int64_t nruns,
                    const int32_t* pos, int32_t* out) {
  const int nt = num_threads(nruns, 4096);
  if (nt <= 1 || nruns < 4096) {
    int64_t j = 0;
    for (int64_t i = 0; i < nruns; ++i) {
      std::memcpy(out + j, pos + g0[i], size_t(cnt[i]) * sizeof(int32_t));
      j += cnt[i];
    }
    return;
  }
  const int64_t per = (nruns + nt - 1) / nt;
  std::vector<int64_t> base(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per, hi = std::min(nruns, lo + per);
    int64_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += cnt[i];
    base[t + 1] = base[t] + s;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per, hi = std::min(nruns, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=, &base] {
      int64_t j = base[t];
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(out + j, pos + g0[i], size_t(cnt[i]) * sizeof(int32_t));
        j += cnt[i];
      }
    });
  }
  for (auto& th : ts) th.join();
}

// RLE-expand per-probe match counts into probe row ids (probe-major
// pair order): out[j] = i repeated counts[i] times.  Parallel two-pass.
void si_repeat_counts(const int32_t* counts, int64_t m, int32_t* out) {
  const int nt = num_threads(m, 16384);
  if (nt <= 1 || m < 16384) {
    int64_t j = 0;
    for (int64_t i = 0; i < m; ++i) {
      const int64_t c = counts[i];
      for (int64_t r = 0; r < c; ++r) out[j + r] = int32_t(i);
      j += c;
    }
    return;
  }
  const int64_t per = (m + nt - 1) / nt;
  std::vector<int64_t> base(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per, hi = std::min(m, lo + per);
    int64_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += counts[i];
    base[t + 1] = base[t] + s;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per, hi = std::min(m, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=, &base] {
      int64_t j = base[t];
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t c = counts[i];
        for (int64_t r = 0; r < c; ++r) out[j + r] = int32_t(i);
        j += c;
      }
    });
  }
  for (auto& th : ts) th.join();
}

// Fused gather for fixed-width columns: out[j] = src[rows[j]] — the take
// half of the emit path for numeric columns, parallel over output chunks.
// Output writes are sequential, so non-temporal (streaming) stores skip
// the read-for-ownership traffic — measured 1.5x on this host (the
// source table fits in cache; the output is the whole memory traffic).
void si_gather32(const int32_t* src, const int32_t* rows, int64_t n,
                 int32_t* out) {
  parallel_chunks(n, 1 << 20, [&](int64_t lo, int64_t hi) {
    int64_t j = lo;
#if defined(__AVX512F__)
    while (j < hi && (reinterpret_cast<uintptr_t>(out + j) & 63)) {
      out[j] = src[rows[j]];
      ++j;
    }
    for (; j + 16 <= hi; j += 16) {
      __m512i idx = _mm512_loadu_si512(rows + j);
      __m512i v = _mm512_i32gather_epi32(idx, src, 4);
      _mm512_stream_si512(reinterpret_cast<__m512i*>(out + j), v);
    }
#endif
    for (; j < hi; ++j) out[j] = src[rows[j]];
#if defined(__AVX512F__)
    _mm_sfence();
#endif
  });
}

void si_gather64(const int64_t* src, const int32_t* rows, int64_t n,
                 int64_t* out) {
  parallel_chunks(n, 1 << 20, [&](int64_t lo, int64_t hi) {
    int64_t j = lo;
#if defined(__AVX512F__)
    while (j < hi && (reinterpret_cast<uintptr_t>(out + j) & 63)) {
      out[j] = src[rows[j]];
      ++j;
    }
    for (; j + 8 <= hi; j += 8) {
      __m256i idx = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(rows + j));
      __m512i v = _mm512_i32gather_epi64(idx, src, 8);
      _mm512_stream_si512(reinterpret_cast<__m512i*>(out + j), v);
    }
#endif
    for (; j < hi; ++j) out[j] = src[rows[j]];
#if defined(__AVX512F__)
    _mm_sfence();
#endif
  });
}

// String-column gather, offsets pass: out_off[j] = exclusive scan of the
// gathered row lengths (Arrow string offsets for the output).  Parallel
// two-pass (per-chunk length sums, then chunk-local scans).  Returns the
// total byte count, or -1 if it would overflow int32 offsets (the caller
// falls back to arrow take / large_string).
int64_t si_take_str_offsets(const int32_t* offsets, const int32_t* rows,
                            int64_t n, int32_t* out_off) {
  const int nt = num_threads(n, 1 << 18);
  const int64_t per = (n + nt - 1) / nt;
  std::vector<int64_t> base(nt + 1, 0);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=, &base] {
      int64_t s = 0;
      for (int64_t j = lo; j < hi; ++j)
        s += offsets[rows[j] + 1] - offsets[rows[j]];
      base[t + 1] = s;
    });
  }
  for (auto& th : ts) th.join();
  ts.clear();
  for (int t = 0; t < nt; ++t) base[t + 1] += base[t];
  if (base[nt] >= (int64_t(1) << 31)) return -1;
  out_off[0] = 0;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = int64_t(t) * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=, &base] {
      int32_t run = int32_t(base[t]);
      for (int64_t j = lo; j < hi; ++j) {
        run += offsets[rows[j] + 1] - offsets[rows[j]];
        out_off[j + 1] = run;
      }
    });
  }
  for (auto& th : ts) th.join();
  return base[nt];
}

// String-column gather, fill pass: caller has already computed the output
// offsets (si_take_str_offsets); this copies the bytes, parallel over
// output rows.  offsets/out_offsets are Arrow string-array offsets
// (int32, length n+1).  Rows of <= 16 bytes (virtually all genomic
// identifiers) copy as two unconditional 8-byte stores — a per-row
// memcpy call mispredicts its size branch every row; the overrun is
// bounded by the caller's 16-byte output slack (data_len guards source
// over-reads, and each thread's LAST row copies exactly so the overrun
// never crosses into another thread's already-written region).
void si_take_str_fill(const int32_t* offsets, const char* data,
                      int64_t data_len, const int32_t* rows, int64_t n,
                      const int32_t* out_offsets, char* out_data) {
  parallel_chunks(n, 1 << 19, [&](int64_t lo, int64_t hi) {
    // overruns must stay inside this thread's output region (sequential
    // writes overwrite them with the right bytes); the global last chunk
    // may additionally spill into the caller's 16-byte slack
    const int64_t limit =
        int64_t(out_offsets[hi]) + (hi == n ? 16 : 0);
    for (int64_t j = lo; j < hi; ++j) {
      const int32_t r = rows[j];
      const int32_t b = offsets[r];
      const int32_t len = offsets[r + 1] - b;
      char* dst = out_data + out_offsets[j];
      if (len <= 16 && int64_t(b) + 16 <= data_len &&
          int64_t(out_offsets[j]) + 16 <= limit) {
        std::memcpy(dst, data + b, 8);
        std::memcpy(dst + 8, data + b + 8, 8);
      } else {
        std::memcpy(dst, data + b, size_t(len));
      }
    }
  });
}

// Parallel stable argsort of an int64 key array (the host half of the
// engine's composite-key lexsorts: Python packs (key, coord) into one
// int64 composite — ordering-preserving by construction — and this
// returns the stable order).  LSD radix, 4 x 16-bit digit passes over
// (biased key, index) pairs; each pass histograms per thread, exclusive-
// scans globally, then scatters per thread at precomputed offsets —
// stable and fully parallel.  Digit passes where every key shares one
// bucket are skipped (common for the high bits of small key spaces).
// NumPy's lexsort measured ~200 ms for 1M 3-key rows; this runs ~10x.
void si_argsort64(const int64_t* v, int64_t n, int32_t* out_order) {
  if (n <= 0) return;
  struct KV {
    uint64_t key;
    int32_t idx;
  };
  std::vector<KV> a(n), b(n);
  constexpr uint64_t BIAS = uint64_t(1) << 63;  // order-preserving for int64
  parallel_chunks(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      a[i].key = uint64_t(v[i]) + BIAS;
      a[i].idx = int32_t(i);
    }
  });
  const int nt = num_threads(n, 1 << 16);
  const int64_t per = (n + nt - 1) / nt;
  std::vector<std::vector<int64_t>> hist(nt);
  KV* src = a.data();
  KV* dst = b.data();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 16;
    // per-thread histograms
    {
      std::vector<std::thread> ts;
      for (int t = 0; t < nt; ++t) {
        const int64_t lo = int64_t(t) * per, hi = std::min(n, lo + per);
        if (lo >= hi) {
          hist[t].assign(65536, 0);
          continue;
        }
        ts.emplace_back([=, &hist] {
          auto& h = hist[t];
          h.assign(65536, 0);
          for (int64_t i = lo; i < hi; ++i)
            ++h[(src[i].key >> shift) & 0xFFFF];
        });
      }
      for (auto& th : ts) th.join();
    }
    // global exclusive scan in (digit, thread) order; skip single-bucket
    // passes (every element keeps its position)
    int nonzero = 0;
    int64_t run = 0;
    for (int d = 0; d < 65536 && nonzero < 2; ++d) {
      int64_t s = 0;
      for (int t = 0; t < nt; ++t) s += hist[t][d];
      if (s) ++nonzero;
    }
    if (nonzero < 2) continue;
    for (int d = 0; d < 65536; ++d) {
      for (int t = 0; t < nt; ++t) {
        const int64_t c = hist[t][d];
        hist[t][d] = run;
        run += c;
      }
    }
    // parallel stable scatter at the precomputed offsets
    {
      std::vector<std::thread> ts;
      for (int t = 0; t < nt; ++t) {
        const int64_t lo = int64_t(t) * per, hi = std::min(n, lo + per);
        if (lo >= hi) break;
        ts.emplace_back([=, &hist] {
          auto& h = hist[t];
          for (int64_t i = lo; i < hi; ++i)
            dst[h[(src[i].key >> shift) & 0xFFFF]++] = src[i];
        });
      }
      for (auto& th : ts) th.join();
    }
    std::swap(src, dst);
  }
  parallel_chunks(n, 1 << 16, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out_order[i] = src[i].idx;
  });
}

// Threaded binary searches over a sorted int64 array (the engine's
// composite searchsorted): side 0 = left (first >= q), 1 = right
// (first > q).  NumPy's searchsorted is single-threaded (~190 ms for
// 500k queries x 1M keys); this splits queries across cores.
void si_searchsorted64(const int64_t* sorted, int64_t n, const int64_t* q,
                       int64_t m, int32_t side, int64_t* out) {
  // Query-heavy calls (the composite-key searches behind the genomic
  // verbs) amortize a bucket-hint grid over the sorted array: hint[b] =
  // lower_bound(v, base + (b << g)), built in one O(n + buckets) sweep,
  // turns each search into a hint load + short gallop instead of ~17
  // cache-missing bisection steps (measured 56 -> ~10 ms for 1M searches
  // over 125k merged runs).  Small query counts keep plain bisection.
  // grid only when the O(n) build sweep amortizes over the queries: a
  // small probe batch against a huge sorted array (hash-join lookups)
  // keeps the plain threaded bisections
  if (m >= 4096 && n >= 2 && n <= 32 * m && n <= INT32_MAX &&
      sorted[n - 1] > sorted[0]) {
    const int64_t base = sorted[0];
    const uint64_t span = uint64_t(sorted[n - 1] - base);
    int32_t g = 0;
    while ((span >> g) > uint64_t(2 * n)) ++g;
    const int64_t nb = int64_t(span >> g) + 1;
    std::vector<int32_t> hints(size_t(nb), 0);
    {
      int64_t i = 0;
      for (int64_t b = 0; b < nb; ++b) {
        const int64_t thresh = base + (int64_t(b) << g);
        while (i < n && sorted[i] < thresh) ++i;
        hints[b] = int32_t(std::min<int64_t>(i, INT32_MAX));
      }
    }
    parallel_chunks(m, 16384, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t x = q[i];
        if (x < base) {
          out[i] = 0;  // base == sorted[0], so x precedes everything
          continue;
        }
        int64_t b = int64_t(uint64_t(x - base) >> g);
        if (b >= nb) b = nb - 1;
        int64_t j = hints[b];
        int64_t step = 1;
        if (side == 0) {
          while (j + step <= n && sorted[j + step - 1] < x) {
            j += step;
            step <<= 1;
          }
          const int64_t wh = std::min(j + step - 1, n);
          out[i] = j + (std::lower_bound(sorted + j, sorted + wh, x) -
                        (sorted + j));
        } else {
          while (j + step <= n && sorted[j + step - 1] <= x) {
            j += step;
            step <<= 1;
          }
          const int64_t wh = std::min(j + step - 1, n);
          out[i] = j + (std::upper_bound(sorted + j, sorted + wh, x) -
                        (sorted + j));
        }
      }
    });
    return;
  }
  parallel_chunks(m, 16384, [&](int64_t lo, int64_t hi) {
    if (side == 0) {
      for (int64_t i = lo; i < hi; ++i)
        out[i] = std::lower_bound(sorted, sorted + n, q[i]) - sorted;
    } else {
      for (int64_t i = lo; i < hi; ++i)
        out[i] = std::upper_bound(sorted, sorted + n, q[i]) - sorted;
    }
  });
}

// bedtools-subtract gap kernel: per a-row, the sub-ranges not covered by
// the merged subtrahend runs.  Runs are disjoint and (key,start)-sorted;
// comp_ms/comp_me pack (key << 32) | (coord + 2^31) so one sorted int64
// array serves both the window lower bound (first run with end >= a.start
// on the key) and the in-window test (run.start <= a.end on the key) —
// the same composites ops/genomic.merged_subtrahend memoizes per table
// pair.  Two passes over caller-scanned offsets, like si_count/si_emit_at:
// pass 1 records each row's window start and gap count, pass 2 writes
// (key, gap_start, gap_end) triples a-row-major with gaps ascending —
// bit-identical values AND order vs the NumPy pair-expansion path it
// replaces (ops/genomic.py subtract_intervals), which pays a total-pairs
// expansion + concatenate + composite argsort this kernel never builds.
void si_subtract_count(const int64_t* comp_ms, const int64_t* comp_me,
                       const int32_t* run_s, const int32_t* run_e,
                       int64_t nruns, const int32_t* ak, const int32_t* as_,
                       const int32_t* ae, int64_t m, int32_t* lo_out,
                       int64_t* cnt_out) {
  constexpr int64_t B = int64_t(1) << 31;
  const HintGrid64 hg = build_grid64(comp_me, nruns, m);
  parallel_chunks(m, 8192, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t key = int64_t(ak[i]) << 32;
      const int64_t qlo = key | (int64_t(as_[i]) + B);
      const int64_t qhi = key | (int64_t(ae[i]) + B);
      int64_t j = grid_lb64(hg, comp_me, nruns, qlo);
      lo_out[i] = int32_t(j);
      const int64_t j0 = j;
      int64_t cnt = 0;
      int64_t prev_end = int64_t(as_[i]) - 1;
      for (; j < nruns && comp_ms[j] <= qhi; ++j) {
        cnt += (int64_t(run_s[j]) - 1 >= prev_end + 1);
        prev_end = run_e[j];
      }
      const int64_t ts = (j > j0) ? int64_t(run_e[j - 1]) + 1
                                  : int64_t(as_[i]);
      cnt += (ts <= int64_t(ae[i]));
      cnt_out[i] = cnt;
    }
  });
}

void si_subtract_emit(const int64_t* comp_ms, const int32_t* run_s,
                      const int32_t* run_e, int64_t nruns, const int32_t* ak,
                      const int32_t* as_, const int32_t* ae, int64_t m,
                      const int32_t* lo_arr, const int64_t* offs,
                      int32_t* out_k, int32_t* out_s, int32_t* out_e) {
  constexpr int64_t B = int64_t(1) << 31;
  parallel_chunks(m, 8192, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t qhi =
          (int64_t(ak[i]) << 32) | (int64_t(ae[i]) + B);
      int64_t j = lo_arr[i];
      const int64_t j0 = j;
      int64_t o = offs[i];
      int64_t prev_end = int64_t(as_[i]) - 1;
      for (; j < nruns && comp_ms[j] <= qhi; ++j) {
        const int64_t gs = prev_end + 1;
        const int64_t ge = int64_t(run_s[j]) - 1;
        if (ge >= gs) {
          out_k[o] = ak[i];
          out_s[o] = int32_t(gs);
          out_e[o] = int32_t(ge);
          ++o;
        }
        prev_end = run_e[j];
      }
      const int64_t ts = (j > j0) ? int64_t(run_e[j - 1]) + 1
                                  : int64_t(as_[i]);
      if (ts <= int64_t(ae[i])) {
        out_k[o] = ak[i];
        out_s[o] = int32_t(ts);
        out_e[o] = ae[i];
        ++o;
      }
    }
  });
}

// Layout variant actually built into an index handle: 1 = Eytzinger
// (the default), 0 = segment-local binary search (the
// SEQUILA_NATIVE_LAYOUT=segment opt-out at si_build time).  Lets tests
// assert the variant engaged.
int64_t si_layout(void* h) {
  return static_cast<const Index*>(h)->eytz ? 1 : 0;
}

int64_t si_version() { return 8; }

}  // extern "C"
