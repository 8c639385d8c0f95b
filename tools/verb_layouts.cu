// The pair layout of the genomic verbs' ranks, kept beside the package's
// plane-major un-permute for tools/verb_layouts.py: the ranks as int32
// pairs, pe[j] = (ub_s, ub_e) of the (key, end) view's slot j and ps[j] =
// (lb_e, lb_s) of the (key, start) view's, gathered one 8-byte pair a view
// and probe row.  Each pair array (8 n bytes, 61.5 MB at the genome shape)
// outgrows the H100's 50 MB L2, where a plane (4 n bytes) fits.
#include "../sequila_tpu_torch/csrc/merge_rank.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
unpermute_pairs_kernel(const int2* __restrict__ pe, const int2* __restrict__ ps,
                       const int32_t* __restrict__ inv_e, const int32_t* __restrict__ inv_s,
                       int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int2 e = __ldg(pe + __ldcs(inv_e + i));
  const int2 s = __ldg(ps + __ldcs(inv_s + i));
  __stcs(out + i, e.x);
  __stcs(out + n + i, s.x);
  __stcs(out + 2 * n + i, e.y);
  __stcs(out + 3 * n + i, s.y);
}

}  // namespace

// pe, ps: n int32 pairs each; inv_e, inv_s: n int32 view slots; out: 4 n int32.
extern "C" int vl_unpermute_pairs(const void* pe, const void* ps, const void* inv_e,
                                  const void* inv_s, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  unpermute_pairs_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(pe), static_cast<const int2*>(ps),
      static_cast<const int32_t*>(inv_e), static_cast<const int32_t*>(inv_s),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
