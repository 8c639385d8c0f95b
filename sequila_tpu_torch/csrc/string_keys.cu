// Hopper (sm_90a) kernels that code a string key column on the card: a
// fresh table's dictionary codes (models/table.py::Table.dict_codes on a
// card, ops/cuda/string_keys.py::code_strings).
//
// They replace no TPU kernel: the JAX package codes a key column on the
// host (Arrow's dictionary_encode, sequila_tpu/models/table.py::dict_codes),
// and so did the port, until that encoder took about 207 of a fresh genome
// count's 326 ms on the host while the card waited.  Here the column's own
// Arrow buffers (the offsets, int32 or int64, and the UTF-8 bytes) are
// uploaded as they are; these kernels key and check its rows; one device
// sort of the keys groups them; the host sorts only the groups' strings.
//
// string_keys_kernel: row i's 64-bit key, its length plus
//   sum_j (byte_j + 1) * M^(j + 1) mod 2^64 over its bytes (M odd), the
//   arithmetic of ops/cuda/string_keys.py::string_keys_plain.  Equal
//   strings get equal keys; different strings may collide, which
//   verify_groups_kernel finds.  One thread a row; the rows of a warp read
//   neighbouring bytes, so each byte is read about once.  What bounds it:
//   the bytes, the offsets and bytes read and the 8-byte keys written (127
//   MB at the genome shape, 0.038 ms at 3.35 TB/s).
//
// verify_groups_kernel: every row against its group's representative row
//   (the group of the sorted keys it fell in), length and bytes, raising
//   one flag on any difference: a grouping is exact or the column goes to
//   the host encoder.  One thread a row; it reads each row's bytes and, for
//   the representative, bytes that the few groups share, from L2.  What
//   bounds it: the bytes, the offsets and the int32 groups it reads.
//
// Plain C interface for ctypes.  Each entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kMul = 0x9E3779B97F4A7C15ull;

template <typename Off>
__global__ void string_keys_kernel(const Off* __restrict__ off,
                                   const uint8_t* __restrict__ data, int64_t base,
                                   int64_t n, uint64_t* __restrict__ keys) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t lo = static_cast<int64_t>(off[i]) - base;
  const int64_t hi = static_cast<int64_t>(off[i + 1]) - base;
  uint64_t key = static_cast<uint64_t>(hi - lo);
  uint64_t pw = kMul;
  for (int64_t j = lo; j < hi; ++j) {
    key += (static_cast<uint64_t>(__ldg(data + j)) + 1) * pw;
    pw *= kMul;
  }
  keys[i] = key;
}

template <typename Off>
__global__ void verify_groups_kernel(const Off* __restrict__ off,
                                     const uint8_t* __restrict__ data, int64_t base,
                                     const int32_t* __restrict__ group,
                                     const int64_t* __restrict__ rep, int64_t n,
                                     int32_t* __restrict__ mismatch) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = rep[group[i]];
  if (r == i) return;
  const int64_t lo = static_cast<int64_t>(off[i]) - base;
  const int64_t len = static_cast<int64_t>(off[i + 1]) - base - lo;
  const int64_t lo_r = static_cast<int64_t>(off[r]) - base;
  bool same = static_cast<int64_t>(off[r + 1]) - base - lo_r == len;
  for (int64_t j = 0; same && j < len; ++j) {
    same = __ldg(data + lo + j) == __ldg(data + lo_r + j);
  }
  if (!same) *mismatch = 1;
}

int blocks_of(int64_t n, unsigned* blocks) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  if (b > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

}  // namespace

// off: n + 1 offsets of off_bytes (4 or 8) each, the first = base; data:
// the bytes from base on; keys: n uint64.
extern "C" int seq_string_keys(const void* off, int32_t off_bytes, const void* data,
                               int64_t base, int64_t n, void* keys, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = 0;
  if (const int err = blocks_of(n, &blocks)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* bytes = static_cast<const uint8_t*>(data);
  uint64_t* out = static_cast<uint64_t*>(keys);
  if (off_bytes == 4) {
    string_keys_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const int32_t*>(off), bytes,
                                                    base, n, out);
  } else if (off_bytes == 8) {
    string_keys_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const int64_t*>(off), bytes,
                                                    base, n, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// off, data, base: as seq_string_keys; group: n int32 group ids; rep: the
// representative row of each group (int64); mismatch: one int32, zeroed
// here on the stream before the launch, set to 1 on any difference.
extern "C" int seq_verify_groups(const void* off, int32_t off_bytes, const void* data,
                                 int64_t base, const void* group, const void* rep,
                                 int64_t n, void* mismatch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t zero = cudaMemsetAsync(mismatch, 0, sizeof(int32_t), st);
  if (zero != cudaSuccess) return static_cast<int>(zero);
  if (n <= 0) return 0;
  unsigned blocks = 0;
  if (const int err = blocks_of(n, &blocks)) return err;
  const uint8_t* bytes = static_cast<const uint8_t*>(data);
  const int32_t* g = static_cast<const int32_t*>(group);
  const int64_t* r = static_cast<const int64_t*>(rep);
  int32_t* flag = static_cast<int32_t*>(mismatch);
  if (off_bytes == 4) {
    verify_groups_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const int32_t*>(off), bytes,
                                                      base, g, r, n, flag);
  } else if (off_bytes == 8) {
    verify_groups_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const int64_t*>(off), bytes,
                                                      base, g, r, n, flag);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
