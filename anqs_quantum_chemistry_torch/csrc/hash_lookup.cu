// Bucket-hash membership lookup of packed determinant keys.
//
// Replaces the TPU kernel anqs_quantum_chemistry_tpu/ops/pallas_kernels.py
// hash_lookup / _hash_lookup_kernel (:32-97). For each query key (lo, hi)
// the three-round mix hash picks a bucket of the (nb, 128) float32 table
// that PauliEngine._hash_build writes; the bucket row holds 32 entries in
// four planar lane ranges -- [0, 32) key_lo, [32, 64) key_hi (the uint32
// bits of the key words), [64, 96) log|psi| (NEG = empty slot), [96, 128)
// phase. The output per query is (log|psi| of the first entry whose keys
// match and whose log|psi| is not NEG, or NEG; its phase, or 0; found).
// The plain version (ops/hash_lookup.py hash_lookup_plain) selects the
// same entry, so the two agree bit for bit: nothing here does arithmetic on
// a value, and keys are compared as integer bits (a key whose bits read as
// a float NaN still matches).
//
// Bound on the H100 (Li2O: N = 8192 rows x 3072 groups = 25.2M queries,
// nb = 1024 buckets = 512 KB): HBM traffic is the queries (4 B per key
// word; one word at W = 1, where q_hi is a null pointer read as 0) and the
// 9 bytes of output, 13 B a query at W = 1 = 0.33 GB, about 98 us at
// 3.35 TB/s; the table itself stays in L2 (50 MB). Reading each query's
// whole bucket row would move 512 B a query from L2 (12.9 GB), which would
// bind. The design cuts that to 128 B for a query whose key_lo appears
// nowhere in its bucket, the common case (the load factor is ~25% and most
// partners x ^ A_m are not in the sampled set):
//   - one warp takes 32 queries; lane i loads query i (coalesced), hashes
//     it in uint32, and in the end writes query i's result (coalesced);
//   - for each of the 32 queries in turn, lane e reads entry e's key_lo (one
//     128-byte row segment); only if some lane matches (a warp-uniform
//     __ballot_sync) does the warp read key_hi, the matching lanes their
//     log|psi|, and the first full match its phase, passed on with
//     __shfl_sync to the lane that owns the query.
// The grid is one wave: as many blocks as the card holds at once (resident
// blocks per SM, which the registers limit, times the SM count), each
// striding over the queries.
// Several loads in flight per warp (unrolling the walk over queries) and
// fusing the x ^ A_m query build into this kernel are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_build.py); called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENTRIES = 32;
constexpr int ROW = 4 * ENTRIES;
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// PauliEngine._mix2 in wrapping uint32 arithmetic.
__device__ __forceinline__ uint32_t mix2(uint32_t lo, uint32_t hi) {
  uint32_t acc = lo * 2654435761u;
  acc ^= acc >> 15;
  acc = (acc ^ hi) * 2654435761u;
  acc ^= acc >> 15;
  acc *= 2246822519u;
  acc ^= acc >> 13;
  return acc;
}

__global__ void __launch_bounds__(THREADS)
hash_lookup_kernel(const uint32_t* __restrict__ tab,  // (nb, 128) bits
                   uint32_t bucket_mask,               // nb - 1
                   const uint32_t* __restrict__ q_lo,  // (N,)
                   const uint32_t* __restrict__ q_hi,  // (N,) or null: 0
                   float* __restrict__ la_out,        // (N,)
                   float* __restrict__ ph_out,        // (N,)
                   bool* __restrict__ found_out,      // (N,)
                   long long n) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;

  for (long long base = warp * 32; base < n; base += n_warps * 32) {
    const long long q = base + lane;
    const bool live = q < n;
    const uint32_t lo = live ? q_lo[q] : 0u;
    const uint32_t hi = live && q_hi != nullptr ? q_hi[q] : 0u;
    const uint32_t bucket = mix2(lo, hi) & bucket_mask;
    float my_la = NEG, my_ph = 0.0f;
    bool my_found = false;

    const int count = static_cast<int>(n - base < 32 ? n - base : 32);
    for (int j = 0; j < count; ++j) {  // count and j are warp-uniform
      const uint32_t qlo = __shfl_sync(FULL, lo, j);
      const uint32_t qhi = __shfl_sync(FULL, hi, j);
      const uint32_t* row =
          tab + static_cast<size_t>(__shfl_sync(FULL, bucket, j)) * ROW;
      bool key = __ldg(row + lane) == qlo;
      if (__ballot_sync(FULL, key) == 0) continue;
      key = key && __ldg(row + ENTRIES + lane) == qhi;
      const float la =
          key ? __uint_as_float(__ldg(row + 2 * ENTRIES + lane)) : NEG;
      const unsigned hit = __ballot_sync(FULL, key && la > 0.5f * NEG);
      if (hit == 0) continue;
      const int src = __ffs(hit) - 1;
      const float ph =
          lane == src ? __uint_as_float(__ldg(row + 3 * ENTRIES + lane))
                      : 0.0f;
      const float la_src = __shfl_sync(FULL, la, src);
      const float ph_src = __shfl_sync(FULL, ph, src);
      if (lane == j) {
        my_la = la_src;
        my_ph = ph_src;
        my_found = true;
      }
    }
    if (live) {
      la_out[q] = my_la;
      ph_out[q] = my_ph;
      found_out[q] = my_found;
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// q_hi may be null (one-word keys: every high word is 0).
extern "C" int hash_lookup_launch(const void* tab, int n_buckets,
                                  const void* q_lo, const void* q_hi,
                                  void* la, void* ph, void* found,
                                  long long n, void* stream) {
  if (n <= 0 || n_buckets <= 0 || (n_buckets & (n_buckets - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hash_lookup_kernel, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long warps = (n + 31) / 32;
  const long long blocks_needed = (warps + THREADS / 32 - 1) / (THREADS / 32);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(
      blocks_needed < resident ? blocks_needed : resident);
  hash_lookup_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab),
      static_cast<uint32_t>(n_buckets - 1),
      static_cast<const uint32_t*>(q_lo), static_cast<const uint32_t*>(q_hi),
      static_cast<float*>(la), static_cast<float*>(ph),
      static_cast<bool*>(found), n);
  return static_cast<int>(cudaGetLastError());
}
