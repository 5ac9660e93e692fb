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
// What binds it on the H100 (Li2O: N = 8192 rows x 3072 groups = 25.2M
// queries, nb = 1024 buckets = 512 KB): the query and output stream, 4 B
// in per key word (one word at W = 1, where q_hi is a null pointer read as
// 0) and 9 B out, 13 B a query at W = 1 = 0.33 GB, about 98 us at 3.35
// TB/s. Nearly every query misses (Li2O step 0: 13136 hits of 25.2M), and
// the design decides a miss without reading the bucket row:
//
// - Tags. hash_tags_kernel writes one byte a slot, (nb, 32) bytes: the
//   top 8 bits of the slot key's mix hash (bits the bucket index does not
//   use up to nb = 2^24), mapped into 1..255, or 0 where the slot's
//   log|psi| is NEG (empty). A tag is a function of the key, so a tag that
//   differs from the query's proves a key that differs; correctness never
//   rests on the tag, a poor one only costs time. The table changes every
//   step, so the tags are built anew in every hash_lookup call (32 KB at
//   Li2O, a few microseconds).
// - One lane, one query. A thread holds QPT queries in flight (coalesced
//   loads, QPT * THREADS consecutive queries a block pass), hashes each,
//   and probes its bucket's 32 tags as two 16-B loads: a zero-byte test of
//   tag ^ query tag over the eight words says "no candidate" for about
//   1 - 8/255 of the misses at Li2O's load of 8 entries a bucket. Only
//   candidate slots, in ascending order, read the table from L2: key_lo,
//   key_hi and log|psi| of that slot, its phase on a full match, stopping
//   at the first. Queries and outputs use streaming (evict-first) loads
//   and stores, so they do not push the table and tags out of L2.
// - Tags in shared memory where they fit: up to TAG_SMEM_BYTES (64 KB,
//   nb <= 2048) each persistent block copies the whole tag array into
//   shared memory once (cp.async), which keeps three 512-thread blocks an
//   SM; above it the probes read the tags from global memory (nb * 32 B,
//   in L2 up to nb = 2^20). Both tiers run the same code; only where the
//   two 16-B probe loads come from differs.
// - The grid is one wave: as many blocks as the card holds at once, each
//   striding over the queries.
//
// What binds it, measured on the H100 (PERF.md, with the times of the
// designs timed against it): the stream. The same grid's loads and stores
// with no probe at all take about nine tenths of the kernel's time; the
// probe adds the rest, and reading the tags from L2 instead of shared
// memory (the tier above 64 KB) costs about 1.7x. A bank-conflict swizzle
// of the staged tags, a per-bucket
// flag that skips the second 16-B probe, 2 to 16 queries a thread, 256 to
// 1024 threads a block, 32-bit offsets, loading the next pass's queries
// ahead, and plain instead of streaming loads and stores were each tried
// and none was faster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_build.py); called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENTRIES = 32;
constexpr int ROW = 4 * ENTRIES;
constexpr int THREADS = 512;
constexpr int MIN_BLOCKS = 3;  // blocks an SM the register budget allows
constexpr int QPT = 8;         // queries a thread holds in flight
constexpr int TAG_SMEM_BYTES = 64 * 1024;
constexpr int TAG_THREADS = 256;
constexpr float NEG = -1e30f;

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

// A live slot's tag: the hash's top byte, 0 moved to 1 (0 marks empty).
__device__ __forceinline__ uint32_t tag_of(uint32_t h) {
  const uint32_t t = h >> 24;
  return t != 0u ? t : 1u;
}

// One byte a slot: tags[b * 32 + e] for entry e of bucket b.
__global__ void __launch_bounds__(TAG_THREADS)
hash_tags_kernel(const uint32_t* __restrict__ tab, uint8_t* __restrict__ tags,
                 long long n_slots) {
  for (long long i = static_cast<long long>(blockIdx.x) * TAG_THREADS +
                     threadIdx.x;
       i < n_slots; i += static_cast<long long>(gridDim.x) * TAG_THREADS) {
    const uint32_t* row = tab + (i >> 5) * ROW;
    const int e = static_cast<int>(i & 31);
    const float la = __uint_as_float(__ldg(row + 2 * ENTRIES + e));
    tags[i] = la > 0.5f * NEG
                  ? static_cast<uint8_t>(tag_of(
                        mix2(__ldg(row + e), __ldg(row + ENTRIES + e))))
                  : uint8_t{0};
  }
}

// Nonzero iff some byte of `word` equals the byte repeated in `rep`
// (the exact any-zero-byte test of word ^ rep).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t word, uint32_t rep) {
  const uint32_t x = word ^ rep;
  return (x - 0x01010101u) & ~x;
}

// Bit j of the result set iff byte j of `word` equals the byte of `rep`.
__device__ __forceinline__ uint32_t equal_bytes(uint32_t word, uint32_t rep) {
  const uint32_t eq = __vcmpeq4(word, rep) & 0x01010101u;
  return (eq * 0x01020408u) >> 24;
}

template <bool STAGED>
__device__ __forceinline__ uint4 load_tags(const uint4* p) {
  if constexpr (STAGED) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool STAGED, bool TWO_WORDS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
hash_lookup_kernel(const uint32_t* __restrict__ tab,  // (nb, 128) bits
                   const uint4* __restrict__ tags,    // (nb, 32) bytes
                   uint32_t bucket_mask,              // nb - 1
                   const uint32_t* __restrict__ q_lo,  // (N,)
                   const uint32_t* __restrict__ q_hi,  // (N,) if TWO_WORDS
                   float* __restrict__ la_out,         // (N,)
                   float* __restrict__ ph_out,         // (N,)
                   bool* __restrict__ found_out,       // (N,)
                   long long n) {
  extern __shared__ uint4 staged[];
  const uint4* tag_rows = tags;
  if constexpr (STAGED) {
    const int n_vec = static_cast<int>(bucket_mask + 1) * 2;
    for (int i = threadIdx.x; i < n_vec; i += THREADS) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(staged + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(tags + i)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    tag_rows = staged;
  }

  const long long stride = static_cast<long long>(gridDim.x) * THREADS * QPT;
  for (long long base =
           static_cast<long long>(blockIdx.x) * THREADS * QPT + threadIdx.x;
       base < n; base += stride) {
    uint32_t lo[QPT], hi[QPT];
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const long long q = base + k * THREADS;
      lo[k] = q < n ? __ldcs(q_lo + q) : 0u;
      hi[k] = TWO_WORDS && q < n ? __ldcs(q_hi + q) : 0u;
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const long long q = base + k * THREADS;
      if (q >= n) break;
      const uint32_t h = mix2(lo[k], hi[k]);
      const uint32_t bucket = h & bucket_mask;
      const uint32_t rep = tag_of(h) * 0x01010101u;
      const uint4 t0 = load_tags<STAGED>(tag_rows + 2 * bucket);
      const uint4 t1 = load_tags<STAGED>(tag_rows + 2 * bucket + 1);
      float la = NEG, ph = 0.0f;
      bool found = false;
      const uint32_t any =
          zero_bytes(t0.x, rep) | zero_bytes(t0.y, rep) |
          zero_bytes(t0.z, rep) | zero_bytes(t0.w, rep) |
          zero_bytes(t1.x, rep) | zero_bytes(t1.y, rep) |
          zero_bytes(t1.z, rep) | zero_bytes(t1.w, rep);
      if (any & 0x80808080u) {
        uint32_t cand = equal_bytes(t0.x, rep) |
                        equal_bytes(t0.y, rep) << 4 |
                        equal_bytes(t0.z, rep) << 8 |
                        equal_bytes(t0.w, rep) << 12 |
                        equal_bytes(t1.x, rep) << 16 |
                        equal_bytes(t1.y, rep) << 20 |
                        equal_bytes(t1.z, rep) << 24 |
                        equal_bytes(t1.w, rep) << 28;
        const uint32_t* row = tab + static_cast<size_t>(bucket) * ROW;
        while (cand != 0u) {
          const int e = __ffs(cand) - 1;
          cand &= cand - 1u;
          const uint32_t k_lo = __ldg(row + e);
          const uint32_t k_hi = __ldg(row + ENTRIES + e);
          const float la_e = __uint_as_float(__ldg(row + 2 * ENTRIES + e));
          if (k_lo == lo[k] && k_hi == hi[k] && la_e > 0.5f * NEG) {
            la = la_e;
            ph = __uint_as_float(__ldg(row + 3 * ENTRIES + e));
            found = true;
            break;
          }
        }
      }
      __stcs(la_out + q, la);
      __stcs(ph_out + q, ph);
      found_out[q] = found;
    }
  }
}

template <bool STAGED, bool TWO_WORDS>
int launch_lookup(const void* tab, const void* tags, int n_buckets,
                  const void* q_lo, const void* q_hi, void* la, void* ph,
                  void* found, long long n, cudaStream_t stream) {
  const auto kernel = hash_lookup_kernel<STAGED, TWO_WORDS>;
  const int smem = STAGED ? n_buckets * ENTRIES : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long per_block = static_cast<long long>(THREADS) * QPT;
  const long long blocks_needed = (n + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(
      blocks_needed < resident ? blocks_needed : resident);
  hash_lookup_kernel<STAGED, TWO_WORDS><<<blocks, THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(tab), static_cast<const uint4*>(tags),
      static_cast<uint32_t>(n_buckets - 1),
      static_cast<const uint32_t*>(q_lo), static_cast<const uint32_t*>(q_hi),
      static_cast<float*>(la), static_cast<float*>(ph),
      static_cast<bool*>(found), n);
  return static_cast<int>(cudaGetLastError());
}

bool valid_buckets(int n_buckets) {
  return n_buckets > 0 && (n_buckets & (n_buckets - 1)) == 0;
}

}  // namespace

// Bytes of tags up to which the lookup stages them in shared memory.
extern "C" int hash_lookup_tag_smem_bytes() { return TAG_SMEM_BYTES; }

// Writes the (n_buckets, 32) uint8 tags of `tab` on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int hash_tags_launch(const void* tab, int n_buckets, void* tags,
                                void* stream) {
  if (!valid_buckets(n_buckets))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_slots = static_cast<long long>(n_buckets) * ENTRIES;
  const long long blocks_needed = (n_slots + TAG_THREADS - 1) / TAG_THREADS;
  const int blocks =
      static_cast<int>(blocks_needed < (1 << 20) ? blocks_needed : 1 << 20);
  hash_tags_kernel<<<blocks, TAG_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<uint8_t*>(tags),
      n_slots);
  return static_cast<int>(cudaGetLastError());
}

// Looks the queries up in `tab` through its tags (hash_tags_launch) on
// `stream`; returns the cudaError_t of the launch (0 = success). q_hi may
// be null (one-word keys: every high word is 0).
extern "C" int hash_lookup_launch(const void* tab, const void* tags,
                                  int n_buckets, const void* q_lo,
                                  const void* q_hi, void* la, void* ph,
                                  void* found, long long n, void* stream) {
  if (n <= 0 || !valid_buckets(n_buckets))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool staged =
      static_cast<long long>(n_buckets) * ENTRIES <= TAG_SMEM_BYTES;
  if (staged) {
    return q_hi != nullptr
               ? launch_lookup<true, true>(tab, tags, n_buckets, q_lo, q_hi,
                                           la, ph, found, n, s)
               : launch_lookup<true, false>(tab, tags, n_buckets, q_lo, q_hi,
                                            la, ph, found, n, s);
  }
  return q_hi != nullptr
             ? launch_lookup<false, true>(tab, tags, n_buckets, q_lo, q_hi,
                                          la, ph, found, n, s)
             : launch_lookup<false, false>(tab, tags, n_buckets, q_lo, q_hi,
                                           la, ph, found, n, s);
}
