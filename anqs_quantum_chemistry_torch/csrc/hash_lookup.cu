// Bucket-hash membership lookup of packed determinant keys.
//
// Replaces the TPU kernel anqs_quantum_chemistry_tpu/ops/pallas_kernels.py
// hash_lookup / _hash_lookup_kernel (:32-97), and serves the other bucket
// layouts of the JAX engine's _hash_query (observables/pauli.py:872-905)
// with the same code. A key is K = max(W, 2) 32-bit words (a one-word key
// has a high word of 0). Its bucket is the three-round mix hash of the first
// two words, folded left over the others (mix2(mix2(k0, k1), k2), ...:
// PauliEngine._bucket_hash), masked to nb - 1. The (nb, (K + 2) * E)
// float32 table that PauliEngine._hash_build writes holds E entries a
// bucket in K + 2 planar lane ranges: key word j at [j * E, (j + 1) * E)
// (the uint32 bits), log|psi| at [K * E, (K + 1) * E) (NEG = empty slot),
// phase at [(K + 1) * E, (K + 2) * E). The layouts instantiated are the
// Pallas kernel's (K 2, E 32), the JAX engine's hash_epb rows at W <= 2
// (K 2, E 8 or 16) and its rows above 64 qubits (K 3 or 4, E 16). The
// output per query is (log|psi| of the first entry whose keys match and
// whose log|psi| is not NEG, or NEG; its phase, or 0; found). The plain
// version (ops/hash_lookup.py hash_lookup_plain) selects the same entry, so
// the two agree bit for bit: nothing here does arithmetic on a value, and
// keys are compared as integer bits (a key whose bits read as a float NaN
// still matches).
//
// What binds it on the H100 (Li2O: N = 8192 rows x 3072 groups = 25.2M
// queries, nb = 1024 buckets = 512 KB): the query and output stream, 4 B
// in per key word (one word at W = 1, where the high word's pointer is
// null and the word is the constant 0) and 9 B out, 13 B a query at W = 1 = 0.33 GB, about
// 98 us at 3.35 TB/s. Nearly every query misses (Li2O step 0: 13136 hits of
// 25.2M), and the design decides a miss without reading the bucket row:
//
// - Tags. hash_tags_kernel writes one byte a slot, (nb, E) bytes: the
//   top 8 bits of the slot key's folded hash (bits the bucket index does
//   not use up to nb = 2^24), mapped into 1..255, or 0 where the slot's
//   log|psi| is NEG (empty). A tag is a function of the key, so a tag that
//   differs from the query's proves a key that differs; correctness never
//   rests on the tag, a poor one only costs time. The table changes every
//   step, so the tags are built anew in every hash_lookup call (32 KB at
//   Li2O, a few microseconds).
// - One lane, one query. A thread holds QPT queries in flight (coalesced
//   loads, QPT * THREADS consecutive queries a block pass), hashes each,
//   and probes its bucket's E tags as E / 16 16-B loads (one 8-B load at
//   E = 8): a zero-byte test of tag ^ query tag over the E / 4 words says
//   "no candidate" for about 1 - load/255 of the misses. Only candidate
//   slots, in ascending order, read the table from L2: the key words and
//   log|psi| of that slot, its phase on a full match, stopping at the
//   first. Queries and outputs use streaming (evict-first) loads and
//   stores, so they do not push the table and tags out of L2.
// - Tags in shared memory where they fit: up to TAG_SMEM_BYTES (64 KB:
//   nb <= 2048 at E = 32, nb <= 4096 at E = 16) each persistent block
//   copies the whole tag array into shared memory once (cp.async), which
//   keeps three 512-thread blocks an SM; above it the probes read the tags
//   from global memory (nb * E bytes, in L2 up to nb = 2^20 at E = 32).
//   Both tiers run the same code; only where the probe loads come from
//   differs.
// - The grid is one wave: as many blocks as the card holds at once, each
//   striding over the queries.
//
// What binds it, measured on the H100 at (K 2, E 32) (PERF.md, with the
// times of the designs timed against it): the stream. The same grid's loads
// and stores with no probe at all take about nine tenths of the kernel's
// time; the probe adds the rest, and reading the tags from L2 instead of
// shared memory (the tier above 64 KB) costs about 1.7x. A bank-conflict
// swizzle of the staged tags, a per-bucket flag that skips the second 16-B
// probe, 2 to 16 queries a thread, 256 to 1024 threads a block, 32-bit
// offsets, loading the next pass's queries ahead, and plain instead of
// streaming loads and stores were each tried and none was faster. At K 3-4
// a thread holds half the queries (QPT 4), so that K words of each stay in
// registers at three blocks an SM.
//
// Kernel #3, fp_filter_kernel: the prefilter's stage 1
// (PauliEngine._fp_candidates; plain version ops/hash_lookup.py
// fp_filter_plain). It replaces no Pallas kernel: the JAX package runs
// this pass in XLA (PauliEngine._proxy_via_prefilter's fp_probe). For rows
// x_r (B, W) and group masks A_m (W, M) it writes the (B, M) bool mask
// hit[r, m] = some slot of bucket bucket_hash(x_r ^ A_m) & (nb - 1) of the
// (nb, E) fingerprint table holds fp_hash(x_r ^ A_m), the table's
// fingerprints being PauliEngine._hash_build(with_fp=True)'s (0 = empty
// slot; a fingerprint is never 0). The JAX engine's own formulation:
// gather the bucket's E fingerprints, compare the lanes. Kernel and plain
// version answer the same question on the same integer hashes, so they
// agree bit for bit.
//
// What binds it on the H100: integer instructions on the INT32 pipe. Cr2
// (B 128 a row block, M 471,774, K 3, E 16) is 60.4M partners a launch.
// In the SASS of fp_filter_kernel<3, 16, true> the hashing and the compares
// of a partner take 57 instructions: 11 multiplies (IMAD, the FMA pipe;
// mix2's and fp32's first multiply share their constant) and 46 logic,
// shift and compare instructions (LOP3 with the XORs folded three inputs
// at a time, SHF, ISETP.EQ.OR folding the OR over the E slots into the
// predicate, PLOP3, SEL) on the INT32 pipe, 64 lanes an SM: 0.17 ms at
// 132 SMs x 1.98 GHz. Its bytes, the (B, M) mask written once and the
// masks read once, take 0.02 ms at 3.35 TB/s. The design spends little
// but those instructions:
//
// - A thread owns FP_GROUPS groups, FP_THREADS apart, so that each store
//   of a warp writes 32 consecutive bytes of a mask row; it keeps their K
//   mask words in registers (read once, coalesced, from the planar int32
//   columns the engine converts once) and loops over FP_ROWS rows, whose
//   words all threads read at one address (a broadcast from L1). Both
//   hashes run in wrapping uint32 (native 32-bit multiplies); nothing
//   intermediate goes to memory and nothing is sorted.
// - The table in shared memory where it fits: up to the wrapper's
//   FP_SMEM_BYTES (64 KB; Cr2's nb 512 x E 16 is 32 KB) each persistent
//   block copies the whole (nb, E) table in once (cp.async); above it the
//   probes read it from global memory (L2). Both tiers run the same code,
//   E / 4 16-B loads a probe; only where they load from differs. The
//   wrapper chooses the tier from the table's shape.
// - The grid is one wave: as many blocks as the card holds at once, each
//   taking a contiguous run of (group tile, row slice) items, tile-major,
//   so that a block reloads its mask words only when its tile changes and
//   the runs differ by at most one item (a tail of under 1% at Cr2).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_build.py); called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_KEYS = 4;
constexpr int THREADS = 512;
constexpr int MIN_BLOCKS = 3;  // blocks an SM the register budget allows
constexpr int TAG_SMEM_BYTES = 64 * 1024;
constexpr int TAG_THREADS = 256;
constexpr float NEG = -1e30f;

// The query columns: word j of query q at w[j][q]; a null column is all 0.
struct Queries {
  const uint32_t* w[MAX_KEYS];
};

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

// PauliEngine._bucket_hash: mix2 of the first two words, folded left.
template <int K>
__device__ __forceinline__ uint32_t bucket_hash(const uint32_t (&key)[K]) {
  uint32_t acc = mix2(key[0], key[1]);
#pragma unroll
  for (int j = 2; j < K; ++j) acc = mix2(acc, key[j]);
  return acc;
}

// PauliEngine._fp32 in wrapping uint32 arithmetic (never 0).
__device__ __forceinline__ uint32_t fp32(uint32_t lo, uint32_t hi) {
  uint32_t acc = lo * 0x9E3779B1u;
  acc ^= acc >> 16;
  acc = (acc ^ hi) * 0x85EBCA77u;
  acc ^= acc >> 13;
  acc *= 0xC2B2AE3Du;
  acc ^= acc >> 16;
  return acc | 1u;
}

// PauliEngine._fp_hash: fp32 of the first two words, folded left.
template <int K>
__device__ __forceinline__ uint32_t fp_hash(const uint32_t (&key)[K]) {
  uint32_t acc = fp32(key[0], key[1]);
#pragma unroll
  for (int j = 2; j < K; ++j) acc = fp32(acc, key[j]);
  return acc;
}

// A live slot's tag: the hash's top byte, 0 moved to 1 (0 marks empty).
__device__ __forceinline__ uint32_t tag_of(uint32_t h) {
  const uint32_t t = h >> 24;
  return t != 0u ? t : 1u;
}

// One byte a slot: tags[b * E + e] for entry e of bucket b.
template <int K, int E>
__global__ void __launch_bounds__(TAG_THREADS)
hash_tags_kernel(const uint32_t* __restrict__ tab, uint8_t* __restrict__ tags,
                 long long n_slots) {
  for (long long i = static_cast<long long>(blockIdx.x) * TAG_THREADS +
                     threadIdx.x;
       i < n_slots; i += static_cast<long long>(gridDim.x) * TAG_THREADS) {
    const uint32_t* row = tab + (i / E) * ((K + 2) * E);
    const int e = static_cast<int>(i % E);
    const float la = __uint_as_float(__ldg(row + K * E + e));
    uint8_t tag = 0;
    if (la > 0.5f * NEG) {
      uint32_t key[K];
#pragma unroll
      for (int j = 0; j < K; ++j) key[j] = __ldg(row + j * E + e);
      tag = static_cast<uint8_t>(tag_of(bucket_hash<K>(key)));
    }
    tags[i] = tag;
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

// The E tags of `bucket` as E / 4 words: 16-B loads, or one 8-B load at
// E = 8, from shared memory (STAGED) or through the read-only path.
template <int E, bool STAGED>
__device__ __forceinline__ void load_tags(const void* tags, uint32_t bucket,
                                          uint32_t (&t)[E / 4]) {
  if constexpr (E >= 16) {
    const uint4* p = static_cast<const uint4*>(tags) + bucket * (E / 16);
#pragma unroll
    for (int v = 0; v < E / 16; ++v) {
      uint4 x;
      if constexpr (STAGED) {
        x = p[v];
      } else {
        x = __ldg(p + v);
      }
      t[4 * v] = x.x;
      t[4 * v + 1] = x.y;
      t[4 * v + 2] = x.z;
      t[4 * v + 3] = x.w;
    }
  } else {
    const uint2* p = static_cast<const uint2*>(tags) + bucket;
    uint2 x;
    if constexpr (STAGED) {
      x = *p;
    } else {
      x = __ldg(p);
    }
    t[0] = x.x;
    t[1] = x.y;
  }
}

// NW: the key words the queries carry (the first NW columns; the other
// K - NW words are 0: NW 1 at K 2 for one-word keys).
template <int K, int E, int NW, bool STAGED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
hash_lookup_kernel(const uint32_t* __restrict__ tab,  // (nb, (K+2)E) bits
                   const uint8_t* __restrict__ tags,  // (nb, E) bytes
                   uint32_t bucket_mask,              // nb - 1
                   Queries queries,                   // NW columns of (N,)
                   float* __restrict__ la_out,        // (N,)
                   float* __restrict__ ph_out,        // (N,)
                   bool* __restrict__ found_out,      // (N,)
                   long long n) {
  constexpr int QPT = K <= 2 ? 8 : 4;  // queries a thread holds in flight
  constexpr int ROW = (K + 2) * E;
  constexpr int TAG_WORDS = E / 4;
  extern __shared__ uint4 staged[];
  const void* tag_rows = tags;
  if constexpr (STAGED) {
    const int n_vec = static_cast<int>(bucket_mask + 1) * E / 16;
    const uint4* src = reinterpret_cast<const uint4*>(tags);
    for (int i = threadIdx.x; i < n_vec; i += THREADS) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(staged + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src + i)
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
    uint32_t key[QPT][K];
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const long long q = base + k * THREADS;
#pragma unroll
      for (int j = 0; j < K; ++j)
        key[k][j] = j < NW && q < n ? __ldcs(queries.w[j] + q) : 0u;
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const long long q = base + k * THREADS;
      if (q >= n) break;
      const uint32_t h = bucket_hash<K>(key[k]);
      const uint32_t bucket = h & bucket_mask;
      const uint32_t rep = tag_of(h) * 0x01010101u;
      uint32_t t[TAG_WORDS];
      load_tags<E, STAGED>(tag_rows, bucket, t);
      float la = NEG, ph = 0.0f;
      bool found = false;
      uint32_t any = 0u;
#pragma unroll
      for (int v = 0; v < TAG_WORDS; ++v) any |= zero_bytes(t[v], rep);
      if (any & 0x80808080u) {
        uint32_t cand = 0u;
#pragma unroll
        for (int v = 0; v < TAG_WORDS; ++v)
          cand |= equal_bytes(t[v], rep) << (4 * v);
        const uint32_t* row = tab + static_cast<size_t>(bucket) * ROW;
        while (cand != 0u) {
          const int e = __ffs(cand) - 1;
          cand &= cand - 1u;
          bool match = true;
#pragma unroll
          for (int j = 0; j < K; ++j)
            match = match && __ldg(row + j * E + e) == key[k][j];
          const float la_e = __uint_as_float(__ldg(row + K * E + e));
          if (match && la_e > 0.5f * NEG) {
            la = la_e;
            ph = __uint_as_float(__ldg(row + (K + 1) * E + e));
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

template <int K, int E>
bool stages_tags(int n_buckets) {
  const long long bytes = static_cast<long long>(n_buckets) * E;
  return bytes <= TAG_SMEM_BYTES && bytes % 16 == 0;
}

template <int K, int E, int NW, bool STAGED>
int launch_lookup(const void* tab, const void* tags, int n_buckets,
                  const Queries& queries, void* la, void* ph, void* found,
                  long long n, cudaStream_t stream) {
  const auto kernel = hash_lookup_kernel<K, E, NW, STAGED>;
  constexpr int QPT = K <= 2 ? 8 : 4;
  const int smem = STAGED ? n_buckets * E : 0;
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
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(tab), static_cast<const uint8_t*>(tags),
      static_cast<uint32_t>(n_buckets - 1), queries, static_cast<float*>(la),
      static_cast<float*>(ph), static_cast<bool*>(found), n);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int E, int NW>
int lookup(const void* tab, const void* tags, int n_buckets,
           const Queries& queries, void* la, void* ph, void* found,
           long long n, cudaStream_t stream) {
  return stages_tags<K, E>(n_buckets)
             ? launch_lookup<K, E, NW, true>(tab, tags, n_buckets, queries,
                                             la, ph, found, n, stream)
             : launch_lookup<K, E, NW, false>(tab, tags, n_buckets, queries,
                                              la, ph, found, n, stream);
}

constexpr int FP_THREADS = 256;
constexpr int FP_MIN_BLOCKS = 4;
constexpr int FP_GROUPS = 4;  // groups a thread owns
constexpr int FP_ROWS = 16;   // rows of a work item
constexpr int FP_TILE = FP_THREADS * FP_GROUPS;

// Whether one of the E fingerprints of `bucket` equals f: E / 4 16-B loads
// from shared memory (STAGED) or through the read-only path. Each lane
// starts at another of the row's vectors: a row is E * 4 B, so vector v of
// every bucket lies in the same banks (E 32: one 128-B bank line a row),
// and a quarter-warp reading vector v of 8 buckets at once would conflict
// up to 8 ways; rotated, its lanes read 8 different vectors at E 32.
template <int E, bool STAGED>
__device__ __forceinline__ bool fp_probe(const uint32_t* fps, uint32_t bucket,
                                         uint32_t f) {
  constexpr int NV = E / 4;
  const uint4* p = reinterpret_cast<const uint4*>(fps) + bucket * NV;
  const int rot = static_cast<int>(threadIdx.x);
  bool any = false;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = (v + rot) & (NV - 1);
    uint4 x;
    if constexpr (STAGED) {
      x = p[i];
    } else {
      x = __ldg(p + i);
    }
    any |= (x.x == f) | (x.y == f) | (x.z == f) | (x.w == f);
  }
  return any;
}

// Rows carry n_words key words: K of them, or one at K 2 (one-word keys,
// whose high word is 0, chosen at run time). Rows are int64 words in
// [0, 2^32): their low 32 bits are the word.
template <int K, int E, bool STAGED>
__global__ void __launch_bounds__(FP_THREADS, FP_MIN_BLOCKS)
fp_filter_kernel(const uint32_t* __restrict__ fptab,  // (nb, E)
                 uint32_t bucket_mask,                // nb - 1
                 const long long* __restrict__ words, // (B, n_words)
                 const uint32_t* __restrict__ a_cols, // (n_words, M)
                 int n_words, int n_rows, int n_groups,
                 bool* __restrict__ hits) {           // (B, M)
  extern __shared__ uint4 staged[];
  const uint32_t* fps = fptab;
  if constexpr (STAGED) {
    const int n_vec = static_cast<int>(bucket_mask + 1) * E / 4;
    const uint4* src = reinterpret_cast<const uint4*>(fptab);
    for (int i = threadIdx.x; i < n_vec; i += FP_THREADS) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(staged + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src + i)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    fps = reinterpret_cast<const uint32_t*>(staged);
  }
  // Known at compile time above K 2, so the word tests below fold away.
  const int nw = K == 2 ? n_words : K;

  const int n_slices = (n_rows + FP_ROWS - 1) / FP_ROWS;
  const long long items =
      static_cast<long long>((n_groups + FP_TILE - 1) / FP_TILE) * n_slices;
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  long long loaded = -1;
  uint32_t a[FP_GROUPS][K];
  for (long long item = first; item < last; ++item) {
    const long long tile = item / n_slices;
    const int slice = static_cast<int>(item % n_slices);
    const long long m0 = tile * FP_TILE + threadIdx.x;
    if (tile != loaded) {
#pragma unroll
      for (int g = 0; g < FP_GROUPS; ++g) {
        const long long m = m0 + g * FP_THREADS;
#pragma unroll
        for (int j = 0; j < K; ++j)
          a[g][j] = m < n_groups && j < nw
                        ? __ldg(a_cols + j * static_cast<long long>(
                                             n_groups) + m)
                        : 0u;
      }
      loaded = tile;
    }
    const int r_end = min(n_rows, (slice + 1) * FP_ROWS);
    for (int r = slice * FP_ROWS; r < r_end; ++r) {
      uint32_t x[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        x[j] = j < nw ? static_cast<uint32_t>(__ldg(
                            words + static_cast<long long>(r) * nw + j))
                      : 0u;
      bool* out = hits + static_cast<long long>(r) * n_groups;
#pragma unroll
      for (int g = 0; g < FP_GROUPS; ++g) {
        uint32_t key[K];
#pragma unroll
        for (int j = 0; j < K; ++j) key[j] = x[j] ^ a[g][j];
        const bool hit = fp_probe<E, STAGED>(
            fps, bucket_hash<K>(key) & bucket_mask, fp_hash<K>(key));
        const long long m = m0 + g * FP_THREADS;
        if (m < n_groups) out[m] = hit;
      }
    }
  }
}

template <int K, int E, bool STAGED>
int launch_fp_filter(const void* fptab, int n_buckets, const void* words,
                     const void* a_cols, int n_words, int n_rows,
                     int n_groups, void* hits, cudaStream_t stream) {
  const auto kernel = fp_filter_kernel<K, E, STAGED>;
  const int smem = STAGED ? n_buckets * E * 4 : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      FP_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items =
      static_cast<long long>((n_groups + FP_TILE - 1) / FP_TILE) *
      ((n_rows + FP_ROWS - 1) / FP_ROWS);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(items < resident ? items : resident);
  kernel<<<blocks, FP_THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(fptab),
      static_cast<uint32_t>(n_buckets - 1),
      static_cast<const long long*>(words),
      static_cast<const uint32_t*>(a_cols), n_words, n_rows, n_groups,
      static_cast<bool*>(hits));
  return static_cast<int>(cudaGetLastError());
}

template <int K, int E>
int build_tags(const void* tab, int n_buckets, void* out,
               cudaStream_t stream) {
  const long long n_slots = static_cast<long long>(n_buckets) * E;
  const long long blocks_needed = (n_slots + TAG_THREADS - 1) / TAG_THREADS;
  const int blocks =
      static_cast<int>(blocks_needed < (1 << 20) ? blocks_needed : 1 << 20);
  hash_tags_kernel<K, E><<<blocks, TAG_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(tab), static_cast<uint8_t*>(out),
      n_slots);
  return static_cast<int>(cudaGetLastError());
}

bool valid_buckets(int n_buckets) {
  return n_buckets > 0 && (n_buckets & (n_buckets - 1)) == 0;
}

// The instantiated layouts: (K 2; E 8, 16, 32) and (K 3 or 4; E 16).
// Returns call.template run<K, E>() for a valid pair, else
// cudaErrorInvalidValue.
template <typename Call>
int dispatch(int n_keys, int entries, const Call& call) {
  if (n_keys == 2 && entries == 32) return call.template run<2, 32>();
  if (n_keys == 2 && entries == 16) return call.template run<2, 16>();
  if (n_keys == 2 && entries == 8) return call.template run<2, 8>();
  if (n_keys == 3 && entries == 16) return call.template run<3, 16>();
  if (n_keys == 4 && entries == 16) return call.template run<4, 16>();
  return static_cast<int>(cudaErrorInvalidValue);
}

struct TagsCall {
  const void* tab;
  int n_buckets;
  void* out;
  cudaStream_t stream;
  template <int K, int E>
  int run() const {
    return build_tags<K, E>(tab, n_buckets, out, stream);
  }
};

struct LookupCall {
  const void* tab;
  const void* tag_bytes;
  int n_buckets;
  Queries queries;
  void* la;
  void* ph;
  void* found;
  long long n;
  cudaStream_t stream;
  template <int K, int E>
  int run() const {
    // One-word keys at K 2 leave the high word's column null; otherwise
    // every column is given.
    if constexpr (K == 2) {
      if (queries.w[1] == nullptr)
        return lookup<K, E, 1>(tab, tag_bytes, n_buckets, queries, la, ph,
                               found, n, stream);
    }
    for (int j = 0; j < K; ++j)
      if (queries.w[j] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    return lookup<K, E, K>(tab, tag_bytes, n_buckets, queries, la, ph, found,
                           n, stream);
  }
};

struct FilterCall {
  const void* fptab;
  int n_buckets;
  const void* words;
  const void* a_cols;
  int n_words;
  int n_rows;
  int n_groups;
  bool staged;
  void* hits;
  cudaStream_t stream;
  template <int K, int E>
  int run() const {
    return staged ? launch_fp_filter<K, E, true>(fptab, n_buckets, words,
                                                 a_cols, n_words, n_rows,
                                                 n_groups, hits, stream)
                  : launch_fp_filter<K, E, false>(fptab, n_buckets, words,
                                                  a_cols, n_words, n_rows,
                                                  n_groups, hits, stream);
  }
};

}  // namespace

// Bytes of tags up to which the lookup stages them in shared memory.
extern "C" int hash_lookup_tag_smem_bytes() { return TAG_SMEM_BYTES; }

// Writes the (n_buckets, entries) uint8 tags of `tab`, a table of n_keys
// key words and `entries` entries a bucket, on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int hash_tags_launch(const void* tab, int n_buckets, int n_keys,
                                int entries, void* out, void* stream) {
  if (!valid_buckets(n_buckets))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(n_keys, entries,
                  TagsCall{tab, n_buckets, out,
                           static_cast<cudaStream_t>(stream)});
}

// Looks the queries up in `tab` through its tags (hash_tags_launch) on
// `stream`; returns the cudaError_t of the launch (0 = success). q0..q3 are
// the queries' key words, the first n_keys of them read; q1 may be null at
// n_keys 2 (one-word keys: every high word is 0), no other may.
extern "C" int hash_lookup_launch(const void* tab, const void* tag_bytes,
                                  int n_buckets, int n_keys, int entries,
                                  const void* q0, const void* q1,
                                  const void* q2, const void* q3, void* la,
                                  void* ph, void* found, long long n,
                                  void* stream) {
  if (n <= 0 || !valid_buckets(n_buckets))
    return static_cast<int>(cudaErrorInvalidValue);
  const Queries queries{{static_cast<const uint32_t*>(q0),
                         static_cast<const uint32_t*>(q1),
                         static_cast<const uint32_t*>(q2),
                         static_cast<const uint32_t*>(q3)}};
  return dispatch(n_keys, entries,
                  LookupCall{tab, tag_bytes, n_buckets, queries, la, ph,
                             found, n, static_cast<cudaStream_t>(stream)});
}

// Writes the (n_rows, n_groups) bool mask of kernel #3 on `stream`: for
// rows `words` ((n_rows, n_words) int64) and masks `a_cols` ((n_words,
// n_groups) int32), whether each partner's bucket of `fptab` ((n_buckets,
// entries) int32, of keys of max(n_words, 2) words) holds its fingerprint;
// `staged` puts the table in shared memory. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int fp_filter_launch(const void* fptab, int n_buckets,
                                int entries, const void* words, int n_words,
                                const void* a_cols, int n_rows, int n_groups,
                                int staged, void* hits, void* stream) {
  if (n_rows <= 0 || n_groups <= 0 || n_words < 1 ||
      !valid_buckets(n_buckets))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(n_words > 2 ? n_words : 2, entries,
                  FilterCall{fptab, n_buckets, words, a_cols, n_words, n_rows,
                             n_groups, staged != 0, hits,
                             static_cast<cudaStream_t>(stream)});
}
