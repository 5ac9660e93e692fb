// Grouped Pauli matrix elements for a batch of packed determinants.
//
// Replaces the TPU kernel anqs_quantum_chemistry_tpu/ops/pallas_kernels.py
// fused_matrix_elements / _fused_me_kernel (:100-191), which computes
//     sign = 1 - 2 * ((X_bits @ B_bits) mod 2),  ME = sign @ (G0 + G1 + G2)
// with G0..G2 the three bf16 residual splits of the weight-folded group
// one-hot (T, M). Here the one-hot is not materialised: every term t belongs
// to exactly one group m, so
//     ME[b, m] = sum_{t in group m} sum_k G_k[t] * (-1)^popcount(x_b & B_t)
// over the CSR range group_starts[m] .. group_starts[m+1].
//
// Rounding contract (the plain version in ops/matrix_elements.py keeps the
// same one): each split's sum is accumulated in double and rounded once to
// float -- +-bf16 values of a group sum exactly in double, so the result
// does not depend on summation order -- and the three are added in float as
// (s0 + s1) + s2, the order of the JAX 'split' path.
//
// What binds it on the H100: the (B, M) float32 output, nearly all of the
// bytes the function moves (N2: B 14464, M 536, 31.10 MB, 9.28 us at 3.35
// TB/s; Li2O: B 8192, M 3072, 100.87 MB, 30.11 us; C2H4/6-31G: B 8192,
// M 20776, 682.40 MB, 203.70 us) against three float64 adds per (row,
// term) pair (N2 129M, 7.7 us at 132 SMs x 64 FP64 lanes x 1.98 GHz; Li2O
// 397M, 23.8 us; C2H4 2.56G, 153 us). The two are within 1.3x of each
// other, so the design keeps the float64 pipe fed and writes the output
// once, in whole row segments:
//
// - Balance over terms. Groups are very uneven (median 4 terms; the
//   diagonal group 210 at N2, 465 at Li2O, 1378 at C2H4). A block owns a
//   tile of up to TILE_GROUPS consecutive groups (at most TILE_TERMS terms
//   unless one group holds more) and ROWS rows; the tile's term range is
//   cut into WARPS segments of equal length, blind to groups, except that a
//   boundary within seg / 8 terms of a group's end moves there: most groups
//   are then whole in one segment, and only long groups are cut. The host
//   makes this partition once per Hamiltonian (ops/matrix_elements.py
//   tile_segments): a warp loads its segment, the tile-local group where it
//   starts and the cut slots of its first and last groups.
// - A warp walks its segment in a warp-uniform loop: lane l holds rows l,
//   l + 32, l + 64 and l + 96, so a term's record (three float64 splits and
//   its sign mask, 32 B, copied into the warp's shared buffer by cp.async)
//   is two broadcast loads for 128 (row, term) pairs, with no divergence.
//   A pair costs an AND, a popcount, a shift-add and three float64 FMAs by
//   +-1.0 (exact). The float64 sums stay in registers and are flushed at
//   each group end: rounded into the tile's float32 stage where the warp
//   holds the whole group, else added (atomicAdd, exact in any order) into
//   the slot of the group's owner, the first warp whose segment starts
//   inside it, which rounds the total.
// - Shared memory per block is fixed (74,244 B for W <= 2: three blocks an
//   SM), whatever T is. The store reads the stage transposed (padded row
//   stride: no bank conflicts), and each warp writes whole row segments of
//   the tile: coalesced.
// - Grid: (row tiles, tiles), many short blocks, which the hardware
//   scheduler balances (N2 1017 blocks, Li2O 3136, C2H4 20864); the row
//   tiles of one tile run next to each other and share its records in L2.
//   More than 65535 tiles (over 4.19M groups) take several launches.
//
// Its times on the card, beside these bounds, are in PERF.md (kernel
// table), measured by chip_smoke.py.
//
// Tensor cores do not pay: a 64-term tile touches ~16 groups, so an FP64
// mma would do ~16 multiply-adds per pair where this does one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_build.py); called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // ops/matrix_elements.py SEG_WARPS
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_LANE = 4;
constexpr int ROWS = 32 * ROWS_PER_LANE;  // rows of a block
constexpr int TILE_GROUPS = 64;  // ops/matrix_elements.py TILE_GROUPS
constexpr int STAGE_STRIDE = ROWS + 1;  // floats; padded against conflicts
constexpr int SEG_BUF = 64;             // terms of a warp's record buffer
constexpr int MAX_WORDS = 4;            // up to 128 qubits
constexpr int MAX_GRID_Y = 65535;
static_assert(THREADS > TILE_GROUPS, "one thread loads each group offset");

// A term's record: W <= 2 -> 2 x 16 B (w0, w1 | w2, b0 b1);
// W <= 4 -> 3 x 16 B (w0, w1 | w2, b0 b1 | b2 b3, unused).
template <int W>
constexpr int VECS = W <= 2 ? 2 : 3;

template <int W>
struct Smem {
  uint4 rec[WARPS][SEG_BUF * VECS<W>];  // each warp's next terms
  double cut[WARPS][3][ROWS];  // partial sums of the cut group warp k owns
  float stage[TILE_GROUPS * STAGE_STRIDE];  // rounded sums, [group][row]
  int starts[TILE_GROUPS + 1];  // the tile's group offsets
};

template <int W>
struct Term {
  double w0, w1, w2;
  uint32_t b[W];
};

template <int W>
__device__ __forceinline__ Term<W> read_term(const uint4* p) {
  const uint4 a = p[0], c = p[1];
  Term<W> term;
  term.w0 = __hiloint2double(static_cast<int>(a.y), static_cast<int>(a.x));
  term.w1 = __hiloint2double(static_cast<int>(a.w), static_cast<int>(a.z));
  term.w2 = __hiloint2double(static_cast<int>(c.y), static_cast<int>(c.x));
  term.b[0] = c.z;
  if constexpr (W > 1) term.b[1] = c.w;
  if constexpr (W > 2) {
    const uint4 d = p[2];
    term.b[2] = d.x;
    if constexpr (W > 3) term.b[3] = d.y;
  }
  return term;
}

// Start copying the records of terms [t, t + n), n <= SEG_BUF, into a
// warp's buffer (cp.async, 16 B a lane at a time, no registers held);
// fill_wait() and then a warp or block barrier make them readable.
template <int W>
__device__ __forceinline__ void fill_async(uint4* buf,
                                           const uint4* __restrict__ records,
                                           int t, int n, int lane) {
  const uint4* src = records + static_cast<int64_t>(t) * VECS<W>;
  for (int i = lane; i < n * VECS<W>; i += 32) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(buf + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fill_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float round_sum(double s0, double s1, double s2) {
  return (static_cast<float>(s0) + static_cast<float>(s1)) +
         static_cast<float>(s2);
}

// Every group holds at least one term (build_tables checks it), so every
// column of a tile is written: by the one warp whose segment holds the
// whole group, or, for a group cut between segments, by its owner, from
// the partial sums of all of them.
template <int W>
__global__ void __launch_bounds__(THREADS, 3)
fused_me_kernel(const int64_t* __restrict__ words,     // (B, W)
                const uint4* __restrict__ records,     // (T, 4 or 6) int64
                const int32_t* __restrict__ group_starts,  // (M + 1,)
                const int2* __restrict__ tiles,  // (n_tiles + 1,) (m, t)
                const int4* __restrict__ segments,  // (n_tiles, WARPS)
                float* __restrict__ out,               // (B, M)
                int n_rows, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<W>& sm = *reinterpret_cast<Smem<W>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = tiles[blockIdx.y].x;
  const int n_cols = tiles[blockIdx.y + 1].x - m0;
  const int row0 = blockIdx.x * ROWS;
  // This warp's segment [s0, s1), the tile-local group holding s0, and the
  // cut slots of its first and last groups (used only where they are cut).
  const int4 part = segments[blockIdx.y * WARPS + warp];
  const int s0 = part.x, s1 = part.y, first = part.z;
  const int head_slot = part.w & 0xFFFF, tail_slot = part.w >> 16;

  int buf_t0 = s0;
  int buf_end = min(s0 + SEG_BUF, s1);
  if (s0 < s1)
    fill_async<W>(sm.rec[warp], records, s0, buf_end - s0, lane);
  if (threadIdx.x <= n_cols)
    sm.starts[threadIdx.x] = group_starts[m0 + threadIdx.x];
  double2* cut2 = reinterpret_cast<double2*>(&sm.cut[0][0][0]);
  for (int i = threadIdx.x; i < WARPS * 3 * ROWS / 2; i += THREADS)
    cut2[i] = make_double2(0.0, 0.0);
  uint32_t x[ROWS_PER_LANE][W];
#pragma unroll
  for (int i = 0; i < ROWS_PER_LANE; ++i) {
    const int r = row0 + lane + 32 * i;
#pragma unroll
    for (int j = 0; j < W; ++j)
      x[i][j] = r < n_rows
                    ? static_cast<uint32_t>(words[static_cast<int64_t>(r) * W + j])
                    : 0u;
  }
  fill_wait();
  __syncthreads();

  if (s0 < s1) {
    const uint4* buf = sm.rec[warp];
    for (int m = first;; ++m) {
      const int g_lo = sm.starts[m];
      const int g_hi = sm.starts[m + 1];
      double a0[ROWS_PER_LANE], a1[ROWS_PER_LANE], a2[ROWS_PER_LANE];
#pragma unroll
      for (int i = 0; i < ROWS_PER_LANE; ++i) a0[i] = a1[i] = a2[i] = 0.0;
      const int te = min(g_hi, s1);
      for (int t = max(g_lo, s0);;) {
        const int stop = min(te, buf_end);
#pragma unroll 4
        for (; t < stop; ++t) {
          const Term<W> term = read_term<W>(buf + (t - buf_t0) * VECS<W>);
#pragma unroll
          for (int i = 0; i < ROWS_PER_LANE; ++i) {
            uint32_t v = x[i][0] & term.b[0];
#pragma unroll
            for (int j = 1; j < W; ++j) v ^= x[i][j] & term.b[j];
            // +-1.0: the parity in the sign bit of 1.0's high word.
            const double s = __hiloint2double(
                static_cast<int>(0x3FF00000u |
                                 (static_cast<uint32_t>(__popc(v)) << 31)),
                0);
            a0[i] = fma(s, term.w0, a0[i]);
            a1[i] = fma(s, term.w1, a1[i]);
            a2[i] = fma(s, term.w2, a2[i]);
          }
        }
        if (t >= te) break;
        __syncwarp();  // the buffer is read; refill it from term t
        buf_t0 = t;
        buf_end = min(t + SEG_BUF, s1);
        fill_async<W>(sm.rec[warp], records, t, buf_end - t, lane);
        fill_wait();
        __syncwarp();
      }
      if (g_lo >= s0 && g_hi <= s1) {  // the whole group is this warp's
        float* c = sm.stage + m * STAGE_STRIDE + lane;
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i)
          c[32 * i] = round_sum(a0[i], a1[i], a2[i]);
      } else {  // cut: exact partial sums, added in any order
        double* c = &sm.cut[m == first ? head_slot : tail_slot][0][lane];
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i) {
          atomicAdd(c + 32 * i, a0[i]);
          atomicAdd(c + ROWS + 32 * i, a1[i]);
          atomicAdd(c + 2 * ROWS + 32 * i, a2[i]);
        }
      }
      if (g_hi >= s1 || m + 1 >= n_cols) break;
    }
  }
  __syncthreads();

  // The owner of a cut group is the first warp whose segment starts inside
  // it; that group is the warp's first, and its slot is the warp's own.
  if (s0 < s1 && sm.starts[first] < s0 && head_slot == warp) {
    float* c = sm.stage + first * STAGE_STRIDE + lane;
#pragma unroll
    for (int i = 0; i < ROWS_PER_LANE; ++i)
      c[32 * i] = round_sum(sm.cut[warp][0][lane + 32 * i],
                            sm.cut[warp][1][lane + 32 * i],
                            sm.cut[warp][2][lane + 32 * i]);
  }
  __syncthreads();

  // Store: a warp writes one row's tile segment at a time.
  const int rows_here = min(ROWS, n_rows - row0);
#pragma unroll 4
  for (int r = warp; r < rows_here; r += WARPS) {
    float* dst = out + static_cast<int64_t>(row0 + r) * n_groups + m0;
#pragma unroll
    for (int g = lane; g < TILE_GROUPS; g += 32)
      if (g < n_cols) dst[g] = sm.stage[g * STAGE_STRIDE + r];
  }
}

template <int W>
int launch(const void* words, const void* records, const void* group_starts,
           const void* tiles, const void* segments, void* out, int n_rows,
           int n_groups, int n_tiles, void* stream) {
  constexpr size_t smem = sizeof(Smem<W>);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_me_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Tiles go on grid.y (at most MAX_GRID_Y a launch), row tiles on grid.x.
  for (int c = 0; c < n_tiles; c += MAX_GRID_Y) {
    const dim3 grid((n_rows + ROWS - 1) / ROWS, min(n_tiles - c, MAX_GRID_Y));
    fused_me_kernel<W><<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(words),
        static_cast<const uint4*>(records),
        static_cast<const int32_t*>(group_starts),
        static_cast<const int2*>(tiles) + c,
        static_cast<const int4*>(segments) + static_cast<int64_t>(c) * WARPS,
        static_cast<float*>(out), n_rows, n_groups);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `tile_groups` and `warps` are the caller's tile width and segments a
// tile, which must equal TILE_GROUPS and WARPS.
extern "C" int fused_me_launch(const void* words, const void* records,
                               const void* group_starts, const void* tiles,
                               const void* segments, void* out,
                               int n_rows, int n_words, int n_groups,
                               int n_tiles, int tile_groups, int warps,
                               void* stream) {
  if (n_rows <= 0 || n_groups <= 0 || n_tiles <= 0 || n_words <= 0 ||
      n_words > MAX_WORDS || tile_groups != TILE_GROUPS || warps != WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n_words) {
    case 1: return launch<1>(words, records, group_starts, tiles, segments,
                             out, n_rows, n_groups, n_tiles, stream);
    case 2: return launch<2>(words, records, group_starts, tiles, segments,
                             out, n_rows, n_groups, n_tiles, stream);
    case 3: return launch<3>(words, records, group_starts, tiles, segments,
                             out, n_rows, n_groups, n_tiles, stream);
    default: return launch<4>(words, records, group_starts, tiles, segments,
                              out, n_rows, n_groups, n_tiles, stream);
  }
}
