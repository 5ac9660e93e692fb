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
// float -- ±bf16 values sum exactly in double, so the result does not depend
// on summation order -- and the three are added in float as (s0 + s1) + s2,
// the order of the JAX 'split' path.
//
// Bound on the H100 (N2: B = 14464 rows, T = 2958 terms, M = 536 groups,
// one 32-bit word per row): the output is B*M*4 = 31 MB, about 9 us at
// 3.35 TB/s; the inputs are under 0.2 MB; the work is B*T = 43M
// popcount/add triples, about 1 us of float32 issue. So the kernel is bound by
// writing the output. The design keeps everything else on chip: each block
// loads the term tables (sign masks, splits, group offsets: ~32 KB for N2)
// into shared memory once and walks a grid-stride loop over row tiles; a
// thread owns one group column m of ROWS rows, so the stores of a warp are 32
// consecutive floats of one output row. Tensor cores, TMA and load balance
// across uneven groups are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/cuda_build.py); called through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;
constexpr int THREADS = 256;
constexpr int MAX_WORDS = 4;  // up to 128 qubits
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// W = words per determinant, a template argument so the per-term word
// loops unroll into registers.
template <int W>
__global__ void __launch_bounds__(THREADS)
fused_me_kernel(const int64_t* __restrict__ words,      // (B, W)
                const int64_t* __restrict__ b_words,    // (T, W)
                const uint16_t* __restrict__ splits,    // (3, T) bf16 bits
                const int32_t* __restrict__ group_starts,  // (M + 1,)
                float* __restrict__ out,                // (B, M)
                int n_rows, int n_terms, int n_groups) {
  constexpr int n_words = W;
  extern __shared__ uint32_t smem[];
  uint32_t* s_b = smem;                                        // T * W
  int32_t* s_start = reinterpret_cast<int32_t*>(s_b + n_terms * n_words);
  uint32_t* s_x = reinterpret_cast<uint32_t*>(s_start + n_groups + 1);
  uint16_t* s_split = reinterpret_cast<uint16_t*>(s_x + ROWS * n_words);

  for (int i = threadIdx.x; i < n_terms * n_words; i += blockDim.x)
    s_b[i] = static_cast<uint32_t>(b_words[i]);
  for (int i = threadIdx.x; i <= n_groups; i += blockDim.x)
    s_start[i] = group_starts[i];
  for (int i = threadIdx.x; i < 3 * n_terms; i += blockDim.x)
    s_split[i] = splits[i];

  for (int row0 = blockIdx.x * ROWS; row0 < n_rows;
       row0 += gridDim.x * ROWS) {
    __syncthreads();  // tables loaded / previous tile's rows consumed
    for (int i = threadIdx.x; i < ROWS * n_words; i += blockDim.x) {
      const int r = row0 + i / n_words;
      s_x[i] = r < n_rows
                   ? static_cast<uint32_t>(words[(int64_t)r * n_words +
                                                 i % n_words])
                   : 0u;
    }
    __syncthreads();
    const int rows_here = min(ROWS, n_rows - row0);

    for (int m = threadIdx.x; m < n_groups; m += blockDim.x) {
      double acc0[ROWS], acc1[ROWS], acc2[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc0[r] = acc1[r] = acc2[r] = 0.0;

      const int t_end = s_start[m + 1];
      for (int t = s_start[m]; t < t_end; ++t) {
        const double w0 = bf16_bits_to_float(s_split[t]);
        const double w1 = bf16_bits_to_float(s_split[n_terms + t]);
        const double w2 = bf16_bits_to_float(s_split[2 * n_terms + t]);
        uint32_t bw[W];
#pragma unroll
        for (int j = 0; j < W; ++j) bw[j] = s_b[t * W + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          uint32_t par = 0;
#pragma unroll
          for (int j = 0; j < W; ++j)
            par += __popc(s_x[r * W + j] & bw[j]);
          const bool neg = par & 1u;
          acc0[r] += neg ? -w0 : w0;
          acc1[r] += neg ? -w1 : w1;
          acc2[r] += neg ? -w2 : w2;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows_here) {
          const float s01 = static_cast<float>(acc0[r]) +
                            static_cast<float>(acc1[r]);
          out[(int64_t)(row0 + r) * n_groups + m] =
              s01 + static_cast<float>(acc2[r]);
        }
      }
    }
  }
}

template <int W>
int launch(const void* words, const void* b_words, const void* splits,
           const void* group_starts, void* out, int n_rows, int n_terms,
           int n_groups, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_me_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // One wave: as many blocks as the card holds at once (resident blocks
  // per SM, which shared memory and registers limit, times the SM count).
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_me_kernel<W>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n_rows + ROWS - 1) / ROWS;
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  fused_me_kernel<W><<<blocks, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words),
      static_cast<const int64_t*>(b_words),
      static_cast<const uint16_t*>(splits),
      static_cast<const int32_t*>(group_starts), static_cast<float*>(out),
      n_rows, n_terms, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t fused_me_smem_bytes(int n_words, int n_terms,
                                      int n_groups) {
  return sizeof(uint32_t) * ((size_t)n_terms * n_words + n_groups + 1 +
                             (size_t)ROWS * n_words) +
         sizeof(uint16_t) * 3 * (size_t)n_terms;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int fused_me_launch(const void* words, const void* b_words,
                               const void* splits, const void* group_starts,
                               void* out, int n_rows, int n_words,
                               int n_terms, int n_groups, void* stream) {
  if (n_rows <= 0 || n_groups <= 0 || n_terms <= 0 || n_words <= 0 ||
      n_words > MAX_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fused_me_smem_bytes(n_words, n_terms, n_groups);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_words) {
    case 1: return launch<1>(words, b_words, splits, group_starts, out,
                             n_rows, n_terms, n_groups, smem, stream);
    case 2: return launch<2>(words, b_words, splits, group_starts, out,
                             n_rows, n_terms, n_groups, smem, stream);
    case 3: return launch<3>(words, b_words, splits, group_starts, out,
                             n_rows, n_terms, n_groups, smem, stream);
    default: return launch<4>(words, b_words, splits, group_starts, out,
                              n_rows, n_terms, n_groups, smem, stream);
  }
}
