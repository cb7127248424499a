// Shared pieces of the fused LSTM and GRU kernels: the CUDA-core product
// of the single-block GRU forward (gru_fwd.cu, kernel 13) and its
// cooperative launch, the valid-row list and split sum of the blocked dW
// kernels (lstm_dw_blocked.cu, gru_dw_blocked.cu), and what the
// tensor-core kernels (lstm_wg.cuh, gru_wg.cuh, dw_wg.cuh) build on.
//
// Kernel 13 is a persistent cooperative launch: one CTA per slice of U
// hidden units, the whole grid resident.  Layouts are batch-major, as the
// port's public functions take them: xw / gates / dxw [B, T, nH] (the
// LSTM's gate order i, f, c, o; the GRU's u, r, c), state sequences [B,
// T, H], mask [B, T] (1.0 valid, 0.0 padding).
//
// Kernel 13's products run on CUDA cores in fp32 (TF32 would change the
// numbers).  Shared memory serves one 32-bit word per bank per cycle, so
// a product is register-blocked: each thread keeps a 4 x 4 block of sums
// and reads its operands as float4, 2 shared loads per 16 FMAs.  The
// other recurrent kernels' products -- the step products of kernels 8-11
// and 14-16 (lstm_fwd.cu, lstm_wg.cuh, gru_fwd_blocked.cu, gru_wg.cuh)
// and the dW products of kernels 9, 12, 14 and 17 (dw_wg.cuh) -- run on
// the tensor cores instead, their f32 operands as hi + lo bf16 in three
// passes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lstm {

constexpr int kThreads = 256;
constexpr int kKT = 64;          // k-tile of the row product
constexpr int kTileRows = 128;   // batch rows per staged tile
constexpr int kTileStride = kKT + 4;  // padded row: float4-aligned
constexpr int kTileFloats = kTileRows * kTileStride;
constexpr int kStages = 3;       // tiles in flight: 2 loading, 1 in use
constexpr int kRedFloats = 8 * kTileRows * 4;    // k-group partial sums

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// 16-byte asynchronous copy global -> shared through L2 only (.cg: never
// a stale L1 line of data another CTA wrote before the last grid
// barrier); zero-fills when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for all but the newest N groups of this thread's copies; a
// compiler barrier too, so that no shared-memory read moves above it.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage an [nr, nc] block into shared memory: dst[r * ds + c] =
// row(r)[k0 + c], 0 where row(r) is null or k0 + c >= K.  With `vec`
// (every row start and K a multiple of 4 floats) the copies are 16-byte
// cp.async, completed by cp_wait; otherwise synchronous L2 loads.
template <class RowPtr>
__device__ __forceinline__ void stage(float* dst, int ds, RowPtr row, int nr,
                                      int nc, int k0, int K, bool vec,
                                      const float* any) {
  if (vec) {
    const int c4n = nc / 4;
    for (int idx = threadIdx.x; idx < nr * c4n; idx += kThreads) {
      const int r = idx / c4n, c = 4 * (idx % c4n);
      const float* src = row(r);
      const bool ok = src != nullptr && k0 + c < K;
      cp_async16(dst + r * ds + c, ok ? src + k0 + c : any, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < nr * nc; idx += kThreads) {
      const int r = idx / nc, c = idx % nc;
      const float* src = row(r);
      dst[r * ds + c] =
          (src != nullptr && k0 + c < K) ? __ldcg(src + k0 + c) : 0.f;
    }
  }
}

// Row product of one chunk of kTileRows rows, N = 4U columns:
//   C[r][j] = sum_k A[r0 + r][k] * bs[k * N + j]
// A rows are at a + row * lda (global, `rows` rows, K columns); bs is
// [round_up(K, kKT), N] in shared memory, zero past K; tiles is
// kStages staging buffers.  Tiles stream through a kStages-deep cp.async
// pipeline.  Threads form KG k-groups; thread (rb, cb, g) sums rows
// rb + 32 i (i < 4) x columns 4 cb .. 4 cb + 3 over its group's k-slice
// of every tile, 2 float4 shared loads per 16 FMAs.  The partial sums
// land in red[g][r][j]; the caller adds the KG groups in a fixed order
// (red_sum), so the result has the same bits on every run.
template <int N>
__device__ __forceinline__ void row_product(const float* a, long lda,
                                            int rows, int K, const float* bs,
                                            int r0, float* tiles, float* red,
                                            bool vec) {
  static_assert(N % 4 == 0, "row_product needs N = 4U");
  constexpr int CB = N / 4;
  constexpr int KG = kThreads / (32 * CB);
  constexpr int KS = kKT / KG;
  const int tid = threadIdx.x;
  const int rb = tid % 32, cb = (tid / 32) % CB, g = tid / (32 * CB);
  auto row = [&](int r) -> const float* {
    return r0 + r < rows ? a + (long)(r0 + r) * lda : nullptr;
  };
  const int nt = (K + kKT - 1) / kKT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  __syncthreads();  // the buffers are free
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt)
      stage(tiles + s * kTileFloats, kTileStride, row, kTileRows, kKT,
            s * kKT, K, vec, a);
    cp_commit();
  }
  for (int kt = 0; kt < nt; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nt)
      stage(tiles + ((kt + kStages - 1) % kStages) * kTileFloats,
            kTileStride, row, kTileRows, kKT, (kt + kStages - 1) * kKT, K,
            vec, a);
    cp_commit();
    const float* tile = tiles + (kt % kStages) * kTileFloats;
    const float* bk = bs + kt * kKT * N;
#pragma unroll 2
    for (int kk = g * KS; kk < (g + 1) * KS; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            tile + (rb + 32 * i) * kTileStride + kk);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 w =
            *reinterpret_cast<const float4*>(bk + (kk + d) * N + 4 * cb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = d == 0 ? av[i].x : d == 1 ? av[i].y
                        : d == 2 ? av[i].z : av[i].w;
          acc[i][0] += x * w.x;
          acc[i][1] += x * w.y;
          acc[i][2] += x * w.z;
          acc[i][3] += x * w.w;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(g * kTileRows + rb + 32 * i) * N + 4 * cb + c] = acc[i][c];
}

template <int N>
__device__ __forceinline__ float red_sum(const float* red, int idx) {
  constexpr int KG = kThreads / (32 * (N / 4));
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < KG; ++g) s += red[g * kTileRows * N + idx];
  return s;
}

// Launch `kernel` cooperatively on ceil(H / U) CTAs after checking that
// the whole grid can be resident.  Returns 0 or a cudaError_t; -1 when
// the grid cannot be co-resident (the wrapper raises; it never shrinks
// the grid or falls back).
template <typename K>
__host__ inline int cooperative_launch(K kernel, int H, int U, long smem_floats,
                                       void** args, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (H + U - 1) / U;
  if (!coop || (long)per_sm * sms < grid) return -1;
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the blocked dW kernels
// The valid (b, t) rows of a [B, T] mask, for the blocked tiers' dW
// products (lstm_dw_blocked.cu, gru_dw_blocked.cu), which skip the padded
// rows: their dgates are exact zeros.  One CTA of kCompactThreads:
// rows[0, n) = the indices r < R with mask[r] != 0, ascending; n into
// rows[R].
constexpr int kCompactThreads = 1024;
__global__ void __launch_bounds__(kCompactThreads)
    compact_rows_kernel(const float* __restrict__ mask, int R, int* rows) {
  __shared__ int counts[kCompactThreads];
  const int tid = threadIdx.x;
  const int per = (R + kCompactThreads - 1) / kCompactThreads;
  const int lo = min(R, tid * per), hi = min(R, lo + per);
  int c = 0;
  for (int r = lo; r < hi; ++r) c += mask[r] != 0.f;
  counts[tid] = c;
  __syncthreads();
  for (int off = 1; off < kCompactThreads; off <<= 1) {  // inclusive scan
    const int v = tid >= off ? counts[tid - off] : 0;
    __syncthreads();
    counts[tid] += v;
    __syncthreads();
  }
  int pos = counts[tid] - c;
  for (int r = lo; r < hi; ++r)
    if (mask[r] != 0.f) rows[pos++] = r;
  if (tid == kCompactThreads - 1) rows[R] = counts[tid];
}

// dw[i] = part[0][i] + part[1][i] + ... (split order).
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int n_split, long n, float* dw) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < n_split; ++k) s += part[k * n + i];
    dw[i] = s;
  }
}

// CTAs of `kernel` (`threads` threads, smem_floats of shared memory) that
// can be co-resident on the current card; 0 when the card has no
// cooperative launch, a cudaError_t as a negative number on failure.
template <typename K>
__host__ inline long resident_ctas(K kernel, long smem_floats,
                                   int threads) {
  const size_t smem = (size_t)smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(long)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(long)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return -(long)err;
  return coop ? (long)per_sm * sms : 0;
}

}  // namespace lstm
