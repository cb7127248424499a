// Shared pieces of the fused LSTM and GRU kernels: the cooperative launch
// of the single-block LSTM forward (lstm_fwd.cu, kernel 8), the
// valid-row list and split sum of the blocked dW kernels
// (lstm_dw_blocked.cu, gru_dw_blocked.cu), and what the tensor-core
// kernels (lstm_wg.cuh, gru_wg.cuh, dw_wg.cuh, gru_fwd.cu) build on: the
// gate nonlinearity and the cp.async group helpers.
//
// Layouts are batch-major, as the port's public functions take them: xw
// / gates / dxw [B, T, nH] (the LSTM's gate order i, f, c, o; the GRU's
// u, r, c), state sequences [B, T, H], mask [B, T] (1.0 valid, 0.0
// padding).  Every recurrent product -- the step products of kernels
// 8-11 and 13-16 (lstm_fwd.cu, lstm_wg.cuh, gru_fwd.cu,
// gru_fwd_blocked.cu, gru_wg.cuh) and the dW products of kernels 9, 12,
// 14 and 17 (dw_wg.cuh) -- runs on the tensor cores, its f32 operands as
// hi + lo bf16 in three passes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lstm {

constexpr int kThreads = 256;
__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// cp.async groups (dw_wg.cuh issues the copies).
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for all but the newest N groups of this thread's copies; a
// compiler barrier too, so that no shared-memory read moves above it.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
