// Embedding row gather for sm_90a: out[i] = table[rows[i]].
//
// Replaces the TPU kernel `_gather_kernel` (paddle_tpu/ops/
// pallas_embedding.py), launched by `_gather_rows_kernel` for the sparse
// gradient exchange: a batch's deduped row set rides the grid's scalar
// prefetch and each grid step DMAs exactly one touched table row.  Pad
// rows (-1 from `unique_rows`, the table height from
// `unique_rows_sorted`) clamp to a real row; callers discard their
// values.
//
// Design.  A pure copy with no reduction: one warp a row, several rows a
// CTA, no shared memory.  Lane l copies the row's 16-byte vectors l,
// l + 32, ... (one a lane at D 128 fp32) with read-only loads, so a warp
// reads and writes one contiguous row segment of 512 bytes at a time.
// The row index is read and clamped by the warp itself (the TPU's scalar
// prefetch has no counterpart to keep).  Offsets are 64-bit: a 10^7 x
// 128 table has 1.28e9 elements.
//
// Bound on the H100: bytes.  K rows of D fp32 read once and written once
// plus the K indices: 8192 x 128 moves 8.4 MB, 2.5 us at 3.35 TB/s; at
// that size launch latency is of the same order.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // rows a CTA
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
    embedding_gather_kernel(const float4* __restrict__ table,
                            const int* __restrict__ rows,
                            float4* __restrict__ out, int K, int V,
                            int vec) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= K) return;
  const int lane = threadIdx.x & 31;
  int r = __ldg(rows + i);
  r = r < 0 ? 0 : (r >= V ? V - 1 : r);
  const float4* src = table + static_cast<long long>(r) * vec;
  float4* dst = out + static_cast<long long>(i) * vec;
#pragma unroll 4
  for (int c = lane; c < vec; c += 32) dst[c] = __ldg(src + c);
}

}  // namespace

// table fp32 [V, D] contiguous, D % 128 == 0 (the reference's gate);
// rows int32 [K] (values outside [0, V) clamp); out fp32 [K, D]
// contiguous.  All 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int embedding_gather(const void* table, const void* rows,
                                void* out, int K, int V, int D,
                                void* stream) {
  if (K <= 0 || V <= 0 || D % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (K + kWarps - 1) / kWarps;
  embedding_gather_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(rows),
      static_cast<float4*>(out), K, V, D / 4);
  return static_cast<int>(cudaGetLastError());
}
