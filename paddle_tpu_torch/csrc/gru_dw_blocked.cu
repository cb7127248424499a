// Hidden-blocked GRU weight gradients: dW_gates = sum over the valid (b, t)
// of h_{t-1}[b]^T dg_t[b] ([H x BT] x [BT x 2H]) and dW_cand = sum of
// (r h_{t-1})[b]^T dc_pre_t[b] ([H x BT] x [BT x H]), in one launch.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_dw_kernel_blocked
// (_dw_call_blocked), which keeps one [H, 3*128] block of both gradients
// resident over a sequential T loop.  Here:
//
// - compact_rows_kernel (lstm_common.cuh, one CTA) lists the valid rows
//   (mask != 0) in row order.  A padded step's dg and dc_pre are exact
//   zeros (the backward's masked split), so leaving those rows out
//   changes no sum.
// - gru_dw_blocked_kernel: a CTA per (128 x 128 output tile of either
//   gradient, split of the row list; dw_tile_wg of dw_wg.cuh), the listed
//   rows streamed in chunks of 64 and multiplied on the tensor cores:
//   h_{t-1} from the kept sequence H (h0 at t = 0), r * h_{t-1} from the
//   rh that gru_bwd_blocked.cu wrote, dg and dc_pre from its dxw.  Both
//   gradients live in one buffer, dW_gates [H, 2H] then dW_cand [H, H].
// - With n_split > 1 (the launcher splits the rows when the tiles would
//   leave the last round of co-resident CTAs mostly idle: at H 1024, 192
//   tiles on 132 slots, 2 splits), each split writes its sums to scratch
//   and reduce_splits_kernel adds them in split order.
//
// No atomics: the same bits on every run.  The f32 operands go to the
// bf16 tensor cores as hi + lo, three passes (dw_wg.cuh; TF32 would
// change the numbers).
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 3H flops in
// three bf16 passes, 73.3 us at B 128, T 30, H 1024 with every step valid
// (360.6 us at the fp32 rate).
#include "dw_wg.cuh"

using namespace lstm;

__host__ __device__ inline int gru_dw_tiles(int H, int* n_g) {
  const int nkt = (H + dwg::kTile - 1) / dwg::kTile;
  *n_g = nkt * ((2 * H + dwg::kTile - 1) / dwg::kTile);
  return *n_g + nkt * ((H + dwg::kTile - 1) / dwg::kTile);
}

// kVec: H % 4 == 0, every row 16-byte aligned (dw_tile_wg)
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) gru_dw_blocked_kernel(
    const float* __restrict__ hseq, const float* __restrict__ h0,
    const float* __restrict__ rh, const float* __restrict__ dxw,
    const int* __restrict__ rows, float* out, int B, int T, int H,
    int n_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  const int nkt = (H + dwg::kTile - 1) / dwg::kTile;
  int n_g;
  const int n_tiles = gru_dw_tiles(H, &n_g);
  const int tile = blockIdx.x % n_tiles, split = blockIdx.x / n_tiles;
  const int n = rows[B * T];  // valid rows
  const long H3 = 3L * H;
  float* dw_g = out + (long)split * H * H3;  // [H, 2H], then dW_cand
  float* dw_c = dw_g + 2L * H * H;          // [H, H]
  auto hrow = [&](int j) -> const float* {   // h_{t-1} of listed row j
    const int row = __ldg(rows + j);
    return row % T ? hseq + (long)(row - 1) * H : h0 + (long)(row / T) * H;
  };
  auto rhrow = [&](int j) -> const float* {
    return rh + (long)__ldg(rows + j) * H;
  };
  auto grow = [&](int j) -> const float* {   // dg of listed row j
    return dxw + __ldg(rows + j) * H3;
  };
  auto crow = [&](int j) -> const float* {   // dc_pre of listed row j
    return dxw + __ldg(rows + j) * H3 + 2 * H;
  };
  if (tile < n_g)
    dw_tile_wg<kVec>(hrow, grow, n, split, n_split, H, 2 * H,
                     (tile % nkt) * dwg::kTile, (tile / nkt) * dwg::kTile,
                     dw_g, 2 * H, smem, h0);
  else
    dw_tile_wg<kVec>(rhrow, crow, n, split, n_split, H, H,
                     ((tile - n_g) % nkt) * dwg::kTile,
                     ((tile - n_g) / nkt) * dwg::kTile, dw_c, H, smem, h0);
}

// Splits of the row list for (B, T, H) on the current card (0 on a CUDA
// error).
extern "C" int gru_dw_blocked_splits(int B, int T, int H) {
  int n_g;
  return dw_blocked_splits(gru_dw_blocked_kernel<true>,
                           gru_dw_tiles(H, &n_g));
}

// dw: [H, 3H] floats, dW_gates [H, 2H] then dW_cand [H, H]; part: n_split
// x [H, 3H] scratch (unused when n_split == 1); rows: B*T + 1 ints of
// scratch.
extern "C" int gru_dw_blocked(const float* hseq, const float* h0,
                              const float* rh, const float* dxw,
                              const float* mask, int* rows, float* part,
                              float* dw, int B, int T, int H, int n_split,
                              cudaStream_t stream) {
  if (n_split < 1 || n_split > dwg::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  auto kernel = H % 4 == 0 ? gru_dw_blocked_kernel<true>
                           : gru_dw_blocked_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dwg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  compact_rows_kernel<<<1, kCompactThreads, 0, stream>>>(mask, B * T, rows);
  int n_g;
  const int n_tiles = gru_dw_tiles(H, &n_g);
  kernel<<<n_tiles * n_split, kThreads, dwg::kSmemBytes, stream>>>(
      hseq, h0, rh, dxw, rows, n_split == 1 ? dw : part, B, T, H, n_split);
  if (n_split > 1)
    reduce_splits_kernel<<<1024, 256, 0, stream>>>(part, n_split,
                                                   3L * H * H, dw);
  return (int)cudaGetLastError();
}
