// Hidden-blocked LSTM weight gradient: dW_hh = sum over the valid (b, t)
// of h_{t-1}[b]^T dgates_t[b], an [H x BT] x [BT x 4H] product.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_dw_kernel_blocked
// (_dw_call_blocked), which keeps one [H, 4*128] dW block resident over
// a sequential T loop.  Here:
//
// - compact_rows_kernel (lstm_common.cuh, one CTA) lists the valid rows
//   (mask != 0) in row order.  A padded step's dgates are exact zeros
//   (the backward's masked split), so leaving those rows out changes no
//   sum; at the bench feed it drops 27 % of the rows.
// - lstm_dw_blocked_kernel: a CTA per (128 x 128 output tile, split of
//   the row list; dw_tile_wg of dw_wg.cuh, shared with gru_dw_blocked.cu),
//   the listed rows streamed in chunks of 64 and multiplied on the tensor
//   cores: h_{t-1} from the kept sequence H (h0 at t = 0), dgates from the
//   dxw that lstm_bwd_blocked.cu wrote.
// - With n_split > 1 (the launcher splits the rows when the tiles would
//   leave the last round of co-resident CTAs mostly idle: at H 1280, 400
//   tiles on 132 slots, 4 splits), each split writes its sums to scratch
//   and reduce_splits_kernel adds them in split order.
//
// No atomics: the same bits on every run.  The f32 operands go to the
// bf16 tensor cores as hi + lo, three passes (dw_wg.cuh; TF32 would
// change the numbers).
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H flops in
// three bf16 passes, 374.0 us at the bench feed (9406 valid row-steps)
// and H = 1280 (1.84 ms at the fp32 rate).
#include "dw_wg.cuh"

using namespace lstm;

__host__ __device__ inline int lstm_dw_tiles(int H) {
  return ((H + dwg::kTile - 1) / dwg::kTile) *
         ((4 * H + dwg::kTile - 1) / dwg::kTile);
}

// kVec: H % 4 == 0, every row 16-byte aligned (dw_tile_wg)
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_dw_blocked_kernel(const float* __restrict__ hseq,
                           const float* __restrict__ h0,
                           const float* __restrict__ dxw,
                           const int* __restrict__ rows, float* out, int B,
                           int T, int H, int n_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  const int nkt = (H + dwg::kTile - 1) / dwg::kTile;
  const int n_tiles = lstm_dw_tiles(H);
  const int tile = blockIdx.x % n_tiles, split = blockIdx.x / n_tiles;
  auto hrow = [&](int j) -> const float* {   // h_{t-1} of listed row j
    const int row = __ldg(rows + j);
    return row % T ? hseq + (long)(row - 1) * H : h0 + (long)(row / T) * H;
  };
  auto grow = [&](int j) -> const float* {   // dgates_t of listed row j
    return dxw + (long)__ldg(rows + j) * 4 * H;
  };
  dw_tile_wg<kVec>(hrow, grow, rows[B * T], split, n_split, H, 4 * H,
                   (tile % nkt) * dwg::kTile, (tile / nkt) * dwg::kTile,
                   out + (long)split * H * 4 * H, 4 * H, smem, h0);
}

// Splits of the row list for (B, T, H) on the current card (0 on a CUDA
// error).
extern "C" int lstm_dw_blocked_splits(int B, int T, int H) {
  return dw_blocked_splits(lstm_dw_blocked_kernel<true>, lstm_dw_tiles(H));
}

// part: n_split x [H, 4H] scratch (unused when n_split == 1); rows: B*T + 1
// ints of scratch.
extern "C" int lstm_dw_blocked(const float* hseq, const float* h0,
                               const float* dxw, const float* mask, int* rows,
                               float* part, float* dw, int B, int T, int H,
                               int n_split, cudaStream_t stream) {
  if (n_split < 1 || n_split > dwg::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  auto kernel = H % 4 == 0 ? lstm_dw_blocked_kernel<true>
                           : lstm_dw_blocked_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dwg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  compact_rows_kernel<<<1, kCompactThreads, 0, stream>>>(mask, B * T, rows);
  kernel<<<lstm_dw_tiles(H) * n_split, kThreads, dwg::kSmemBytes, stream>>>(
      hseq, h0, dxw, rows, n_split == 1 ? dw : part, B, T, H, n_split);
  if (n_split > 1)
    reduce_splits_kernel<<<1024, 256, 0, stream>>>(part, n_split,
                                                   (long)H * 4 * H, dw);
  return (int)cudaGetLastError();
}
