// Fused GRU backward (BPTT), for H <= 512: the whole reversed time loop
// and both weight gradients in one launch.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_bwd_kernel (_bwd_call): the dh
// carry on chip, dW_gates and dW_cand accumulated over T, dxw per step,
// dh0 at the end.  The kernel is gru_wg.cuh's BPTT on the tensor-core
// step loop (gru_bwd_wg_kernel<256, true, kVec>, shared with kernel 16,
// the blocked tier's BPTT), with its kDw part:
//
// - The step products drh = dc_pre_t @ w_cand^T (K = H) and the carry's
//   dg_t @ w_gates^T (K = 2H) run on lstm_wg.cuh's tiles: the weights'
//   bf16 hi/lo planes written in a prologue, each step's dc_pre and dg
//   planes written by the pairs in compacted row order, tiles of 128
//   compacted rows x 128 units x one K slice (ops.gru.bwd_slices: at B
//   128, H 512 on 132 SMs, drh 4 unit blocks x 8 slices of one chunk, 32
//   tiles, the carry 4 x 16, 64 tiles), their sums added by slice in order
//   by the (row, unit) pairs.  Four grid barriers a step.
// - dW_gates = sum over the valid (b, t) of h_{t-1}[b]^T dg_t[b] and
//   dW_cand = sum of (r h_{t-1})[b]^T dc_pre_t[b] run after the loop's
//   last barrier on dw_wg.cuh's tensor-core tile (kernels 9, 12 and 17's),
//   over the valid rows that phase A lists (a padded step's dg and dc_pre
//   are exact zeros), their 128 x 128 output tiles x n_split splits of the
//   list spread over the grid; with n_split > 1 the splits are added in
//   split order after one more barrier.
//
// A persistent cooperative grid of one CTA an SM, two warpgroups (the dW
// tile's). Every sum runs in a fixed order: two runs give the same bits.
// The products are three bf16 passes of the f32 operands' hi and lo
// parts, each 64-deep chunk drained into f32.
//
// Bound on this card: operations.  Four products of 2 * (valid
// row-steps) * H * H flops in units of H columns (drh: H, the carry: 2H,
// dW_gates: 2H, dW_cand: H), 12 * B * T * H^2 = 12.08 GFLOP at B 128,
// T 30, H 512 with every step valid: three bf16 passes at 989 TFLOP/s,
// 36.6 us (180.3 us at the fp32 rate).
#include "gru_wg.cuh"

using namespace lstm;

// Scratch: rh [B, T, H]; dhl, drr [B, H]; part [max(s_cand, s_gates), B,
// H]; rank T*B + T ints; rows B*T ints; wcpl [2, H, Kc] and cpl [2, B, Kc]
// bf16 (Kc = H rounded up to 64); wgpl [2, H, Kg] and gpl [2, B, Kg] (Kg
// = 2H rounded up to 64); dw_part [n_split, H, 3H] (unused when n_split
// is 1).  s_cand and s_gates cut the chunks of K = H and K = 2H into
// slices of ceil(chunks / slices), none empty; n_split in 1 ..
// dwg::kMaxSplit.  0, a cudaError_t, or -1 (launch_resident).
extern "C" int gru_bwd(const float* gates, const float* hseq,
                       const float* h0, const float* mask,
                       const float* w_gates, const float* w_cand,
                       const float* dy, float* dxw, float* dw_gates,
                       float* dw_cand,
                       float* dh0, float* rh, float* dhl, float* drr,
                       float* part, int* rank, int* rows, void* wcpl,
                       void* wgpl, void* cpl, void* gpl, float* dw_part,
                       int B, int T, int H, int s_cand, int s_gates,
                       int n_split, cudaStream_t stream) {
  if (n_split < 1 || n_split > dwg::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const GruBwdArgs a{gates, hseq, h0,   mask, dy, dxw, rh, dhl, drr, part,
                     rank,  static_cast<__nv_bfloat16*>(cpl),
                     static_cast<__nv_bfloat16*>(gpl),
                     B,     T,    H,    round_up(H, lwg::kChunk),
                     round_up(2 * H, lwg::kChunk)};
  const GruDwArgs d{dw_gates, dw_cand, rows, dw_part, n_split};
  // two warpgroups: the dW tile's CTA
  return launch_gru_bwd<kThreads, true>(
      a, w_gates, w_cand, static_cast<__nv_bfloat16*>(wcpl),
      static_cast<__nv_bfloat16*>(wgpl), dh0, s_cand, s_gates, d, stream);
}
