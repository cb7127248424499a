// Hidden-blocked GRU backward (BPTT without dW), for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_bwd_kernel_blocked
// (_bwd_call_blocked): the reversed time loop with the dh carry, writing
// dxw = (du_pre | dr_pre | dc_pre) every step and dh0 at the end.  The
// TPU kernel runs two phases a step over its hidden blocks: phase A forms
// du_pre, dc_pre and accumulates drh = sum_j dc_pre_j @ w_cand_j^T; phase
// B, which needs that whole sum, forms dr_pre and accumulates the gate
// pull-back into the next carry.  dW_gates and dW_cand are
// gru_dw_blocked.cu's products over the dxw this kernel writes; the r *
// h_{t-1} that dW_cand needs is written here too (rh [B, T, H]).
//
// The kernel is gru_wg.cuh's BPTT on the tensor-core step loop
// (gru_bwd_wg_kernel<384, false, false>, shared with kernel 14): both
// step products on wgmma + TMA over bf16 hi/lo planes the kernel writes
// itself, each step's in compacted row order, four grid barriers a step;
// three warpgroups a CTA, the third only on the pairs.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 3H flops in
// three bf16 passes: 73.3 us at B 128, T 30, H 1024 with every step valid
// (360.6 us at the fp32 rate).
#include "gru_wg.cuh"

using namespace lstm;

// Scratch: dhl, drr [B, H]; part [max(s_cand, s_gates), B, H]; rank T*B
// + T ints; wcpl [2, H, Kc] and cpl [2, B, Kc] bf16 (w_cand's and dc_pre's
// planes, Kc = H rounded up to 64); wgpl [2, H, Kg] and gpl [2, B, Kg]
// (w_gates' and dg's, Kg = 2H rounded up to 64).  s_cand and s_gates cut
// the chunks of K = H and K = 2H into slices of ceil(chunks / slices),
// none empty.  0, a cudaError_t, or -1 (launch_resident).
extern "C" int gru_bwd_blocked(const float* gates, const float* hseq,
                               const float* h0, const float* mask,
                               const float* w_gates, const float* w_cand,
                               const float* dy, float* dxw, float* dh0,
                               float* rh, float* dhl, float* drr, float* part,
                               int* rank, void* wcpl, void* wgpl, void* cpl,
                               void* gpl, int B, int T, int H, int s_cand,
                               int s_gates, cudaStream_t stream) {
  const GruBwdArgs a{gates, hseq, h0,   mask, dy, dxw, rh, dhl, drr, part,
                     rank,  static_cast<__nv_bfloat16*>(cpl),
                     static_cast<__nv_bfloat16*>(gpl),
                     B,     T,    H,    round_up(H, lwg::kChunk),
                     round_up(2 * H, lwg::kChunk)};
  const GruDwArgs none{nullptr, nullptr, nullptr, nullptr, 1};
  return launch_gru_bwd<384, false>(
      a, w_gates, w_cand, static_cast<__nv_bfloat16*>(wcpl),
      static_cast<__nv_bfloat16*>(wgpl), dh0, s_cand, s_gates, none, stream);
}
