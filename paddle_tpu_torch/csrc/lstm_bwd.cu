// Fused LSTM backward (BPTT): the whole reversed time loop in one launch,
// for H <= 512.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_bwd_kernel (_bwd_call): dh/dc
// carries on chip, dW_hh and the peephole grads accumulated over T, dxw
// per step, dh0/dc0 at the end -- all in this one launch.  The kernel is
// lstm_wg.cuh's backward (lstm_bwd_wg_kernel, shared with kernel 11, the
// blocked tier's BPTT) with its kDw part:
//
// - The recurrent pull-back dh_prev = dgates_t @ w_hh^T runs on the
//   header's tensor-core step product: w_hh's bf16 hi/lo planes written
//   in a prologue, each step's dgates planes written by phase A in
//   compacted row order, tiles of 128 compacted rows x 128 units x one K
//   slice (K = 4H: at H 512, 32 chunks of 64, 4 unit blocks), their sums
//   added by slice in order by the (row, unit) pairs.
// - The peephole grads: each pair sums its products (di c_prev, df c_prev,
//   do c) over the steps in its own thread, in step order (ckp, [3, B,
//   H]); after the loop, dchecks adds the rows in ascending order.  No
//   atomics.
// - dW_hh = sum over the valid (b, t) of h_{t-1}[b]^T dgates_t[b] runs
//   after the loop's last barrier on dw_wg.cuh's tensor-core tile
//   (kernels 12 and 17's), over the valid rows that phase A lists (by
//   descending t, then rank: a padded step's dgates are exact zeros), its
//   128 x 128 output tiles x n_split splits of the list spread over the
//   grid; with n_split > 1 the splits are added in split order after one
//   more barrier.
//
// A persistent cooperative grid of one CTA an SM, two warpgroups (the dW
// tile's; its 64 + 64 accumulators a thread leave no room for a third).
// Every sum runs in a fixed order: two runs give the same bits.  The
// products are three bf16 passes of the f32 operands' hi and lo parts,
// each 64-deep chunk drained into f32.
//
// Bound on this card: operations.  Two products (the pull-back and dW_hh),
// 2 * 2 * (valid row-steps) * H * 4H flops: at B 128, T 100 (the bench
// feed's lengths, 9406 valid row-steps) and H 512, 39.45 GFLOP, three bf16
// passes at 989 TFLOP/s: 119.7 us (0.59 ms at the fp32 rate).
#include "lstm_wg.cuh"

using namespace lstm;

// Scratch: dhp, dcc [B, H]; ckp [3, B, H]; part [n_slices, B, H]; rank
// T*B + T ints; rows B*T ints; wpl [2, H, Kp] and apl [2, B, Kp] bf16, Kp
// = 4H rounded up to 64; dw_part [n_split, H, 4H] (unused when n_split
// is 1).  n_slices cuts the ceil(4H / 64) chunks of K into slices of
// ceil(chunks / n_slices), none empty; n_split in 1 .. dwg::kMaxSplit.
extern "C" int lstm_bwd(const float* gates, const float* hseq,
                        const float* cseq, const float* h0, const float* c0,
                        const float* mask, const float* w_hh,
                        const float* checks, const float* dy, const float* dyc,
                        float* dxw, float* dw, float* dchecks, float* dh0,
                        float* dc0, float* dhp, float* dcc, float* ckp,
                        float* part, int* rank, int* rows, void* wpl,
                        void* apl, float* dw_part, int B, int T, int H,
                        int n_slices, int n_split, cudaStream_t stream) {
  if (n_split < 1 || n_split > dwg::kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{gates, cseq, c0,   mask, checks,
                  dy,    dyc,  dxw,  dhp,  dcc,
                  part,  rank, static_cast<__nv_bfloat16*>(apl),
                  B,     T,    H,    round_up(4 * H, lwg::kChunk)};
  const DwArgs d{hseq, h0, dw, dchecks, ckp, rows, dw_part, n_split};
  // two warpgroups: the dW tile's CTA
  return launch_bwd<kThreads, true>(a, w_hh, static_cast<__nv_bfloat16*>(wpl),
                                    dh0, dc0, n_slices, d, stream);
}
