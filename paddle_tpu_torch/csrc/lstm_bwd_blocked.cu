// Hidden-blocked LSTM backward (BPTT without dW), for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_bwd_kernel_blocked
// (_bwd_call_blocked): the reversed time loop with the dh/dc carries,
// writing dxw (= dgates) every step and dh0/dc0 at the end.  dW_hh is
// lstm_dw_blocked.cu's product over the dxw this kernel writes, and the
// peephole grads are reductions over dxw in the wrapper, as in the TPU
// tier.
//
// The kernel is lstm_wg.cuh's backward (lstm_bwd_wg_kernel, shared with
// kernel 9): the one cross-unit coupling, the recurrent pull-back
// dh_prev = dgates_t @ w_hh^T ([rows, 4H] x [4H, H]), is that header's
// tensor-core step product, C[rows, units] = A[rows, K] B[units, K]^T with
// A = dgates_t's planes (written by phase A in compacted row order) and B
// = w_hh's planes ([H, Kp], written in the prologue), K = 4H.  Tiles of
// 128 compacted rows x 128 units x one K slice (the wrapper picks the
// slices so that the tiles of a 128-row block about fill the co-resident
// CTAs: at B 128, H 1280, 10 unit blocks x 12 slices of 7 chunks, 120
// tiles).  w_hh's planes (26 MB at H 1280) stream from L2: held in shared
// memory they would leave no room for A's ring.
//
// A persistent cooperative grid of one CTA an SM, three warpgroups: the
// third only works on the (row, unit) pairs, whose phase wants threads in
// flight more than registers.  Phase A is the TPU kernel's gate-
// derivative arithmetic: the external dy/dyc join the carries before the
// masked split, peepholes i, f on c_prev and o on c.  What it reads once
// (gates, dy, dyc) and dxw pass L2 with the streaming hint, so they do
// not push out the planes.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H flops in
// three bf16 passes: 374.0 us at the bench feed (9406 valid row-steps)
// and H = 1280 (1.84 ms at the fp32 rate).
#include "lstm_wg.cuh"

using namespace lstm;

// Scratch: dhp, dcc [B, H]; part [n_slices, B, H]; rank T*B + T ints;
// wpl [2, H, Kp] and apl [2, B, Kp] bf16, Kp = 4H rounded up to 64.
// n_slices cuts the ceil(4H / 64) chunks of K into slices of
// ceil(chunks / n_slices), none empty.
extern "C" int lstm_bwd_blocked(const float* gates, const float* cseq,
                                const float* c0, const float* mask,
                                const float* w_hh, const float* checks,
                                const float* dy, const float* dyc, float* dxw,
                                float* dh0, float* dc0, float* dhp,
                                float* dcc, float* part, int* rank,
                                void* wpl, void* apl, int B, int T, int H,
                                int n_slices, cudaStream_t stream) {
  const BwdArgs a{gates, cseq, c0,   mask, checks,
                  dy,    dyc,  dxw,  dhp,  dcc,
                  part,  rank, static_cast<__nv_bfloat16*>(apl),
                  B,     T,    H,    round_up(4 * H, lwg::kChunk)};
  // three warpgroups: the third only works on the pairs
  return launch_bwd<384, false>(a, w_hh, static_cast<__nv_bfloat16*>(wpl),
                                dh0, dc0, n_slices, DwArgs{}, stream);
}
