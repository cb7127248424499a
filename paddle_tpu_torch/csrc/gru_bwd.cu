// Fused GRU backward (BPTT): the whole reversed time loop in one launch.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_bwd_kernel (_bwd_call): the dh
// carry on chip, dW_gates and dW_cand accumulated over T, dxw per step,
// dh0 at the end.  Same persistent cooperative grid as gru_fwd.cu: CTA x
// owns hidden units [x*U, x*U + U), and keeps its own ROWS of the two
// recurrent weights (w_cand[own, :], w_gates[own, :]; 24 KB at H = 512)
// in shared memory, laid out as the [K, U] operand of row_product.  Per
// step t (descending):
//
// - Phase A, local to the CTA's units: dy joins the carry before the
//   masked split; du_pre and dc_pre (written into dxw_t), the local
//   share of dh_prev ((1 - m) dh_tot + dh' u), and r * h_{t-1} into the
//   scratch rh [B, T, H] for dW_cand.  Grid barrier.
// - Phase B: drh[b, own] = dc_pre_t @ w_cand[own, :]^T (row_product over
//   dxw_t's c block, all CTAs' units, from L2); dr_pre = drh h r (1 - r)
//   into dxw_t.  Grid barrier: dh_prev needs all of dg = (du, dr).
// - Phase C: dh_prev[b, own] = local share + drh r + dg_t @
//   w_gates[own, :]^T (row_product over dxw_t's u, r blocks).  No
//   barrier: the next step's phase A writes dxw_{t-1} and reads only the
//   CTA's own carry.
//
// dW_gates = sum over (b, t) of h_{t-1}[b]^T dg_t[b] and dW_cand = sum of
// (r h_{t-1})[b]^T dc_pre_t[b] are [H x BT] x [BT x 2H] and [BT x H]
// products; they run after the time loop, tiled 128 x 64 over all CTAs
// with their rows streamed through a cp.async pipeline (dw_tile of
// lstm_common.cuh), instead of inside the
// latency-bound step.  Each output tile belongs to one CTA and sums its
// rows in a fixed order: no atomics, and two runs give the same bits.
//
// Bound on this card: operations.  Four products of 2*B*T*H*H each in
// units of H columns (dc @ w_cand^T: H, dg @ w_gates^T: 2H, dW_gates: 2H,
// dW_cand: H), 12*B*T*H^2 = 12.1 GFLOP fp32 at B = 128, T = 30, H = 512:
// ~180 us at 67 TFLOP/s.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int U = 4;                     // hidden units per CTA
static_assert(dwt::kStageFloats <= kStages * kTileFloats,
              "the dW chunks alias the step's staging tiles");

__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ hseq,
    const float* __restrict__ h0, const float* __restrict__ mask,
    const float* __restrict__ w_gates, const float* __restrict__ w_cand,
    const float* __restrict__ dy, float* dxw, float* dwg, float* dwc,
    float* dh0, float* rh, int B, int T, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, u0 = blockIdx.x * U, G = gridDim.x;
  const int Hc = round_up(H, kKT), Hg = round_up(2 * H, kKT);
  const bool vec = H % 4 == 0;
  float* wcT = smem;                     // [Hc, U]  w_cand[own, :]^T
  float* wgT = wcT + Hc * U;             // [Hg, U]  w_gates[own, :]^T
  float* tiles = wgT + Hg * U;           // staging tiles, then dW chunks
  float* red = tiles + kStages * kTileFloats;  // [KG, kTileRows, U]
  float* dhc = red + kRedFloats;         // [B, U]   dh carry
  float* dhl = dhc + B * U;              // [B, U]   (1-m) dh_tot + dh' u
  float* drr = dhl + B * U;              // [B, U]   drh * r

  for (int idx = tid; idx < Hc * U; idx += kThreads) {
    const int j = idx / U, unit = u0 + idx % U;
    wcT[idx] = (j < H && unit < H) ? w_cand[(long)unit * H + j] : 0.f;
  }
  for (int idx = tid; idx < Hg * U; idx += kThreads) {
    const int j = idx / U, unit = u0 + idx % U;
    wgT[idx] = (j < 2 * H && unit < H) ? w_gates[(long)unit * 2 * H + j] : 0.f;
  }
  for (int idx = tid; idx < B * U; idx += kThreads) dhc[idx] = 0.f;

  const long TH = (long)T * H, T3H = 3 * TH;
  for (int t = T - 1; t >= 0; --t) {
    // ---- phase A: own units
    __syncthreads();   // the last phase C's carries are written
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, unit = u0 + idx % U;
      if (unit >= H) continue;
      const long o_s = (long)b * TH + (long)t * H + unit;
      const long o_g = (long)b * T3H + (long)t * 3 * H + unit;
      const float uu = gates[o_g], rr = gates[o_g + H];
      const float cc = gates[o_g + 2 * H];
      const float h_prev = t > 0 ? hseq[o_s - H] : h0[(long)b * H + unit];
      const float m = mask[(long)b * T + t];
      const float dh_tot = dy[o_s] + dhc[idx];
      const float dh_new = m * dh_tot;
      dxw[o_g] = dh_new * (h_prev - cc) * uu * (1.f - uu);
      dxw[o_g + 2 * H] = dh_new * (1.f - uu) * (1.f - cc * cc);
      rh[o_s] = rr * h_prev;
      dhl[idx] = (1.f - m) * dh_tot + dh_new * uu;
    }
    grid.sync();
    // ---- phase B: drh = dc_pre_t (all units) @ w_cand[own, :]^T
    const float* dxt = dxw + (long)t * 3 * H;
    for (int r0 = 0; r0 < B; r0 += kTileRows) {
      row_product<U>(dxt + 2 * H, T3H, B, H, wcT, r0, tiles, red, vec);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kTileRows * U / kThreads; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / U, u = idx % U, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const float drh = red_sum<U>(red, idx);
        const long o_g = (long)b * T3H + (long)t * 3 * H + unit;
        const float rr = gates[o_g + H];
        const float h_prev =
            t > 0 ? hseq[(long)b * TH + (long)(t - 1) * H + unit]
                  : h0[(long)b * H + unit];
        dxw[o_g + H] = drh * h_prev * rr * (1.f - rr);
        drr[b * U + u] = drh * rr;
      }
    }
    grid.sync();
    // ---- phase C: dh_prev[b, own] from dg_t = (du, dr) of all units
    for (int r0 = 0; r0 < B; r0 += kTileRows) {
      row_product<U>(dxt, T3H, B, 2 * H, wgT, r0, tiles, red, vec);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kTileRows * U / kThreads; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / U, u = idx % U;
        if (b >= B || u0 + u >= H) continue;
        const int i = b * U + u;
        dhc[i] = dhl[i] + (drr[i] + red_sum<U>(red, idx));
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < B * U; idx += kThreads) {
    const int unit = u0 + idx % U;
    if (unit < H) dh0[(long)(idx / U) * H + unit] = dhc[idx];
  }

  // ---- dW: every dxw and rh row was written before the last grid
  // barrier (phase C writes neither)
  const int R = B * T, nkt = (H + dwt::kGK - 1) / dwt::kGK;
  const int n_g = nkt * ((2 * H + dwt::kGC - 1) / dwt::kGC);
  const int n_tiles = n_g + nkt * ((H + dwt::kGC - 1) / dwt::kGC);
  auto hrow = [&](int row) -> const float* {   // h_{t-1} of row (b, t)
    return row % T ? hseq + (long)(row - 1) * H : h0 + (long)(row / T) * H;
  };
  auto rhrow = [&](int row) -> const float* { return rh + (long)row * H; };
  auto grow = [&](int row) -> const float* { return dxw + (long)row * 3 * H; };
  auto crow = [&](int row) -> const float* {
    return dxw + (long)row * 3 * H + 2 * H;
  };
  for (int tile = blockIdx.x; tile < n_tiles; tile += G) {
    if (tile < n_g)
      dw_tile(hrow, grow, R, H, 2 * H, (tile % nkt) * dwt::kGK,
              (tile / nkt) * dwt::kGC, dwg, 2 * H, tiles, vec, h0);
    else
      dw_tile(rhrow, crow, R, H, H, ((tile - n_g) % nkt) * dwt::kGK,
              ((tile - n_g) / nkt) * dwt::kGC, dwc, H, tiles, vec, h0);
  }
}

extern "C" int gru_bwd(const float* gates, const float* hseq,
                       const float* h0, const float* mask,
                       const float* w_gates, const float* w_cand,
                       const float* dy, float* dxw, float* dwg, float* dwc,
                       float* dh0, float* rh, int B, int T, int H,
                       cudaStream_t stream) {
  void* args[] = {&gates, &hseq, &h0,  &mask, &w_gates, &w_cand, &dy, &dxw,
                  &dwg,   &dwc,  &dh0, &rh,   &B,       &T,      &H};
  const long smem = (long)(round_up(H, kKT) + round_up(2 * H, kKT)) * U +
                    kStages * kTileFloats + kRedFloats + 3L * B * U;
  return cooperative_launch(gru_bwd_kernel, H, U, smem, args, stream);
}
