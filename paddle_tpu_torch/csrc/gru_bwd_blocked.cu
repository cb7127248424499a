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
// h_{t-1} that dW_cand needs is written here too (rh [B, T, H]), where r
// and h_{t-1} are read anyway, instead of recovered from the residue in a
// separate pass (pallas_gru.py:519-523).
//
// The two cross-unit couplings are the products drh = dc_pre_t @ w_cand^T
// ([B, H] x [H, H]) and dg_t @ w_gates^T ([B, 2H] x [2H, H]).  Both are
// cut, as in the forward, into tiles of 128 batch rows x U hidden units
// (U in {8, 16}, chosen as the forward chooses it), each tile summing its
// units' rows of the weight against the published dxw_t rows, both
// operands streamed from L2 (product_nt: w_cand and w_gates rows are
// contiguous in k as they are).  A persistent cooperative grid walks the
// tiles with its stride:
//
//   prologue: phase A of step T-1 for every (row, unit) (zero carry)
//   barrier
//   for t = T-1 .. 0:
//     per tile: drh = dc_pre_t @ w_cand^T for its units; dr_pre = drh
//               h_{t-1} r (1 - r) into dxw_t; drh r and r h_{t-1} kept
//     barrier
//     per tile: dh_{t-1} = dg_t @ w_gates^T + drh r + dh_new u + (1 - m)
//               dh_tot for its units; t > 0: phase A of step t-1 for the
//               same (row, unit) pairs with that carry; t = 0: dh0
//     barrier (t > 0)
//
// Two barriers a step: phase A (the elementwise du_pre, dc_pre, and the
// local share (1 - m) dh_tot + dh_new u) runs in the tail of the previous
// step's carry phase, on the pairs whose carry it just formed.  Phase A is
// the TPU kernel's arithmetic: dy joins the carry before the masked split.
// Only the rows valid at step t enter the products: a padded step's dg and
// dc_pre are exact zeros (its residue is 0, and dh_new = 0), so its
// products are 0 and its carry passes through as (1 - m) dh_tot.
//
// Bound on this card: operations, 2 * (valid row-steps) * 3H * H FMAs,
// 360.6 us at B 128, T 30, H 1024 with every step valid.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

struct BwdArgs {
  const float* gates;
  const float* hseq;
  const float* h0;
  const float* mask;
  const float* dy;
  float* dxw;
  float* rh;   // [B, T, H] r * h_{t-1}, for dW_cand
  float* dhl;  // [B, H] (1 - m) dh_tot + dh_new u of the current step
  float* drr;  // [B, H] drh * r of the current step
  int B, T, H;
};

__device__ __forceinline__ float h_prev_of(const BwdArgs& a, int s, int b,
                                           int unit) {
  return s > 0 ? a.hseq[b * (long)a.T * a.H + (long)(s - 1) * a.H + unit]
               : a.h0[(long)b * a.H + unit];
}

// Phase A of step s for (b, unit) with incoming carry dh_c.
__device__ __forceinline__ void phase_a(const BwdArgs& a, int s, int b,
                                        int unit, float dh_c) {
  const int H = a.H;
  const long o_s = b * (long)a.T * H + (long)s * H + unit;
  const long o_g = 3 * b * (long)a.T * H + (long)s * 3 * H + unit;
  const float uu = a.gates[o_g], cc = a.gates[o_g + 2 * H];
  const float h_prev = h_prev_of(a, s, b, unit);
  const float m = a.mask[(long)b * a.T + s];
  const float dh_tot = a.dy[o_s] + dh_c;
  const float dh_new = m * dh_tot;
  a.dxw[o_g] = dh_new * (h_prev - cc) * uu * (1.f - uu);
  a.dxw[o_g + 2 * H] = dh_new * (1.f - uu) * (1.f - cc * cc);
  a.dhl[(long)b * H + unit] = (1.f - m) * dh_tot + dh_new * uu;
}

template <int U>
__global__ void __launch_bounds__(kBThreads, 1)
    gru_bwd_blocked_kernel(BwdArgs a, const float* __restrict__ w_gates,
                           const float* __restrict__ w_cand, float* dh0) {
  using Tl = typename GruTile<U>::Units;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  __shared__ int rows_s[kBRows], pos_s[kBRows];
  const int tid = threadIdx.x, B = a.B, T = a.T, H = a.H;
  const int n_rt = (B + kBRows - 1) / kBRows, n_ut = (H + U - 1) / U;
  const int n_tiles = n_rt * n_ut;
  const long TH = (long)T * H, T3H = 3 * TH, BH = (long)B * H;
  const bool vec = H % 4 == 0;  // dxw blocks, w rows: 16-byte aligned

  for (long p = (long)blockIdx.x * kBThreads + tid; p < BH;
       p += (long)gridDim.x * kBThreads)
    phase_a(a, T - 1, (int)(p / H), (int)(p % H), 0.f);
  grid.sync();
  for (int t = T - 1; t >= 0; --t) {
    // ---- drh = dc_pre_t @ w_cand^T, dr_pre
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = (tile % n_rt) * kBRows, u0 = (tile / n_rt) * U;
      const int n = valid_tile_rows(a.mask, B, T, t, r0, rows_s, pos_s);
      auto arow = [&](int r) -> const float* {   // dc_pre_t, r-th valid row
        return r < n ? a.dxw + rows_s[r] * T3H + (long)t * 3 * H + 2 * H
                     : nullptr;
      };
      auto brow = [&](int c) -> const float* {   // w_cand row u0 + c
        const int unit = u0 + c;
        return unit < H ? w_cand + (long)unit * H : nullptr;
      };
      if (n > 0) product_rows<Tl>(arow, brow, H, vec, w_cand, stages, n);
      for (int idx = tid; idx < kBRows * U; idx += kBThreads) {
        const int r = idx / U, u = idx % U;
        const int b = r0 + r, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const long o_g = b * T3H + (long)t * 3 * H + unit;
        const float rr = a.gates[o_g + H];
        const float h_prev = h_prev_of(a, t, b, unit);
        const int p = pos_s[r];
        const float drh = p >= 0 ? red_sum_nt<Tl>(stages, p, u) : 0.f;
        a.dxw[o_g + H] = drh * h_prev * rr * (1.f - rr);
        a.drr[(long)b * H + unit] = drh * rr;
        a.rh[b * TH + (long)t * H + unit] = rr * h_prev;
      }
    }
    grid.sync();
    // ---- dh_{t-1} = dg_t @ w_gates^T + the local share; phase A of t-1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = (tile % n_rt) * kBRows, u0 = (tile / n_rt) * U;
      const int n = valid_tile_rows(a.mask, B, T, t, r0, rows_s, pos_s);
      auto arow = [&](int r) -> const float* {   // dg_t, r-th valid row
        return r < n ? a.dxw + rows_s[r] * T3H + (long)t * 3 * H : nullptr;
      };
      auto brow = [&](int c) -> const float* {   // w_gates row u0 + c
        const int unit = u0 + c;
        return unit < H ? w_gates + (long)unit * 2 * H : nullptr;
      };
      if (n > 0)
        product_rows<Tl>(arow, brow, 2 * H, vec, w_gates, stages, n);
      for (int idx = tid; idx < kBRows * U; idx += kBThreads) {
        const int r = idx / U, u = idx % U;
        const int b = r0 + r, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const long o_c = (long)b * H + unit;
        const int p = pos_s[r];
        float dh = __ldcg(a.dhl + o_c);
        if (p >= 0) dh += __ldcg(a.drr + o_c) + red_sum_nt<Tl>(stages, p, u);
        if (t > 0)
          phase_a(a, t - 1, b, unit, dh);
        else
          dh0[o_c] = dh;
      }
    }
    if (t > 0) grid.sync();
  }
}

namespace {

// Resident CTAs and tile count of one tile width at (B, H).
template <int U>
struct BwdPlan {
  static constexpr long smem_floats = GruTile<U>::Units::smem_floats;
  long resident, n_tiles;
  BwdPlan(int B, int H)
      : resident(resident_ctas(gru_bwd_blocked_kernel<U>, smem_floats)),
        n_tiles((long)((B + kBRows - 1) / kBRows) * ((H + U - 1) / U)) {}
  long cost() const { return tile_cost(n_tiles, resident, U); }
  int launch(void** args, cudaStream_t stream) const {
    return launch_tiles(gru_bwd_blocked_kernel<U>, n_tiles, resident,
                        smem_floats, args, stream);
  }
};

}  // namespace

// rh: [B, T, H] output (r * h_{t-1}); dhl, drr: [B, H] scratch.
extern "C" int gru_bwd_blocked(const float* gates, const float* hseq,
                               const float* h0, const float* mask,
                               const float* w_gates, const float* w_cand,
                               const float* dy, float* dxw, float* dh0,
                               float* rh, float* dhl, float* drr, int B,
                               int T, int H, cudaStream_t stream) {
  BwdArgs a{gates, hseq, h0, mask, dy, dxw, rh, dhl, drr, B, T, H};
  void* args[] = {&a, &w_gates, &w_cand, &dh0};
  const BwdPlan<8> p8(B, H);
  const BwdPlan<16> p16(B, H);
  // the wider tile when as cheap: fewer tiles read dxw_t fewer times
  return p16.cost() <= p8.cost() ? p16.launch(args, stream)
                                 : p8.launch(args, stream);
}
