// Hidden-blocked LSTM backward (BPTT without dW), for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_bwd_kernel_blocked
// (_bwd_call_blocked): the reversed time loop with the dh/dc carries,
// writing dxw (= dgates) every step and dh0/dc0 at the end.  dW_hh is
// lstm_dw_blocked.cu's product over the dxw this kernel writes, and the
// peephole grads are reductions over dxw in the wrapper, as in the TPU
// tier.
//
// The one cross-unit coupling is the recurrent pull-back
// dh_prev = dgates_t @ w_hh^T, [B, 4H] x [4H, H].  The TPU kernel
// accumulates it over its sequential block loop.  Here every step's
// dgates_t is published in dxw, and the pull-back is cut by gate: a tile
// of 128 batch rows x U hidden units x one gate g sums over that gate's
// H columns only, dgates_t[rows, gH:(g+1)H] against w_hh[units,
// gH:(g+1)H] (both contiguous in k), into part[g] ([4, B, H] scratch).
// After a grid barrier each (row, unit) pair adds its four parts in gate
// order — a fixed order, no atomics.  Only the rows valid at step t
// enter the product (valid_tile_rows, product_rows): a padded step's
// dgates are exact zeros, so its pull-back is 0 and its row adds no
// part.  At B 128, H 1280 (U = 40) that is 128 tiles each reading at
// most 655 + 205 KB, 110 MB of L2 reads a step plus 2.6 MB of parts
// written and read; tiles that each summed all 4H columns for their
// units would read 1.47 MB apiece or more (188 MB a step), and per-CTA
// partials over hidden slices would move (slices) x 655 KB a step (84 MB
// at 128 slices, more than the 50 MB L2, and again to reduce).
//
// A persistent cooperative grid walks the tiles with its stride, then
// the (row, unit) pairs with its thread stride:
//
//   prologue: phase A of step T-1 for every pair (zero carries); barrier
//   for t = T-1 .. 0:
//     per tile: part[g] = pull-back of dgates_t over gate g's columns
//     barrier
//     per pair: dh = (1-m) dh_tot (step t) + part[0..3] (valid rows);
//               t > 0: phase A of step t-1 with carries (dh, dc) —
//               dgates_{t-1} into dxw, the new dc and (1-m) dh_tot into
//               scratch; t = 0: dh0, dc0
//     barrier
//
// Phase A is the TPU kernel's gate-derivative arithmetic: the external
// dy/dyc join the carries before the masked split, peepholes i, f on
// c_prev and o on c.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H FMAs,
// 1.84 ms at the bench feed and H = 1280.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

struct BwdArgs {
  const float* gates;
  const float* cseq;
  const float* c0;
  const float* mask;
  const float* checks;
  const float* dy;
  const float* dyc;
  float* dxw;
  float* dhp;   // [B, H] (1-m) * dh_tot of the last phase A
  float* dcc;   // [B, H] dc carry
  float* part;  // [4, B, H] the pull-back by gate
  int B, T, H;
};

// Step s for (b, unit) with incoming carries dh_c, dc_c.
__device__ __forceinline__ void phase_a(const BwdArgs& a, int s, int b,
                                        int unit, float dh_c, float dc_c) {
  const int H = a.H;
  const long TH = (long)a.T * H;
  const long o_s = b * TH + (long)s * H + unit;
  const long o_g = 4 * b * TH + (long)s * 4 * H + unit;
  const float gi = a.gates[o_g], gf = a.gates[o_g + H];
  const float gg = a.gates[o_g + 2 * H], go = a.gates[o_g + 3 * H];
  const float c_prev = s > 0 ? a.cseq[o_s - H] : a.c0[(long)b * H + unit];
  const float c = a.cseq[o_s];
  const float m = a.mask[(long)b * a.T + s];
  const float tanh_c = tanhf(c);
  const float dh_tot = a.dy[o_s] + dh_c;
  const float dc_tot = a.dyc[o_s] + dc_c;
  const float dh = m * dh_tot;
  const float do_pre = dh * tanh_c * go * (1.f - go);
  const float dc = m * dc_tot + dh * go * (1.f - tanh_c * tanh_c) +
                   do_pre * a.checks[2 * H + unit];
  const float di_pre = dc * gg * gi * (1.f - gi);
  const float df_pre = dc * c_prev * gf * (1.f - gf);
  const float dg_pre = dc * gi * (1.f - gg * gg);
  a.dxw[o_g] = di_pre;
  a.dxw[o_g + H] = df_pre;
  a.dxw[o_g + 2 * H] = dg_pre;
  a.dxw[o_g + 3 * H] = do_pre;
  const long o_c = (long)b * H + unit;
  a.dcc[o_c] = (1.f - m) * dc_tot + dc * gf + di_pre * a.checks[unit] +
               df_pre * a.checks[H + unit];
  a.dhp[o_c] = (1.f - m) * dh_tot;
}

template <class Tl>
__global__ void __launch_bounds__(kBThreads, 1)
    lstm_bwd_blocked_kernel(BwdArgs a, const float* __restrict__ w_hh,
                            float* dh0, float* dc0) {
  constexpr int U = Tl::COLS;  // hidden units per tile
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  __shared__ int rows_s[kBRows], pos_s[kBRows];
  const int tid = threadIdx.x, B = a.B, T = a.T, H = a.H;
  const int n_rt = (B + kBRows - 1) / kBRows, n_ut = (H + U - 1) / U;
  const int n_tiles = 4 * n_rt * n_ut;
  const long T4H = 4L * T * H, BH = (long)B * H;
  const long first = (long)blockIdx.x * kBThreads + tid;
  const long stride = (long)gridDim.x * kBThreads;
  const bool vec = H % 4 == 0;  // gate column blocks start 16-byte aligned

  for (long p = first; p < BH; p += stride)
    phase_a(a, T - 1, (int)(p / H), (int)(p % H), 0.f, 0.f);
  grid.sync();
  for (int t = T - 1; t >= 0; --t) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int g = tile % 4, rest = tile / 4;
      const int r0 = (rest % n_rt) * kBRows, u0 = (rest / n_rt) * U;
      const int n = valid_tile_rows(a.mask, B, T, t, r0, rows_s, pos_s);
      if (n == 0) continue;
      auto arow = [&](int r) -> const float* {   // dgates_t, gate g,
        if (r >= n) return nullptr;              // r-th valid row
        return a.dxw + rows_s[r] * T4H + (long)t * 4 * H + (long)g * H;
      };
      auto brow = [&](int c) -> const float* {   // w_hh, gate g, unit u0+c
        const int unit = u0 + c;
        return unit < H ? w_hh + (long)unit * 4 * H + (long)g * H : nullptr;
      };
      product_rows<Tl>(arow, brow, H, vec, w_hh, stages, n);
      for (int idx = tid; idx < n * U; idx += kBThreads) {
        const int r = idx / U, u = idx % U;
        const int unit = u0 + u;
        if (unit < H)
          a.part[g * BH + (long)rows_s[r] * H + unit] =
              red_sum_nt<Tl>(stages, r, u);
      }
    }
    grid.sync();
    for (long p = first; p < BH; p += stride) {
      const int b = (int)(p / H), unit = (int)(p % H);
      float dh = __ldcg(a.dhp + p);
      if (a.mask[(long)b * T + t] != 0.f) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dh += __ldcg(a.part + g * BH + p);
      }
      const float dc = __ldcg(a.dcc + p);
      if (t > 0) {
        phase_a(a, t - 1, b, unit, dh, dc);
      } else {
        dh0[p] = dh;
        dc0[p] = dc;
      }
    }
    if (t > 0) grid.sync();
  }
}

namespace {

// Resident CTAs and tile count of one tile width at (B, H).
template <class Tl>
struct BwdPlan {
  long resident, n_tiles;
  BwdPlan(int B, int H)
      : resident(resident_ctas(lstm_bwd_blocked_kernel<Tl>, Tl::smem_floats)),
        n_tiles(4L * ((B + kBRows - 1) / kBRows) *
                ((H + Tl::COLS - 1) / Tl::COLS)) {}
  long cost() const { return tile_cost(n_tiles, resident, Tl::COLS); }
  int launch(void** args, cudaStream_t stream) const {
    return launch_tiles(lstm_bwd_blocked_kernel<Tl>, n_tiles, resident,
                        Tl::smem_floats, args, stream);
  }
};

}  // namespace

extern "C" int lstm_bwd_blocked(const float* gates, const float* cseq,
                                const float* c0, const float* mask,
                                const float* w_hh, const float* checks,
                                const float* dy, const float* dyc, float* dxw,
                                float* dh0, float* dc0, float* dhp,
                                float* dcc, float* part, int B, int T, int H,
                                cudaStream_t stream) {
  BwdArgs a{gates, cseq, c0,  mask, checks, dy, dyc,
            dxw,   dhp,  dcc, part, B,      T,  H};
  void* args[] = {&a, &w_hh, &dh0, &dc0};
  const BwdPlan<Tile40> p40(B, H);
  const BwdPlan<Tile64> p64(B, H);
  // the wider tile when as cheap: fewer tiles read dgates_t fewer times
  return p64.cost() <= p40.cost() ? p64.launch(args, stream)
                                  : p40.launch(args, stream);
}
