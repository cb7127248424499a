// The GRU's BPTT on the tensor-core step loop (lstm_wg.cuh): one kernel
// template for kernel 14 (the single-block tier, gru_bwd.cu, H <= 512:
// with dW_gates and dW_cand in the same launch) and kernel 16 (the
// hidden-blocked tier, gru_bwd_blocked.cu: dW is kernel 17's), as kernels
// 9 and 11 share lstm_bwd_wg_kernel.
//
// The reversed time loop with the dh carry (pallas_gru.py's _bwd_kernel
// and _bwd_kernel_blocked) writes dxw = (du_pre | dr_pre | dc_pre) every
// step, dh0 at the end, and the r * h_{t-1} that dW_cand takes (rh [B, T,
// H]), where r and h_{t-1} are read anyway (pallas_gru.py:519-523
// recovers it in a separate pass).  The two cross-unit couplings are the
// products drh = dc_pre_t @ w_cand^T ([rows, H] x [H, H]) and dg_t @
// w_gates^T ([rows, 2H] x [2H, H]), dg = (du_pre | dr_pre).  Both are
// lstm_wg.cuh's tensor-core step product, C[rows, units] = A[rows, K]
// B[units, K]^T, with both operands K-major as they stand: A = dc_pre_t's
// planes (K = H) against B = w_cand's rows, and A = dg_t's planes (K =
// 2H) against B = w_gates' rows.  The kernel writes the bf16 hi/lo planes
// itself: w_cand's and w_gates' once, in a prologue; dc_pre_t's and
// dg_t's each step, at the row's rank among the rows valid at t
// (step_ranks) -- phase A writes dc_pre and dg's du half, the drh pairs
// dg's dr half.  Tiles of 128 compacted rows x 128 units x one K slice
// (the wrapper picks each product's slices: kernel 16's by
// ops.gru.bwd_blocked_slices, at B 128, H 1024 on 132 SMs drh 8 unit
// blocks x 8 slices of 2 chunks, 64 tiles, the carry product 8 x 16
// slices of 2, 128 tiles; kernel 14's by ops.gru.bwd_slices, at H 512 4 x
// 8 and 4 x 16 slices of one chunk) write their sums by slice; the (row,
// unit) pairs add the slices in order.  A persistent cooperative grid of
// one CTA an SM:
//
//   prologue: w_cand's and w_gates' planes; the step ranks; barrier
//             phase A of step T-1 for every pair (zero carry); barrier
//   for t = T-1 .. 0:
//     per tile: part[slice] = dc_pre_t's planes x w_cand^T
//     barrier
//     per pair: drh = the slices' sums (0 at a padded row); dr_pre = drh
//               h_{t-1} r (1 - r) into dxw_t and dg_t's planes; drh r
//               and rh = r h_{t-1} kept
//     barrier
//     per tile: part[slice] = dg_t's planes x w_gates^T
//     barrier
//     per pair: dh_{t-1} = (1 - m) dh_tot + dh_new u, and at a valid row
//               + drh r + the slices' sums; t > 0: phase A of step t-1
//               with that carry; t = 0: dh0
//     barrier (t > 0)
//   kDw (kernel 14): dW_gates = sum over the valid (b, t) of h_{t-1}^T
//             dg_t and dW_cand = sum of rh_t^T dc_pre_t on dw_wg.cuh's
//             tile, over the valid rows phase A lists (by descending t,
//             then rank), 128 x 128 output tiles x n_split splits of the
//             list spread over the grid; with n_split > 1, a barrier and
//             the splits added in split order
//
// Four barriers a step.  Phase A is the TPU kernels' arithmetic: dy joins
// the carry before the masked split.  A padded step's dg and dc_pre are
// exact zeros (dh_new = 0), so its rows enter no product and no dW sum,
// and its carry passes through as (1 - m) dh_tot; a row padded at t but
// valid at t - 1 gets its planes from t - 1's phase A, at its rank there.
// dg's planes are written by two phases (phase A, then the drh pairs),
// each ordered before the tiles that read them by fence.proxy.async.global
// and a grid barrier.  Every sum runs in a fixed order: no atomics, the
// same bits on every run.  The products are three bf16 passes of the f32
// operands' hi and lo parts, each 64-deep chunk drained into f32.
#pragma once

#include "lstm_wg.cuh"

namespace lstm {

struct GruBwdArgs {
  const float* gates;
  const float* hseq;
  const float* h0;
  const float* mask;
  const float* dy;
  float* dxw;
  float* rh;    // [B, T, H] r * h_{t-1}, for dW_cand
  float* dhl;   // [B, H] (1 - m) dh_tot + dh_new u of the current step
  float* drr;   // [B, H] drh * r of the current step
  float* part;  // [S, B, H] a product's sums by K slice, compacted rows
  int* rank;    // [T, B] row b's rank among step t's valid rows (-1
                // padded), then [T] the counts
  __nv_bfloat16* cpl;  // [2, B, Kc] dc_pre planes (hi, lo), compacted
  __nv_bfloat16* gpl;  // [2, B, Kg] dg = (du_pre | dr_pre) planes
  int B, T, H, Kc, Kg;
};

// Kernel 14's weight gradients: rows [B * T] the valid (b, t) rows as b *
// T + t, by descending t, then rank; dw_part [n_split, H, 3H] (dW_gates
// then dW_cand of each split) when n_split > 1.
struct GruDwArgs {
  float* dw_gates;  // [H, 2H]
  float* dw_cand;   // [H, H]
  int* rows;
  float* dw_part;
  int n_split;
};

__device__ __forceinline__ float h_prev_of(const GruBwdArgs& a, int s, int b,
                                           int unit) {
  return s > 0 ? a.hseq[b * (long)a.T * a.H + (long)(s - 1) * a.H + unit]
               : a.h0[(long)b * a.H + unit];
}

// Phase A of step s for (b, unit) with incoming carry dh_c; r is row b's
// rank among step s's valid rows (-1: padded, no planes written).  kDw:
// unit 0 lists a valid row at rows[base + r].
template <bool kDw>
__device__ __forceinline__ void gru_phase_a(const GruBwdArgs& a,
                                            const GruDwArgs& d, int s, int b,
                                            int unit, float dh_c, int r,
                                            int base) {
  const int H = a.H;
  const long o_s = b * (long)a.T * H + (long)s * H + unit;
  const long o_g = 3 * b * (long)a.T * H + (long)s * 3 * H + unit;
  const float uu = __ldcs(a.gates + o_g), cc = __ldcs(a.gates + o_g + 2 * H);
  const float h_prev = h_prev_of(a, s, b, unit);
  const float m = a.mask[(long)b * a.T + s];
  const float dh_tot = __ldcs(a.dy + o_s) + dh_c;
  const float dh_new = m * dh_tot;
  const float du = dh_new * (h_prev - cc) * uu * (1.f - uu);
  const float dc = dh_new * (1.f - uu) * (1.f - cc * cc);
  __stcs(a.dxw + o_g, du);
  __stcs(a.dxw + o_g + 2 * H, dc);
  if (r >= 0) {
    put_split(a.cpl + (long)r * a.Kc + unit, (long)a.B * a.Kc, dc);
    put_split(a.gpl + (long)r * a.Kg + unit, (long)a.B * a.Kg, du);
  }
  a.dhl[(long)b * H + unit] = (1.f - m) * dh_tot + dh_new * uu;
  if constexpr (kDw) {
    if (unit == 0 && r >= 0) d.rows[base + r] = b * a.T + s;
  }
}

// The kernel: kCta threads (two warpgroups on the tiles, any more only on
// the pairs), one CTA an SM.  kDw: kCta is the dW tile's (kThreads);
// kVec: H % 4 == 0 (dw_tile_wg's 16-byte copies).
template <int kCta, bool kDw, bool kVec>
__global__ void __launch_bounds__(kCta, 1) gru_bwd_wg_kernel(
    GruBwdArgs a, const __grid_constant__ CUtensorMap tm_chi,
    const __grid_constant__ CUtensorMap tm_clo,
    const __grid_constant__ CUtensorMap tm_wchi,
    const __grid_constant__ CUtensorMap tm_wclo,
    const __grid_constant__ CUtensorMap tm_ghi,
    const __grid_constant__ CUtensorMap tm_glo,
    const __grid_constant__ CUtensorMap tm_wghi,
    const __grid_constant__ CUtensorMap tm_wglo,
    const float* __restrict__ w_gates, const float* __restrict__ w_cand,
    __nv_bfloat16* wcpl, __nv_bfloat16* wgpl, float* dh0, int s_cand,
    int cps_cand, int s_gates, int cps_gates, GruDwArgs d) {
  static_assert(!kDw || kCta == kThreads, "dw_tile_wg's CTA");
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  __shared__ uint64_t full[lwg::kStages];
  __shared__ int warp_n[kCta / 32];
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, H = a.H;
  const long BH = (long)B * H, TH = (long)T * H;
  const long first = (long)blockIdx.x * kCta + tid;
  const long stride = (long)gridDim.x * kCta;

  // prologue: the weights' planes, the step ranks, the ring's barriers
  if (tid == 0) {
    for (int s = 0; s < lwg::kStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  split_rows(wcpl, w_cand, H, H, a.Kc, first, stride);
  split_rows(wgpl, w_gates, H, 2 * H, a.Kg, first, stride);
  for (int s = blockIdx.x; s < T; s += gridDim.x)
    step_ranks<kCta>(a.mask, B, T, s, a.rank, warp_n);
  fence_proxy_global();
  grid.sync();
  for (long p = first; p < BH; p += stride) {
    const int b = (int)(p / H);
    gru_phase_a<kDw>(a, d, T - 1, b, (int)(p % H), 0.f,
                     __ldcg(a.rank + (long)(T - 1) * B + b), 0);
  }
  fence_proxy_global();
  grid.sync();

  // the two products share the ring: each hands its count of chunks
  // through it (it) to the other before asking for its boxes ahead
  const int n_ub = (H + lwg::kCols - 1) / lwg::kCols;
  const int n_rb = (B + lwg::kRows - 1) / lwg::kRows;
  Tiles tc{&tm_chi, &tm_clo, &tm_wchi, &tm_wclo, ring, full, s_cand,
           cps_cand, a.Kc / lwg::kChunk, n_ub, n_rb * n_ub * s_cand, 0u, -1};
  Tiles tg{&tm_ghi, &tm_glo, &tm_wghi, &tm_wglo, ring, full, s_gates,
           cps_gates, a.Kg / lwg::kChunk, n_ub, n_rb * n_ub * s_gates, 0u,
           -1};
  int n = 0, base = 0;  // valid rows at t; kDw: rows listed before step t-1's
  for (int t = T - 1; t >= 0; --t) {
    n = __ldcg(a.rank + (long)T * B + t);
    tc.step(n, a.part, B, H, H);   // drh
    tg.it = tc.it;
    if (tid == 0) tg.ahead(n);
    grid.sync();  // step
    for (long p = first; p < BH; p += stride) {  // drh pairs
      const int b = (int)(p / H), unit = (int)(p % H);
      const int r = __ldcg(a.rank + (long)t * B + b);
      const float rr = __ldcs(a.gates + 3 * b * TH + (long)t * 3 * H + H +
                              unit);
      const float h_prev = h_prev_of(a, t, b, unit);
      float drh = 0.f;
      if (r >= 0)
        for (int sl = 0; sl < s_cand; ++sl)
          drh += __ldcg(a.part + ((long)sl * B + r) * H + unit);
      const float dr = drh * h_prev * rr * (1.f - rr);
      __stcs(a.dxw + 3 * b * TH + (long)t * 3 * H + H + unit, dr);
      if (r >= 0)
        put_split(a.gpl + (long)r * a.Kg + H + unit, (long)B * a.Kg, dr);
      a.drr[p] = drh * rr;
      __stcs(a.rh + b * TH + (long)t * H + unit, rr * h_prev);
    }
    fence_proxy_global();
    grid.sync();  // step
    tg.step(n, a.part, B, H, H);   // the carry's product
    tc.it = tg.it;
    if (tid == 0 && t > 0) tc.ahead(__ldcg(a.rank + (long)T * B + t - 1));
    grid.sync();  // step
    if (kDw && t > 0) base += n;
    for (long p = first; p < BH; p += stride) {  // carry pairs
      const int b = (int)(p / H), unit = (int)(p % H);
      const int r = __ldcg(a.rank + (long)t * B + b);
      float dh = a.dhl[p];
      if (r >= 0) {
        dh += a.drr[p];
        for (int sl = 0; sl < s_gates; ++sl)
          dh += __ldcg(a.part + ((long)sl * B + r) * H + unit);
      }
      if (t > 0)
        gru_phase_a<kDw>(a, d, t - 1, b, unit, dh,
                         __ldcg(a.rank + (long)(t - 1) * B + b), base);
      else
        dh0[p] = dh;
    }
    fence_proxy_global();
    if (t > 0) grid.sync();  // step
  }

  if constexpr (kDw) {
    // every dxw and rh row and the row list are complete: the last ones
    // (phase A of step 0, the drh pairs of t = 0) ran before t = 0's
    // third barrier, and the pairs since write neither
    const int n_rows = base + n;
    const int nkt = (H + dwg::kTile - 1) / dwg::kTile;
    const int n_g = nkt * ((2 * H + dwg::kTile - 1) / dwg::kTile);
    const int n_dw = n_g + nkt * ((H + dwg::kTile - 1) / dwg::kTile);
    const long HH = (long)H * H;
    // the list was written in this launch: read it through L2 (__ldcg),
    // never the read-only path
    auto hrow = [&](int j) -> const float* {   // h_{t-1} of listed row j
      const int row = __ldcg(d.rows + j);
      return row % T ? a.hseq + (long)(row - 1) * H
                     : a.h0 + (long)(row / T) * H;
    };
    auto rhrow = [&](int j) -> const float* {
      return a.rh + (long)__ldcg(d.rows + j) * H;
    };
    auto grow = [&](int j) -> const float* {   // dg of listed row j
      return a.dxw + (long)__ldcg(d.rows + j) * 3 * H;
    };
    auto crow = [&](int j) -> const float* {   // dc_pre of listed row j
      return a.dxw + (long)__ldcg(d.rows + j) * 3 * H + 2 * H;
    };
    for (int task = blockIdx.x; task < n_dw * d.n_split; task += gridDim.x) {
      const int tile = task % n_dw, split = task / n_dw;
      float* out = d.dw_part + split * 3 * HH;  // the split's [H, 3H]
      if (tile < n_g)
        dw_tile_wg<kVec>(hrow, grow, n_rows, split, d.n_split, H, 2 * H,
                         (tile % nkt) * dwg::kTile, (tile / nkt) * dwg::kTile,
                         d.n_split > 1 ? out : d.dw_gates, 2 * H, ring, a.h0);
      else
        dw_tile_wg<kVec>(rhrow, crow, n_rows, split, d.n_split, H, H,
                         ((tile - n_g) % nkt) * dwg::kTile,
                         ((tile - n_g) / nkt) * dwg::kTile,
                         d.n_split > 1 ? out + 2 * HH : d.dw_cand, H, ring,
                         a.h0);
    }
    if (d.n_split > 1) {
      grid.sync();
      for (long i = first; i < 3 * HH; i += stride) {
        float s = __ldcg(d.dw_part + i);
        for (int k = 1; k < d.n_split; ++k)
          s += __ldcg(d.dw_part + k * 3 * HH + i);
        if (i < 2 * HH)
          d.dw_gates[i] = s;
        else
          d.dw_cand[i - 2 * HH] = s;
      }
    }
  }
}

// Launch the BPTT over a's scratch (a.Kc, a.Kg = H, 2H rounded up to 64;
// a.cpl, a.gpl the dc_pre and dg planes [2, B, Kc], [2, B, Kg]) and the
// weights' planes wcpl ([2, H, Kc]) and wgpl ([2, H, Kg]); s_cand and
// s_gates cut the chunks of K = H and K = 2H as slice_chunks does.  0, a
// cudaError_t, or -1 (launch_resident).
template <int kCta, bool kDw>
__host__ inline int launch_gru_bwd(GruBwdArgs a, const float* w_gates,
                                   const float* w_cand, __nv_bfloat16* wcpl,
                                   __nv_bfloat16* wgpl, float* dh0,
                                   int s_cand, int s_gates, GruDwArgs d,
                                   cudaStream_t stream) {
  const int B = a.B, H = a.H, Kc = a.Kc, Kg = a.Kg;
  int cps_cand = slice_chunks(Kc / lwg::kChunk, s_cand);
  int cps_gates = slice_chunks(Kg / lwg::kChunk, s_gates);
  CUtensorMap tm[8];
  if (cps_cand < 0 || cps_gates < 0 ||
      !plane_map(tm, a.cpl, B, H, Kc) ||
      !plane_map(tm + 1, a.cpl + (long)B * Kc, B, H, Kc) ||
      !plane_map(tm + 2, wcpl, H, H, Kc) ||
      !plane_map(tm + 3, wcpl + (long)H * Kc, H, H, Kc) ||
      !plane_map(tm + 4, a.gpl, B, 2 * H, Kg) ||
      !plane_map(tm + 5, a.gpl + (long)B * Kg, B, 2 * H, Kg) ||
      !plane_map(tm + 6, wgpl, H, 2 * H, Kg) ||
      !plane_map(tm + 7, wgpl + (long)H * Kg, H, 2 * H, Kg))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a,        tm,        tm + 1,   tm + 2,     tm + 3,
                  tm + 4,    tm + 5,    tm + 6,   tm + 7,     &w_gates,
                  &w_cand,   &wcpl,     &wgpl,    &dh0,       &s_cand,
                  &cps_cand, &s_gates,  &cps_gates, &d};
  if constexpr (kDw) {
    if (H % 4 != 0)
      return launch_resident(gru_bwd_wg_kernel<kCta, true, false>, kCta,
                             args, stream);
  }
  return launch_resident(gru_bwd_wg_kernel<kCta, kDw, kDw>, kCta, args,
                         stream);
}

}  // namespace lstm
