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
// ([rows, H] x [H, H]) and dg_t @ w_gates^T ([rows, 2H] x [2H, H]), dg =
// (du_pre | dr_pre).  Both are lstm_wg.cuh's tensor-core step product,
// C[rows, units] = A[rows, K] B[units, K]^T, with both operands K-major as
// they stand: A = dc_pre_t's planes (K = H) against B = w_cand's rows,
// and A = dg_t's planes (K = 2H) against B = w_gates' rows.  The kernel
// writes the bf16 hi/lo planes itself: w_cand's and w_gates' once, in a
// prologue; dc_pre_t's and dg_t's each step, at the row's rank among the
// rows valid at t (step_ranks) -- phase A writes dc_pre and dg's du half,
// the drh pairs dg's dr half.  Tiles of 128 compacted rows x 128 units x
// one K slice (the wrapper picks each product's slices,
// ops.gru.bwd_blocked_slices: at B 128, H 1024 on 132 SMs, drh 8 unit
// blocks x 8 slices of 2 chunks, 64 tiles; the carry product 8 x 16
// slices of 2, 128 tiles) write their sums by slice; the (row, unit)
// pairs add the slices in order.  A persistent cooperative grid of one
// CTA an SM, three warpgroups (the third only works on the pairs):
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
//
// Four barriers a step.  Phase A is the TPU kernel's arithmetic: dy joins
// the carry before the masked split.  A padded step's dg and dc_pre are
// exact zeros (dh_new = 0), so its rows enter no product and its carry
// passes through as (1 - m) dh_tot; a row padded at t but valid at t - 1
// gets its planes from t - 1's phase A, at its rank there.  dg's planes
// are written by two phases (phase A, then the drh pairs), each ordered
// before the tiles that read them by fence.proxy.async.global and a grid
// barrier.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 3H flops in
// three bf16 passes: 73.3 us at B 128, T 30, H 1024 with every step valid
// (360.6 us at the fp32 rate).
#include "lstm_wg.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

namespace {
constexpr int kCta = 384;   // three warpgroups: the third only on the pairs
}  // namespace

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

__device__ __forceinline__ float h_prev_of(const GruBwdArgs& a, int s, int b,
                                           int unit) {
  return s > 0 ? a.hseq[b * (long)a.T * a.H + (long)(s - 1) * a.H + unit]
               : a.h0[(long)b * a.H + unit];
}

// Phase A of step s for (b, unit) with incoming carry dh_c; r is row b's
// rank among step s's valid rows (-1: padded, no planes written).
__device__ __forceinline__ void gru_phase_a(const GruBwdArgs& a, int s, int b,
                                            int unit, float dh_c, int r) {
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
}

__global__ void __launch_bounds__(kCta, 1) gru_bwd_blocked_kernel(
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
    int cps_cand, int s_gates, int cps_gates) {
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
    gru_phase_a(a, T - 1, b, (int)(p % H), 0.f,
                __ldcg(a.rank + (long)(T - 1) * B + b));
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
  for (int t = T - 1; t >= 0; --t) {
    const int n = __ldcg(a.rank + (long)T * B + t);
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
        gru_phase_a(a, t - 1, b, unit, dh,
                    __ldcg(a.rank + (long)(t - 1) * B + b));
      else
        dh0[p] = dh;
    }
    fence_proxy_global();
    if (t > 0) grid.sync();  // step
  }
}

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
  const int Kc = round_up(H, lwg::kChunk), Kg = round_up(2 * H, lwg::kChunk);
  int cps_cand = slice_chunks(Kc / lwg::kChunk, s_cand);
  int cps_gates = slice_chunks(Kg / lwg::kChunk, s_gates);
  auto* wc = static_cast<__nv_bfloat16*>(wcpl);
  auto* wgp = static_cast<__nv_bfloat16*>(wgpl);
  auto* c = static_cast<__nv_bfloat16*>(cpl);
  auto* g = static_cast<__nv_bfloat16*>(gpl);
  CUtensorMap tm[8];
  if (cps_cand < 0 || cps_gates < 0 ||
      !plane_map(tm, c, B, H, Kc) ||
      !plane_map(tm + 1, c + (long)B * Kc, B, H, Kc) ||
      !plane_map(tm + 2, wc, H, H, Kc) ||
      !plane_map(tm + 3, wc + (long)H * Kc, H, H, Kc) ||
      !plane_map(tm + 4, g, B, 2 * H, Kg) ||
      !plane_map(tm + 5, g + (long)B * Kg, B, 2 * H, Kg) ||
      !plane_map(tm + 6, wgp, H, 2 * H, Kg) ||
      !plane_map(tm + 7, wgp + (long)H * Kg, H, 2 * H, Kg))
    return (int)cudaErrorInvalidValue;
  GruBwdArgs a{gates, hseq, h0,   mask, dy, dxw, rh, dhl, drr, part,
               rank,  c,    g,    B,    T,  H,   Kc, Kg};
  void* args[] = {&a,       tm,       tm + 1,   tm + 2,    tm + 3,
                  tm + 4,   tm + 5,   tm + 6,   tm + 7,    &w_gates,
                  &w_cand,  &wc,      &wgp,     &dh0,      &s_cand,
                  &cps_cand, &s_gates, &cps_gates};
  return launch_resident(gru_bwd_blocked_kernel, kCta, args, stream);
}
