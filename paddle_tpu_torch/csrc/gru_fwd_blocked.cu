// Hidden-blocked GRU forward: the whole time loop of one direction in one
// launch, for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_fwd_kernel_blocked
// (_fwd_call_blocked).  The TPU kernel runs a sequential grid (T, 2 H/128):
// per step, H/128 gate blocks (u_j, r_j, staging r * h_prev) and then
// H/128 candidate blocks, streaming w_gates and w_cand as column blocks
// while the [B, H] state carries in VMEM.  On Hopper the step runs on a
// persistent cooperative grid, on lstm_wg.cuh's tensor-core step product
// (two products a step over one ring, as kernel 16's):
//
// - The gate product g = h_{t-1} w_gates is C[rows, cols] = A[rows, K]
//   B[cols, K]^T with A = h_{t-1}'s bf16 hi/lo planes ([B, Kp], K = H, Kp
//   = H rounded up to 64) in step t's compacted row order, and B = w_gates'
//   transpose as planes [Ng, Kp] that the prologue writes from w_gates
//   (through shared memory, read along its rows).  Ng = 2 Hu, Hu = H
//   rounded up to 64: B's rows are ordered unit block x gate x unit (row
//   128 ub + 64 g + u is gate g (u, r) of unit 64 ub + u, zeros past H), so
//   a 128-column tile holds both gates of its 64 units.
// - The candidate product (r h_{t-1}) w_cand: A = the planes of r h_{t-1}
//   (the gate pairs write them at the row's rank, so no f32 copy of r h is
//   kept), B = w_cand's transpose as planes [H, Kp], 128-unit column
//   blocks.
// - Tiles of 128 compacted rows x 128 columns x one K slice (the wrapper
//   picks each product's slices, ops.gru.fwd_blocked_slices: at B 128, H
//   1024 on 132 SMs, the gates 16 column blocks x 8 slices of 2 chunks,
//   128 tiles; the candidate 8 x 8 of 2, 64 tiles) write their sums by
//   slice; the (row, unit) pairs add the slices in order.
//
//   prologue: the weights' planes; the step ranks; barrier; h0's planes
//             in step 0's order; barrier
//   for t = 0 .. T-1:
//     per tile: part[slice] = h_{t-1}'s planes x w_gates^T
//     barrier
//     per pair: u = sigm(x_u + g_u), r = sigm(x_r + g_r) into the residue;
//               r h_{t-1}'s planes at the row's rank
//     barrier
//     per tile: part[slice] = (r h_{t-1})'s planes x w_cand^T
//     barrier
//     per pair: c = tanh(x_c + .), h' = u h + (1 - u) c and the masked
//               keep; H_t, the residue c, and h_t's planes at the row's
//               rank in step t + 1's order
//     barrier (t < T - 1)
//
// Four barriers a step.  Only the rows valid at step t enter the products
// (a padded step keeps h, so its products are not needed); its residue
// (u, r, c) is written as 0, and the backward's masked split never reads
// it.  Every row valid at t + 1 gets its planes, a row padded at t too
// (its kept state).  The carry is the kept sequence itself: h_{t-1} is
// read back from H (step t-1), so no state lives in a CTA between steps.
// The planes are written by the generic proxy and read by TMA after a
// grid barrier: the writers run fence.proxy.async.global before it.
//
// xw, the gates and H are fp32 here; the port's wrapper casts a bf16 xw to
// fp32 (exactly) before the launch, and the gate math is fp32, as in the
// TPU kernel.  The products are three bf16 passes of the f32 operands' hi
// and lo parts, each 64-wide K chunk drained into f32 (lstm_wg.cuh).
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 3H flops in
// three bf16 passes: 73.3 us at B 128, T 30, H 1024 with every step valid
// (360.6 us at the fp32 rate).  The bytes (xw and the residue, H, both
// weights) are about 122 MB, 36 us at 3.35 TB/s.
#include "lstm_wg.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

namespace {
constexpr int kCta = 384;                // three warpgroups
constexpr int kGU = lwg::kCols / 2;      // hidden units a gate column block
constexpr int kTk = 256;                 // k values of a transpose tile
}  // namespace

struct GruFwdArgs {
  const float* xw;
  const float* mask;
  const float* w_gates;
  const float* w_cand;
  const float* h0;
  float* hseq;
  float* gates;
  float* part;  // [S, B, Ng] or [S, B, H]: a product's sums by K slice
  int* rank;    // [T, B] row b's rank among step t's valid rows (-1
                // padded), then [T] the counts
  __nv_bfloat16* wgpl;  // [2, Ng, Kp] w_gates^T's planes (hi, lo)
  __nv_bfloat16* wcpl;  // [2, H, Kp] w_cand^T's planes
  __nv_bfloat16* hpl;   // [2, B, Kp] h_{t-1}'s planes, compacted
  __nv_bfloat16* rpl;   // [2, B, Kp] (r h_{t-1})'s planes, compacted
  int B, T, H, Kp, Ng;
};

// The planes of both weights' transposes, 32 plane rows x kTk values a
// tile through shared memory (tile, kTk x 33 floats): read along the
// weights' rows, written along the planes' rows.  Gate block nb (plane
// rows 32 nb ..): unit block nb / 4, gate nb / 2 % 2, units 32 (nb % 2)
// .. of it, zeros past H; candidate block nb: units 32 nb ...
__device__ __forceinline__ void split_w_t(const GruFwdArgs& a, float* tile) {
  const int H = a.H, Kp = a.Kp;
  const int nkb = (H + kTk - 1) / kTk, n_g = a.Ng / 32;
  const int n_tiles = (n_g + (H + 31) / 32) * nkb;
  for (int tt = blockIdx.x; tt < n_tiles; tt += gridDim.x) {
    const int nb = tt / nkb, k0 = tt % nkb * kTk;
    const bool gate = nb < n_g;
    const int unit0 = gate ? nb / 4 * kGU + nb % 2 * 32 : (nb - n_g) * 32;
    const int units = min(32, H - unit0);   // <= 0: a block of zeros
    const float* w = gate ? a.w_gates + nb / 2 % 2 * H + unit0
                          : a.w_cand + unit0;
    const long ld = gate ? 2L * H : H;
    __nv_bfloat16* dst = gate ? a.wgpl + (long)nb * 32 * Kp
                              : a.wcpl + (long)unit0 * Kp;
    const long lo = (long)(gate ? a.Ng : H) * Kp;
    __syncthreads();  // the last tile is written out
#pragma unroll 4
    for (int i = threadIdx.x; i < kTk * 32; i += kCta) {
      const int kk = i / 32, u = i % 32, k = k0 + kk;
      tile[kk * 33 + u] = u < units && k < H ? __ldg(w + k * ld + u) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < kTk * 32; i += kCta) {
      const int u = i / kTk, kk = i % kTk, k = k0 + kk;
      if (k < H && (gate || u < units))
        put_split(dst + (long)u * Kp + k, lo, tile[kk * 33 + u]);
    }
  }
}

// A (row, unit) pair p = b * H + unit of step t, as far as it goes before
// the slices' sums: its ranks at t and t + 1 (-1: padded), xw_t's values
// of its unit (u, r, c), h_{t-1}, the mask and the u of the gate pairs.
struct Pair {
  long o_s, o_g;
  int unit, r, r1;
  float x[3], h_prev, m, u;
};

__device__ __forceinline__ void pair_in(const GruFwdArgs& a, int t, long p,
                                        bool cand, Pair& v) {
  const int H = a.H, B = a.B, T = a.T, b = (int)(p / H);
  v.unit = (int)(p % H);
  v.r = __ldcg(a.rank + (long)t * B + b);
  v.o_s = b * (long)T * H + (long)t * H + v.unit;
  v.o_g = 3 * b * (long)T * H + (long)t * 3 * H + v.unit;
  v.h_prev = t == 0 ? a.h0[p] : __ldcg(a.hseq + v.o_s - H);
  if (cand) {
    v.r1 = t + 1 < T ? __ldcg(a.rank + (long)(t + 1) * B + b) : -1;
    v.x[2] = __ldcs(a.xw + v.o_g + 2 * H);
    v.m = a.mask[(long)b * T + t];
    v.u = __ldcg(a.gates + v.o_g);
  } else {
    v.x[0] = __ldcs(a.xw + v.o_g);
    v.x[1] = __ldcs(a.xw + v.o_g + H);
  }
}

// The gate pair's outputs from its sums gu, gr: u and r into the residue
// (0 when padded), r h_{t-1}'s planes at the row's rank.
__device__ __forceinline__ void gate_out(const GruFwdArgs& a, const Pair& v,
                                         float gu, float gr) {
  const int H = a.H;
  if (v.r < 0) {  // padded at step t: no residue
    a.gates[v.o_g] = 0.f;
    a.gates[v.o_g + H] = 0.f;
    return;
  }
  const float uu = sigm(v.x[0] + gu);
  const float rr = sigm(v.x[1] + gr);
  a.gates[v.o_g] = uu;
  a.gates[v.o_g + H] = rr;
  put_split(a.rpl + (long)v.r * a.Kp + v.unit, (long)a.B * a.Kp,
            rr * v.h_prev);
}

// The candidate pair's outputs from its sum s: c, the update and the
// masked keep; H_t, the residue c (0 when padded) and h_t's planes at the
// row's rank at t + 1.
__device__ __forceinline__ void cand_out(const GruFwdArgs& a, const Pair& v,
                                         float s) {
  float h = v.h_prev, c = 0.f;   // padded at step t: keep the state
  if (v.r >= 0) {
    c = tanhf(v.x[2] + s);
    const float h_new = v.u * v.h_prev + (1.f - v.u) * c;
    h = v.m * h_new + (1.f - v.m) * v.h_prev;
  }
  a.hseq[v.o_s] = h;
  a.gates[v.o_g + 2 * a.H] = c;
  if (v.r1 >= 0)
    put_split(a.hpl + (long)v.r1 * a.Kp + v.unit, (long)a.B * a.Kp, h);
}

__global__ void __launch_bounds__(kCta, 1) gru_fwd_blocked_kernel(
    GruFwdArgs a, const __grid_constant__ CUtensorMap tm_hhi,
    const __grid_constant__ CUtensorMap tm_hlo,
    const __grid_constant__ CUtensorMap tm_wghi,
    const __grid_constant__ CUtensorMap tm_wglo,
    const __grid_constant__ CUtensorMap tm_rhi,
    const __grid_constant__ CUtensorMap tm_rlo,
    const __grid_constant__ CUtensorMap tm_wchi,
    const __grid_constant__ CUtensorMap tm_wclo, int s_gates, int cps_gates,
    int s_cand, int cps_cand) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  __shared__ uint64_t full[lwg::kStages];
  __shared__ int warp_n[kCta / 32];
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, H = a.H, Ng = a.Ng;
  const long BH = (long)B * H, plane = (long)B * a.Kp;
  const long first = (long)blockIdx.x * kCta + tid;
  const long stride = (long)gridDim.x * kCta;

  // prologue: the weights' planes, the step ranks, the ring's barriers;
  // then h0's planes in step 0's order
  if (tid == 0) {
    for (int s = 0; s < lwg::kStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  split_w_t(a, reinterpret_cast<float*>(ring));
  wg::fence_proxy_async();  // the ring's generic writes before TMA's
  for (int s = blockIdx.x; s < T; s += gridDim.x)
    step_ranks<kCta>(a.mask, B, T, s, a.rank, warp_n);
  fence_proxy_global();
  grid.sync();
  for (long p = first; p < BH; p += stride) {
    const int r = __ldcg(a.rank + p / H);
    if (r >= 0) put_split(a.hpl + (long)r * a.Kp + p % H, plane, a.h0[p]);
  }
  fence_proxy_global();
  grid.sync();

  // the two products share the ring: each hands its count of chunks
  // through it (it) to the other before asking for its boxes ahead
  const int n_rb = (B + lwg::kRows - 1) / lwg::kRows;
  const int n_gb = Ng / lwg::kCols, n_cb = (H + lwg::kCols - 1) / lwg::kCols;
  const int nch = a.Kp / lwg::kChunk;
  Tiles tg{&tm_hhi, &tm_hlo, &tm_wghi, &tm_wglo, ring, full, s_gates,
           cps_gates, nch, n_gb, n_rb * n_gb * s_gates, 0u, -1};
  Tiles tc{&tm_rhi, &tm_rlo, &tm_wchi, &tm_wclo, ring, full, s_cand,
           cps_cand, nch, n_cb, n_rb * n_cb * s_cand, 0u, -1};
  const long slice_g = (long)B * Ng, slice_c = BH;  // floats of a slice
  for (int t = 0; t < T; ++t) {
    const int n = __ldcg(a.rank + (long)T * B + t);
    tg.step(n, a.part, B, Ng, Ng);   // the gates
    tc.it = tg.it;
    if (tid == 0) tc.ahead(n);
    grid.sync();  // step
    // two pairs an iteration (the second clamped onto the first past BH):
    // both pairs' loads, then both's slice sums in slice order (a padded
    // row reads row 0's and drops them: no branch in the loads), then
    // both's arithmetic -- the phase waits on L2, not on operations
    for (long p = first; p < BH; p += 2 * stride) {  // gate pairs
      Pair v0, v1;
      pair_in(a, t, p, false, v0);
      pair_in(a, t, p + stride < BH ? p + stride : p, false, v1);
      const float* q0 = a.part + (long)max(v0.r, 0) * Ng +
                        v0.unit / kGU * lwg::kCols + v0.unit % kGU;
      const float* q1 = a.part + (long)max(v1.r, 0) * Ng +
                        v1.unit / kGU * lwg::kCols + v1.unit % kGU;
      float gu0 = 0.f, gr0 = 0.f, gu1 = 0.f, gr1 = 0.f;
      for (int sl = 0; sl < s_gates; ++sl) {
        gu0 += __ldcg(q0 + sl * slice_g);
        gr0 += __ldcg(q0 + sl * slice_g + kGU);
        gu1 += __ldcg(q1 + sl * slice_g);
        gr1 += __ldcg(q1 + sl * slice_g + kGU);
      }
      gate_out(a, v0, gu0, gr0);
      gate_out(a, v1, gu1, gr1);
    }
    fence_proxy_global();
    grid.sync();  // step
    tc.step(n, a.part, B, H, H);     // the candidate
    tg.it = tc.it;
    if (tid == 0 && t + 1 < T) tg.ahead(__ldcg(a.rank + (long)T * B + t + 1));
    grid.sync();  // step
    for (long p = first; p < BH; p += 2 * stride) {  // candidate pairs
      Pair v0, v1;
      pair_in(a, t, p, true, v0);
      pair_in(a, t, p + stride < BH ? p + stride : p, true, v1);
      const float* q0 = a.part + (long)max(v0.r, 0) * H + v0.unit;
      const float* q1 = a.part + (long)max(v1.r, 0) * H + v1.unit;
      float s0 = 0.f, s1 = 0.f;
      for (int sl = 0; sl < s_cand; ++sl) {
        s0 += __ldcg(q0 + sl * slice_c);
        s1 += __ldcg(q1 + sl * slice_c);
      }
      cand_out(a, v0, s0);
      cand_out(a, v1, s1);
    }
    fence_proxy_global();
    if (t + 1 < T) grid.sync();  // step
  }
}

// Scratch: part [max(s_gates Ng, s_cand H), B] f32 (Ng = 2 x H rounded up
// to 64); rank T*B + T ints; wgpl [2, Ng, Kp], wcpl [2, H, Kp], hpl and
// rpl [2, B, Kp] bf16, Kp = H rounded up to 64.  s_gates and s_cand cut
// the ceil(H / 64) chunks of K into slices of ceil(chunks / slices), none
// empty.  0, a cudaError_t, or -1 (launch_resident).
extern "C" int gru_fwd_blocked(const float* xw, const float* mask,
                               const float* w_gates, const float* w_cand,
                               const float* h0, float* hseq, float* gates,
                               float* part, int* rank, void* wgpl, void* wcpl,
                               void* hpl, void* rpl, int B, int T, int H,
                               int s_gates, int s_cand, cudaStream_t stream) {
  const int Kp = round_up(H, lwg::kChunk), Ng = 2 * round_up(H, kGU);
  int cps_gates = slice_chunks(Kp / lwg::kChunk, s_gates);
  int cps_cand = slice_chunks(Kp / lwg::kChunk, s_cand);
  const GruFwdArgs a{xw,   mask, w_gates, w_cand, h0,
                     hseq, gates, part,   rank,
                     static_cast<__nv_bfloat16*>(wgpl),
                     static_cast<__nv_bfloat16*>(wcpl),
                     static_cast<__nv_bfloat16*>(hpl),
                     static_cast<__nv_bfloat16*>(rpl),
                     B,    T,    H,       Kp,     Ng};
  CUtensorMap tm[8];
  if (cps_gates < 0 || cps_cand < 0 ||
      !plane_map(tm, a.hpl, B, H, Kp) ||
      !plane_map(tm + 1, a.hpl + (long)B * Kp, B, H, Kp) ||
      !plane_map(tm + 2, a.wgpl, Ng, H, Kp) ||
      !plane_map(tm + 3, a.wgpl + (long)Ng * Kp, Ng, H, Kp) ||
      !plane_map(tm + 4, a.rpl, B, H, Kp) ||
      !plane_map(tm + 5, a.rpl + (long)B * Kp, B, H, Kp) ||
      !plane_map(tm + 6, a.wcpl, H, H, Kp) ||
      !plane_map(tm + 7, a.wcpl + (long)H * Kp, H, H, Kp))
    return (int)cudaErrorInvalidValue;
  GruFwdArgs args_a = a;
  void* args[] = {&args_a,    tm,     tm + 1,    tm + 2,    tm + 3,
                  tm + 4,     tm + 5, tm + 6,    tm + 7,    &s_gates,
                  &cps_gates, &s_cand, &cps_cand};
  return launch_resident(gru_fwd_blocked_kernel, kCta, args, stream);
}
