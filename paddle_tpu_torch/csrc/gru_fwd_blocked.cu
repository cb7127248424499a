// Hidden-blocked GRU forward: the whole time loop of one direction in one
// launch, for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_fwd_kernel_blocked
// (_fwd_call_blocked).  The TPU kernel runs a sequential grid (T, 2 H/128):
// per step, H/128 gate blocks (u_j, r_j, staging r * h_prev) and then
// H/128 candidate blocks, streaming w_gates and w_cand as column blocks
// while the [B, H] state carries in VMEM.  On Hopper the step is spread
// over a persistent cooperative grid instead (the design of the LSTM's
// blocked forward before its tensor-core step, on lstm_common.cuh's
// CUDA-core tiles):
//
// - A step's output is cut into tiles of 128 batch rows x U hidden units,
//   U in {8, 16}: the launcher takes the U whose tiles spread most evenly
//   over the co-resident CTAs (at B 128: U = 8 for H 1024, 128 tiles;
//   U = 16 for H 2048, 128 tiles).  CTAs walk the tile list with the
//   grid's stride, so the tiling does not depend on the number of SMs.
// - Gate phase: g[rows, tile's u and r columns] = h_{t-1}[rows] @
//   w_gates[:, cols] (product_nt, both operands streamed from L2 in
//   64-wide k tiles; w_gates is read through its transpose wg_t [2H, H],
//   which the wrapper makes once a call, so every operand row is
//   contiguous in k).  u = sigm(x_u + g_u), r = sigm(x_r + g_r) are
//   written to the gate residue and r * h_{t-1} to the scratch rh [B, H].
//   Grid barrier: the candidate product needs all of r * h.
// - Candidate phase: (r * h)[rows] @ w_cand[:, tile's units] (through
//   wc_t [H, H]); c = tanh(x_c + .), h' = u h + (1 - u) c and the masked
//   keep; writes H_t and c.  Grid barrier: the next step reads all of h_t.
// - Only the rows valid at step t enter the products (valid_tile_rows,
//   product_rows): a padded step keeps h, so its products are not needed;
//   its residue (u, r, c) is written as 0, and the backward's masked split
//   never reads it.  The carry is the kept sequence itself: h_{t-1} is
//   read back from H (step t-1), so no state lives in a CTA between steps.
//
// xw, the gates and H are fp32 here; the port's wrapper casts a bf16 xw to
// fp32 (exactly) before the launch, and the gate math is fp32, as in the
// TPU kernel.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 3H FMAs; at
// B 128, T 30, H 1024 with every step valid, 24.16 GFLOP fp32: 360.6 us at
// 67 TFLOP/s.  The bytes (xw and the residue, H, both weights) are about
// 122 MB, 36 us at 3.35 TB/s.  Per step each of the 128 tiles reads all of
// h_{t-1} and all of r * h (2 x 512 KB) and its columns of both weights
// from L2.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

template <int U>
__global__ void __launch_bounds__(kBThreads, 1) gru_fwd_blocked_kernel(
    const float* __restrict__ xw, const float* __restrict__ mask,
    const float* __restrict__ wg_t, const float* __restrict__ wc_t,
    const float* __restrict__ h0, float* hseq, float* gates, float* rh,
    int B, int T, int H) {
  using TG = typename GruTile<U>::Gates;
  using TC = typename GruTile<U>::Units;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  __shared__ int rows_s[kBRows], pos_s[kBRows];
  const int n_rt = (B + kBRows - 1) / kBRows, n_ut = (H + U - 1) / U;
  const int n_tiles = n_rt * n_ut;
  const bool vec = H % 4 == 0;  // rows of h, rh, wg_t and wc_t: 16-byte
  const long TH = (long)T * H, T3H = 3 * TH;
  for (int t = 0; t < T; ++t) {
    // h_{t-1} of batch row b
    auto h_row = [&](int b) -> const float* {
      return t == 0 ? h0 + (long)b * H : hseq + b * TH + (long)(t - 1) * H;
    };
    // ---- gate phase: u, r and r * h_{t-1}
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = (tile % n_rt) * kBRows, u0 = (tile / n_rt) * U;
      const int n = valid_tile_rows(mask, B, T, t, r0, rows_s, pos_s);
      auto arow = [&](int r) -> const float* {   // r-th valid row
        return r < n ? h_row(rows_s[r]) : nullptr;
      };
      auto brow = [&](int c) -> const float* {   // gate c / U, unit c % U
        const int unit = u0 + c % U;
        return unit < H ? wg_t + ((long)(c / U) * H + unit) * H : nullptr;
      };
      if (n > 0) product_rows<TG>(arow, brow, H, vec, wg_t, stages, n);
      for (int idx = threadIdx.x; idx < kBRows * U; idx += kBThreads) {
        const int r = idx / U, u = idx % U;
        const int b = r0 + r, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const long o_g = b * T3H + (long)t * 3 * H + unit;
        const int p = pos_s[r];
        if (p < 0) {  // padded at step t: no residue
          gates[o_g] = 0.f;
          gates[o_g + H] = 0.f;
          continue;
        }
        const float uu = sigm(xw[o_g] + red_sum_nt<TG>(stages, p, u));
        const float rr = sigm(xw[o_g + H] + red_sum_nt<TG>(stages, p, U + u));
        gates[o_g] = uu;
        gates[o_g + H] = rr;
        rh[(long)b * H + unit] = rr * __ldcg(h_row(b) + unit);
      }
    }
    grid.sync();
    // ---- candidate phase: (r * h) @ w_cand, the update and the keep
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = (tile % n_rt) * kBRows, u0 = (tile / n_rt) * U;
      const int n = valid_tile_rows(mask, B, T, t, r0, rows_s, pos_s);
      auto arow = [&](int r) -> const float* {   // r * h of the r-th
        return r < n ? rh + (long)rows_s[r] * H : nullptr;  // valid row
      };
      auto brow = [&](int c) -> const float* {   // w_cand column u0 + c
        const int unit = u0 + c;
        return unit < H ? wc_t + (long)unit * H : nullptr;
      };
      if (n > 0) product_rows<TC>(arow, brow, H, vec, wc_t, stages, n);
      for (int idx = threadIdx.x; idx < kBRows * U; idx += kBThreads) {
        const int r = idx / U, u = idx % U;
        const int b = r0 + r, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const long o_s = b * TH + (long)t * H + unit;
        const long o_g = b * T3H + (long)t * 3 * H + unit;
        const float h_prev = __ldcg(h_row(b) + unit);
        const int p = pos_s[r];
        if (p < 0) {  // padded at step t: keep the state
          hseq[o_s] = h_prev;
          gates[o_g + 2 * H] = 0.f;
          continue;
        }
        const float uu = __ldcg(gates + o_g);
        const float c = tanhf(xw[o_g + 2 * H] + red_sum_nt<TC>(stages, p, u));
        const float h_new = uu * h_prev + (1.f - uu) * c;
        const float m = mask[(long)b * T + t];
        hseq[o_s] = m * h_new + (1.f - m) * h_prev;
        gates[o_g + 2 * H] = c;
      }
    }
    grid.sync();
  }
}

namespace {

// Resident CTAs and tile count of one tile width at (B, H); both phases
// share the staging buffers, sized for the wider (gate) tile.
template <int U>
struct FwdPlan {
  static constexpr long smem_floats = GruTile<U>::Gates::smem_floats;
  long resident, n_tiles;
  FwdPlan(int B, int H)
      : resident(resident_ctas(gru_fwd_blocked_kernel<U>, smem_floats)),
        n_tiles((long)((B + kBRows - 1) / kBRows) * ((H + U - 1) / U)) {}
  long cost() const { return tile_cost(n_tiles, resident, U); }
  int launch(void** args, cudaStream_t stream) const {
    return launch_tiles(gru_fwd_blocked_kernel<U>, n_tiles, resident,
                        smem_floats, args, stream);
  }
};

}  // namespace

// rh: [B, H] scratch (r * h_{t-1} of the step).
extern "C" int gru_fwd_blocked(const float* xw, const float* mask,
                               const float* wg_t, const float* wc_t,
                               const float* h0, float* hseq, float* gates,
                               float* rh, int B, int T, int H,
                               cudaStream_t stream) {
  void* args[] = {&xw,    &mask, &wg_t, &wc_t, &h0, &hseq,
                  &gates, &rh,   &B,    &T,    &H};
  const FwdPlan<8> p8(B, H);
  const FwdPlan<16> p16(B, H);
  // the wider tile when as cheap: fewer tiles read h_{t-1} fewer times
  return p16.cost() <= p8.cost() ? p16.launch(args, stream)
                                 : p8.launch(args, stream);
}
