// Hidden-blocked LSTM forward: the whole time loop of one direction in
// one launch, for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_fwd_kernel_blocked
// (_fwd_call_blocked).  The TPU kernel runs a sequential grid (T, H/128):
// for each step it streams w_hh as [H, 4*128] column blocks while the
// full [B, H] h/c state carries in VMEM.  On Hopper the step's work is
// spread over a persistent cooperative grid instead:
//
// - A step's output is cut into tiles of 128 batch rows x U hidden units
//   (their 4U gate columns, i f c o), U in {10, 16}: the launcher
//   takes the U whose tiles spread most evenly over the co-resident CTAs
//   (at B 128: U = 10 for H 1280, 128 tiles; U = 16 for H 2048, 128
//   tiles).  CTAs walk the tile list with the grid's stride, so the
//   tiling does not depend on the number of SMs.
// - Tile product: gates[rows, cols] = h_{t-1}[rows] @ w_hh[:, cols], both
//   operands streamed from L2 in 64-wide k tiles (product_nt).  w_hh is
//   read through its transpose w_t [4H, H] (the wrapper makes it once a
//   call), so every operand row is contiguous in k.  Nothing is resident:
//   at H = 1280, w_hh is 26.2 MB, more than all the SMs' shared memory
//   leaves room for beside the h tiles.
// - Only the rows valid at step t enter the product (valid_tile_rows,
//   product_rows): a padded step keeps h and c, so its recurrent product
//   is not needed, and its gates are written as 0 (the backward's masked
//   split never reads them).  At the bench feed that leaves 80 % of the
//   32-row blocks.
// - Then the gate math for the tile's (row, unit) pairs: xw_t,
//   peepholes, sigmoid/tanh, the masked keep of h and c.  The carries are
//   the kept sequences themselves: h_{t-1} and c_{t-1} are read back
//   from H and C (step t-1), so no state lives in a CTA between steps.
// - One grid barrier per step.
//
// xw, the gates, H and C are fp32 here; the port's wrapper casts a bf16
// xw to fp32 (exactly) before the launch, and the gate math is fp32, as
// in the TPU kernel.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H FMAs;
// at the bench feed (B 128, T 100, lengths in [50, 100], 9406 valid
// row-steps) and H = 1280, 123 GFLOP fp32: 1.84 ms at 67 TFLOP/s.  Per
// step each of the 128 tiles reads all of h_{t-1} (655 KB) and its 40
// columns of w_hh (205 KB) from L2, 110 MB a step.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

template <class Tl>
__global__ void __launch_bounds__(kBThreads, 1) lstm_fwd_blocked_kernel(
    const float* __restrict__ xw, const float* __restrict__ mask,
    const float* __restrict__ w_t, const float* __restrict__ checks,
    const float* __restrict__ h0, const float* __restrict__ c0, float* hseq,
    float* cseq, float* gates, int B, int T, int H) {
  constexpr int U = Tl::COLS / 4;  // hidden units per tile
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  __shared__ int rows_s[kBRows], pos_s[kBRows];
  const int n_rt = (B + kBRows - 1) / kBRows, n_ut = (H + U - 1) / U;
  const int n_tiles = n_rt * n_ut;
  const bool vec = H % 4 == 0;  // rows of h and w_t start 16-byte aligned
  const long TH = (long)T * H, T4H = 4 * TH;
  for (int t = 0; t < T; ++t) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = (tile % n_rt) * kBRows, u0 = (tile / n_rt) * U;
      const int n = valid_tile_rows(mask, B, T, t, r0, rows_s, pos_s);
      auto arow = [&](int r) -> const float* {   // h_{t-1}, r-th valid row
        if (r >= n) return nullptr;
        const int b = rows_s[r];
        return t == 0 ? h0 + (long)b * H : hseq + b * TH + (long)(t - 1) * H;
      };
      auto brow = [&](int c) -> const float* {   // gate c / U, unit c % U
        const int unit = u0 + c % U;
        return unit < H ? w_t + ((long)(c / U) * H + unit) * H : nullptr;
      };
      if (n > 0) product_rows<Tl>(arow, brow, H, vec, w_t, stages, n);
      for (int idx = threadIdx.x; idx < kBRows * U; idx += kBThreads) {
        const int r = idx / U, u = idx % U;
        const int b = r0 + r, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const long o_s = b * TH + (long)t * H + unit;
        const long o_g = b * T4H + (long)t * 4 * H + unit;
        const float c_prev = t == 0 ? c0[(long)b * H + unit]
                                    : __ldcg(cseq + o_s - H);
        const float h_prev = t == 0 ? h0[(long)b * H + unit]
                                    : __ldcg(hseq + o_s - H);
        const int p = pos_s[r];
        if (p < 0) {  // padded at step t: keep the state
          hseq[o_s] = h_prev;
          cseq[o_s] = c_prev;
#pragma unroll
          for (int g = 0; g < 4; ++g) gates[o_g + g * H] = 0.f;
          continue;
        }
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = xw[o_g + g * H] + red_sum_nt<Tl>(stages, p, g * U + u);
        const float i = sigm(pre[0] + c_prev * checks[unit]);
        const float f = sigm(pre[1] + c_prev * checks[H + unit]);
        const float gg = tanhf(pre[2]);
        const float c = f * c_prev + i * gg;
        const float o = sigm(pre[3] + c * checks[2 * H + unit]);
        const float h = o * tanhf(c);
        const float m = mask[(long)b * T + t];
        hseq[o_s] = m * h + (1.f - m) * h_prev;
        cseq[o_s] = m * c + (1.f - m) * c_prev;
        gates[o_g] = i;
        gates[o_g + H] = f;
        gates[o_g + 2 * H] = gg;
        gates[o_g + 3 * H] = o;
      }
    }
    grid.sync();
  }
}

namespace {

// Resident CTAs and tile count of one tile width at (B, H).
template <class Tl>
struct FwdPlan {
  long resident, n_tiles;
  FwdPlan(int B, int H)
      : resident(resident_ctas(lstm_fwd_blocked_kernel<Tl>, Tl::smem_floats)),
        n_tiles((long)((B + kBRows - 1) / kBRows) *
                ((H + Tl::COLS / 4 - 1) / (Tl::COLS / 4))) {}
  long cost() const { return tile_cost(n_tiles, resident, Tl::COLS); }
  int launch(void** args, cudaStream_t stream) const {
    return launch_tiles(lstm_fwd_blocked_kernel<Tl>, n_tiles, resident,
                        Tl::smem_floats, args, stream);
  }
};

}  // namespace

extern "C" int lstm_fwd_blocked(const float* xw, const float* mask,
                                const float* w_t, const float* checks,
                                const float* h0, const float* c0, float* hseq,
                                float* cseq, float* gates, int B, int T, int H,
                                cudaStream_t stream) {
  void* args[] = {&xw,   &mask, &w_t,   &checks, &h0, &c0,
                  &hseq, &cseq, &gates, &B,      &T,  &H};
  const FwdPlan<Tile40> p10(B, H);
  const FwdPlan<Tile64> p16(B, H);
  // the wider tile when as cheap: fewer tiles read h_{t-1} fewer times
  return p16.cost() <= p10.cost() ? p16.launch(args, stream)
                                  : p10.launch(args, stream);
}
