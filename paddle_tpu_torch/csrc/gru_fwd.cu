// Fused GRU forward: the whole time loop of one direction in one launch.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_fwd_kernel (_fwd_call), which
// runs a sequential grid over T on one TPU core with h carried in VMEM
// and both recurrent weights resident.  On Hopper the time loop is a
// loop inside a persistent cooperative grid, on lstm_common.cuh's
// CUDA-core row product:
//
// - CTA x owns hidden units [x*U, x*U + U), U = 4: its 2U gate columns
//   of w_gates (u | r) and U columns of w_cand stay in shared memory for
//   all T steps ([H, 3U] floats, 24 KB at H = 512), and so does the h
//   carry of its units.
// - Step t, gate phase: g[b, own u, r cols] = h_{t-1} @ w_gates[:, own]
//   (row_product: h_{t-1}, written by all CTAs last step, streams from
//   L2 through a 3-deep cp.async pipeline); u = sigm(x_u + g_u), r =
//   sigm(x_r + g_r); r * h_{t-1} of its units goes to the scratch rh
//   [B, H].  Grid barrier: the candidate product needs all of r * h.
// - Candidate phase: c = tanh(x_c + rh @ w_cand[:, own]); h' = u h +
//   (1 - u) c; the masked keep m h' + (1 - m) h; writes H_t and the
//   gate residue (u, r, c).  Grid barrier: the next step reads all of
//   h_t.
//
// Layouts are batch-major: xw / gates [B, T, 3H] (gate order u, r, c),
// H [B, T, H], mask [B, T] (1.0 valid, 0.0 padding), w_gates [H, 2H],
// w_cand [H, H], h0 [B, H].  Gate math in fp32.
//
// Bound on this card: operations.  At B = 128, T = 30, H = 512 the two
// recurrent products are 2*B*T*H*3H = 6.04 GFLOP fp32, ~90 us at
// 67 TFLOP/s; the bytes (~40 MB) take ~12 us.  Every CTA reads all of
// h_{t-1} and all of r * h (2 x 256 KB) from L2 each step, and each step
// ends in two grid barriers: the loop is latency-bound.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int U = 4;        // hidden units per CTA
constexpr int NG = 2 * U;   // gate columns (u, r) per CTA: j = g * U + u

__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                   const float* __restrict__ w_gates,
                   const float* __restrict__ w_cand,
                   const float* __restrict__ h0, float* hseq, float* gates,
                   float* rh, int B, int T, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, u0 = blockIdx.x * U;
  const int Hk = round_up(H, kKT);
  const bool vec = H % 4 == 0;           // 16-byte copies of h rows
  float* wg = smem;                      // [Hk, NG] own w_gates columns
  float* wc = wg + Hk * NG;              // [Hk, U]  own w_cand columns
  float* tiles = wc + Hk * U;            // [kStages, kTileRows, kTileStride]
  float* red = tiles + kStages * kTileFloats;  // [KG, kTileRows, N]
  float* gs = red + kRedFloats;          // [B, NG]  activated u, r
  float* hs = gs + B * NG;               // [B, U]   hidden carry

  for (int idx = tid; idx < Hk * NG; idx += kThreads) {
    const int k = idx / NG, j = idx % NG, unit = u0 + j % U;
    wg[idx] = (k < H && unit < H) ? w_gates[(long)k * 2 * H + (j / U) * H + unit]
                                  : 0.f;
  }
  for (int idx = tid; idx < Hk * U; idx += kThreads) {
    const int k = idx / U, unit = u0 + idx % U;
    wc[idx] = (k < H && unit < H) ? w_cand[(long)k * H + unit] : 0.f;
  }
  for (int idx = tid; idx < B * U; idx += kThreads) {
    const int unit = u0 + idx % U;
    hs[idx] = unit < H ? h0[(long)(idx / U) * H + unit] : 0.f;
  }
  const long TH = (long)T * H, T3H = 3 * TH;
  for (int t = 0; t < T; ++t) {
    // ---- gate phase.  h_{t-1} rows: h0 [B, H] at t = 0, else H[:, t-1]
    const float* hp = t == 0 ? h0 : hseq + (long)(t - 1) * H;
    const long lda = t == 0 ? H : TH;
    for (int r0 = 0; r0 < B; r0 += kTileRows) {
      constexpr int kX = kTileRows * NG / kThreads;
      float xv[kX];   // loaded before the product: latency hidden
#pragma unroll
      for (int p = 0; p < kX; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / NG, j = idx % NG, unit = u0 + j % U;
        xv[p] = (b < B && unit < H)
                    ? xw[(long)b * T3H + (long)t * 3 * H + (j / U) * H + unit]
                    : 0.f;
      }
      row_product<NG>(hp, lda, B, H, wg, r0, tiles, red, vec);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kX; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / NG;
        if (b < B) gs[b * NG + idx % NG] = sigm(xv[p] + red_sum<NG>(red, idx));
      }
    }
    __syncthreads();
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U, unit = u0 + u;
      if (unit >= H) continue;
      const float uu = gs[b * NG + u], rr = gs[b * NG + U + u];
      rh[(long)b * H + unit] = rr * hs[idx];
      const long o_g = (long)b * T3H + (long)t * 3 * H + unit;
      gates[o_g] = uu;
      gates[o_g + H] = rr;
    }
    grid.sync();
    // ---- candidate phase: rh (all CTAs' units) @ own w_cand columns
    for (int r0 = 0; r0 < B; r0 += kTileRows) {
      constexpr int kX = kTileRows * U / kThreads;
      float xv[kX];
#pragma unroll
      for (int p = 0; p < kX; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / U, unit = u0 + idx % U;
        xv[p] = (b < B && unit < H)
                    ? xw[(long)b * T3H + (long)t * 3 * H + 2 * H + unit]
                    : 0.f;
      }
      row_product<U>(rh, H, B, H, wc, r0, tiles, red, vec);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kX; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / U, u = idx % U, unit = u0 + u;
        if (b >= B || unit >= H) continue;
        const float c = tanhf(xv[p] + red_sum<U>(red, idx));
        const float uu = gs[b * NG + u], h_prev = hs[b * U + u];
        const float h_new = uu * h_prev + (1.f - uu) * c;
        const float m = mask[(long)b * T + t];
        const float h_keep = m * h_new + (1.f - m) * h_prev;
        hs[b * U + u] = h_keep;
        hseq[(long)b * TH + (long)t * H + unit] = h_keep;
        gates[(long)b * T3H + (long)t * 3 * H + 2 * H + unit] = c;
      }
    }
    grid.sync();
  }
}

extern "C" int gru_fwd(const float* xw, const float* mask,
                       const float* w_gates, const float* w_cand,
                       const float* h0, float* hseq, float* gates, float* rh,
                       int B, int T, int H, cudaStream_t stream) {
  void* args[] = {&xw,   &mask,  &w_gates, &w_cand, &h0, &hseq,
                  &gates, &rh,   &B,       &T,      &H};
  const long smem = (long)round_up(H, kKT) * 3 * U + kStages * kTileFloats +
                    kRedFloats + (long)B * 3 * U;
  return cooperative_launch(gru_fwd_kernel, H, U, smem, args, stream);
}
