// Fused LSTM forward: the whole time loop of one direction in one launch.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_fwd_kernel (_fwd_call), which
// runs a sequential grid over T on one TPU core with h/c carried in VMEM
// and w_hh resident.  On Hopper the time loop becomes a loop inside a
// persistent cooperative grid:
//
// - CTA x owns hidden units [x*U, x*U + U): its 4U gate columns of w_hh
//   ([H, 4U], 32 KB at H = 512, U = 4) stay in shared memory for all T
//   steps, and the h and c carries of its units stay in shared memory.
// - Step t: gates[b, own cols] = xw_t + h_{t-1} @ w_hh[:, own cols]
//   (row_product: h_{t-1}, written by all CTAs last step, streams from L2
//   in [128, 64] tiles through a 3-deep cp.async pipeline); then the gate
//   math for its units (peepholes, sigmoid/tanh, masked keep of h and c),
//   writing H_t, C_t and the activated gates; then one grid barrier so
//   every CTA sees all of h_t.
//
// Bound on this card: operations.  At B = 128, T = 100, H = 512 the
// recurrent product is 2*B*T*H*4H = 26.8 GFLOP fp32, ~0.40 ms at
// 67 TFLOP/s; the bytes (~266 MB) take ~0.08 ms.  Per step, every CTA
// also reads all of h_{t-1} (256 KB) from L2, and the step ends in a
// grid barrier: the time loop is latency-bound, not FMA-bound.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

template <int U>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                    const float* __restrict__ w_hh,
                    const float* __restrict__ checks,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    float* hseq, float* cseq, float* gates, int B, int T,
                    int H) {
  constexpr int N = 4 * U;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, u0 = blockIdx.x * U;
  const int Hk = round_up(H, kKT);
  const bool vec = H % 4 == 0;           // 16-byte copies of h rows
  float* ws = smem;                      // [Hk, N]  own w_hh columns
  float* tiles = ws + Hk * N;            // [kStages, kTileRows, kTileStride]
  float* red = tiles + kStages * kTileFloats;  // [KG, kTileRows, N]
  float* gs = red + kRedFloats;          // [B, N]   pre-activation gates
  float* cs = gs + B * N;                // [B, U]   cell carry
  float* hs = cs + B * U;                // [B, U]   hidden carry

  for (int idx = tid; idx < Hk * N; idx += kThreads) {
    const int k = idx / N, g = (idx % N) / U, unit = u0 + idx % U;
    ws[idx] = (k < H && unit < H) ? w_hh[(long)k * 4 * H + g * H + unit]
                                  : 0.f;
  }
  for (int idx = tid; idx < B * U; idx += kThreads) {
    const int b = idx / U, unit = u0 + idx % U;
    cs[idx] = unit < H ? c0[(long)b * H + unit] : 0.f;
    hs[idx] = unit < H ? h0[(long)b * H + unit] : 0.f;
  }
  const long TH = (long)T * H, T4H = 4 * TH;
  for (int t = 0; t < T; ++t) {
    // h_{t-1} rows: h0 [B, H] at t = 0, else H[:, t-1] of the sequence
    const float* hp = t == 0 ? h0 : hseq + (long)(t - 1) * H;
    const long lda = t == 0 ? H : TH;
    for (int r0 = 0; r0 < B; r0 += kTileRows) {
      // this chunk's xw values, loaded before the product so their
      // latency hides behind it
      constexpr int kX = kTileRows * N / kThreads;
      float xv[kX];
#pragma unroll
      for (int p = 0; p < kX; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / N, j = idx % N, unit = u0 + j % U;
        xv[p] = (b < B && unit < H)
                    ? xw[(long)b * T4H + (long)t * 4 * H + (j / U) * H + unit]
                    : 0.f;
      }
      row_product<N>(hp, lda, B, H, ws, r0, tiles, red, vec);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kX; ++p) {
        const int idx = tid + p * kThreads;
        const int b = r0 + idx / N;
        if (b < B) gs[b * N + idx % N] = xv[p] + red_sum<N>(red, idx);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U, unit = u0 + u;
      if (unit >= H) continue;
      const float* gr = gs + b * N;
      const float c_prev = cs[idx], h_prev = hs[idx];
      const float i = sigm(gr[u] + c_prev * checks[unit]);
      const float f = sigm(gr[U + u] + c_prev * checks[H + unit]);
      const float gg = tanhf(gr[2 * U + u]);
      const float c = f * c_prev + i * gg;
      const float o = sigm(gr[3 * U + u] + c * checks[2 * H + unit]);
      const float h = o * tanhf(c);
      const float m = mask[(long)b * T + t];
      const float h_keep = m * h + (1.f - m) * h_prev;
      const float c_keep = m * c + (1.f - m) * c_prev;
      cs[idx] = c_keep;
      hs[idx] = h_keep;
      const long o_s = (long)b * TH + (long)t * H + unit;
      hseq[o_s] = h_keep;
      cseq[o_s] = c_keep;
      const long o_g = (long)b * T4H + (long)t * 4 * H + unit;
      gates[o_g] = i;
      gates[o_g + H] = f;
      gates[o_g + 2 * H] = gg;
      gates[o_g + 3 * H] = o;
    }
    grid.sync();
  }
}

template <int U>
static int launch_fwd(void** args, int B, int H, cudaStream_t stream) {
  const long smem = (long)round_up(H, kKT) * 4 * U + kStages * kTileFloats +
                    kRedFloats + (long)B * 4 * U + 2L * B * U;
  return cooperative_launch(lstm_fwd_kernel<U>, H, U, smem, args, stream);
}

extern "C" int lstm_fwd(const float* xw, const float* mask, const float* w_hh,
                        const float* checks, const float* h0, const float* c0,
                        float* hseq, float* cseq, float* gates, int B, int T,
                        int H, int U, cudaStream_t stream) {
  void* args[] = {&xw,   &mask,  &w_hh, &checks, &h0, &c0,
                  &hseq, &cseq, &gates, &B,     &T,  &H};
  switch (U) {
    case 1: return launch_fwd<1>(args, B, H, stream);
    case 2: return launch_fwd<2>(args, B, H, stream);
    case 4: return launch_fwd<4>(args, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
