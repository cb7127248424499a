// Fused LSTM backward (BPTT): the whole reversed time loop in one launch.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_bwd_kernel (_bwd_call): dh/dc
// carries on chip, dW_hh and the peephole grads accumulated over T, dxw
// per step, dh0/dc0 at the end.  Same persistent cooperative grid as
// lstm_fwd.cu: CTA x owns hidden units [x*U, x*U + U).  Per step t
// (descending):
//
// - Phase A, local to the CTA's units: the external dy/dyc join the
//   carries, the masked split, the gate derivatives dgates (written as
//   dxw_t, and kept in shared memory for the CTA's own columns), the new
//   dc carry, the (1-m) share of the dh carry, and the peephole-grad sums
//   over the batch.
// - Partial recurrent pull-back: P_x[b, k] = sum over the CTA's own
//   columns j of dgates[b, j] * w_hh[k, j], for every hidden unit k,
//   written to a double-buffered scratch [2, grid, B, H] in L2.
// - One grid barrier.
// - Reduce: dh_prev[b, own units] = sum over x (in CTA order) of
//   P_x[b, own units], which completes the dh carry.
//
// The partials move 2 x 32 MB per step through L2 at the bench shape,
// where reading all of dgates_t in every CTA would move 128 MB.  The
// scratch alternates between two buffers, so a CTA writing step t-1's
// partials never meets one still reading step t's.
//
// dW_hh = sum over (b, t) of h_{t-1}[b]^T dgates_t[b] is one [H x BT] x
// [BT x 4H] product; it runs after the time loop, tiled 128 x 64 over
// all CTAs with its rows streamed through a cp.async pipeline, instead
// of inside the latency-bound step.  No atomics: every sum runs in a
// fixed order, so two runs give the same bits.
//
// Bound on this card: operations.  Two recurrent products (dh_prev and
// dW_hh), 2 * 2*B*T*H*4H = 53.7 GFLOP fp32 at B = 128, T = 100, H = 512:
// ~0.80 ms at 67 TFLOP/s.
#include "lstm_common.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

constexpr int kXB = 8;                   // partials in flight per thread

template <int U>
struct Units;  // U consecutive floats, read from L2 in one load
template <>
struct Units<1> {
  float v[1];
  __device__ void load(const float* p) { v[0] = __ldcg(p); }
};
template <>
struct Units<2> {
  float v[2];
  __device__ void load(const float* p) {
    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = x.x, v[1] = x.y;
  }
};
template <>
struct Units<4> {
  float v[4];
  __device__ void load(const float* p) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};

template <int U>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ hseq,
    const float* __restrict__ cseq, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ mask,
    const float* __restrict__ w_hh, const float* __restrict__ checks,
    const float* __restrict__ dy, const float* __restrict__ dyc, float* dxw,
    float* dw, float* dchecks, float* dh0, float* dc0, float* pbuf, int B,
    int T, int H) {
  constexpr int N = 4 * U;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, u0 = blockIdx.x * U, G = gridDim.x;
  const int Hp = round_up(H, 4), Bp = round_up(B, 8);
  float* wT = smem;                      // [N, Hp]  own w_hh cols, transposed
  float* dgT = wT + N * Hp;              // [N, Bp]  own dgates of step t
  float* dhc = dgT + N * Bp;             // [B, U]   dh carry
  float* dcc = dhc + B * U;              // [B, U]   dc carry
  float* dhp = dcc + B * U;              // [B, U]   (1-m) * dh_tot
  float* red = dhp + B * U;              // [3, B, U] peephole products
  float* part = red + 3 * B * U;         // [2, B, U] reduce halves
  float* gst = part + 2 * B * U;         // dW staging (dw_tile)

  for (int idx = tid; idx < N * Hp; idx += kThreads) {
    const int j = idx / Hp, k = idx % Hp, unit = u0 + j % U;
    wT[idx] = (k < H && unit < H) ? w_hh[(long)k * 4 * H + (j / U) * H + unit]
                                  : 0.f;
  }
  for (int idx = tid; idx < N * Bp; idx += kThreads) dgT[idx] = 0.f;
  for (int idx = tid; idx < B * U; idx += kThreads) dhc[idx] = dcc[idx] = 0.f;
  float ck_acc = 0.f;  // thread tid < 3U: peephole grad (row tid / U)

  const long TH = (long)T * H, T4H = 4 * TH;
  for (int t = T - 1; t >= 0; --t) {
    __syncthreads();
    // ---- phase A: own units
    for (int idx = tid; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U, unit = u0 + u;
      if (unit >= H) {
        for (int r = 0; r < 3; ++r) red[r * B * U + idx] = 0.f;
        continue;
      }
      const long o_s = (long)b * TH + (long)t * H + unit;
      const long o_g = (long)b * T4H + (long)t * 4 * H + unit;
      const float gi = gates[o_g], gf = gates[o_g + H];
      const float gg = gates[o_g + 2 * H], go = gates[o_g + 3 * H];
      const float c_prev = t > 0 ? cseq[o_s - H] : c0[(long)b * H + unit];
      const float c = cseq[o_s];
      const float m = mask[(long)b * T + t];
      const float tanh_c = tanhf(c);
      const float dh_tot = dy[o_s] + dhc[idx];
      const float dc_tot = dyc[o_s] + dcc[idx];
      const float dh = m * dh_tot;
      const float do_pre = dh * tanh_c * go * (1.f - go);
      const float dc = m * dc_tot + dh * go * (1.f - tanh_c * tanh_c) +
                       do_pre * checks[2 * H + unit];
      const float di_pre = dc * gg * gi * (1.f - gi);
      const float df_pre = dc * c_prev * gf * (1.f - gf);
      const float dg_pre = dc * gi * (1.f - gg * gg);
      dxw[o_g] = di_pre;
      dxw[o_g + H] = df_pre;
      dxw[o_g + 2 * H] = dg_pre;
      dxw[o_g + 3 * H] = do_pre;
      dgT[u * Bp + b] = di_pre;
      dgT[(U + u) * Bp + b] = df_pre;
      dgT[(2 * U + u) * Bp + b] = dg_pre;
      dgT[(3 * U + u) * Bp + b] = do_pre;
      dcc[idx] = (1.f - m) * dc_tot + dc * gf + di_pre * checks[unit] +
                 df_pre * checks[H + unit];
      dhp[idx] = (1.f - m) * dh_tot;
      red[idx] = di_pre * c_prev;
      red[B * U + idx] = df_pre * c_prev;
      red[2 * B * U + idx] = do_pre * c;
    }
    __syncthreads();
    if (tid < 3 * U) {
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += red[(tid / U) * B * U + b * U + tid % U];
      ck_acc += s;
    }
    // ---- partial pull-back P_x[b, k] for every hidden unit k, laid
    // out [buf][x][b][Hp].  Thread block: 8 rows b x 4 units k, 3 float4
    // shared loads per 32 FMAs; consecutive threads take consecutive k,
    // so each float4 store instruction writes 512 contiguous bytes.
    float* P = pbuf + ((long)(t & 1) * G + blockIdx.x) * B * Hp;
    const int nkb = Hp / 4, nbb = Bp / 8;
    for (int mt = tid; mt < nkb * nbb; mt += kThreads) {
      const int kb = mt % nkb, bb = mt / nkb;
      float acc[8][4] = {};
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float4 a0 = *reinterpret_cast<const float4*>(dgT + j * Bp + 8 * bb);
        const float4 a1 =
            *reinterpret_cast<const float4*>(dgT + j * Bp + 8 * bb + 4);
        const float4 w = *reinterpret_cast<const float4*>(wT + j * Hp + 4 * kb);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] += av[i] * w.x;
          acc[i][1] += av[i] * w.y;
          acc[i][2] += av[i] * w.z;
          acc[i][3] += av[i] * w.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = 8 * bb + i;
        if (b < B)
          __stcg(reinterpret_cast<float4*>(P + (long)b * Hp + 4 * kb),
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    grid.sync();
    // ---- reduce: dh_prev[b, own units] over the CTAs' partials, the
    // first and second half of the grid summed by separate threads,
    // then added in a fixed order
    const float* Pt = pbuf + (long)(t & 1) * G * B * Hp + u0;
    const long x_stride = (long)B * Hp;
    const int half = (G + 1) / 2;
    for (int it = tid; it < 2 * B; it += kThreads) {
      const int b = it % B, hx = it / B;
      float s[U] = {};
      const int x_end = min(G, (hx + 1) * half);
      for (int x0 = hx * half; x0 < x_end; x0 += kXB) {
        Units<U> v[kXB];   // kXB loads in flight, then summed in order
#pragma unroll
        for (int i = 0; i < kXB; ++i)
          if (x0 + i < x_end) v[i].load(Pt + (x0 + i) * x_stride + (long)b * Hp);
#pragma unroll
        for (int i = 0; i < kXB; ++i)
          if (x0 + i < x_end)
#pragma unroll
            for (int u = 0; u < U; ++u) s[u] += v[i].v[u];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) part[(hx * B + b) * U + u] = s[u];
    }
    __syncthreads();
    for (int idx = tid; idx < B * U; idx += kThreads)
      dhc[idx] = dhp[idx] + (part[idx] + part[B * U + idx]);
  }
  __syncthreads();
  for (int idx = tid; idx < B * U; idx += kThreads) {
    const int b = idx / U, unit = u0 + idx % U;
    if (unit >= H) continue;
    dh0[(long)b * H + unit] = dhc[idx];
    dc0[(long)b * H + unit] = dcc[idx];
  }
  if (tid < 3 * U && u0 + tid % U < H)
    dchecks[(tid / U) * H + u0 + tid % U] = ck_acc;

  // ---- dW_hh[k, c] = sum over rows r = (b, t) of h_{t-1}[b, k] *
  // dgates_t[b, c]: 128 x 64 output tiles spread over the grid
  // (dw_tile); every dxw row was written before the last grid barrier.
  const bool vec = H % 4 == 0;
  const int nkt = (H + dwt::kGK - 1) / dwt::kGK;
  const int n_tiles = nkt * ((4 * H + dwt::kGC - 1) / dwt::kGC);
  auto hrow = [&](int row) -> const float* {   // h_{t-1} of row (b, t)
    return row % T ? hseq + (long)(row - 1) * H : h0 + (long)(row / T) * H;
  };
  auto grow = [&](int row) -> const float* { return dxw + (long)row * 4 * H; };
  for (int tile = blockIdx.x; tile < n_tiles; tile += G)
    dw_tile(hrow, grow, B * T, H, 4 * H, (tile % nkt) * dwt::kGK,
            (tile / nkt) * dwt::kGC, dw, 4 * H, gst, vec, h0);
}

template <int U>
static int launch_bwd(void** args, int B, int H, cudaStream_t stream) {
  const long smem = 4L * U * round_up(H, 4) + 4L * U * round_up(B, 8) +
                    8L * B * U + (long)dwt::kStageFloats;
  return cooperative_launch(lstm_bwd_kernel<U>, H, U, smem, args, stream);
}

extern "C" int lstm_bwd(const float* gates, const float* hseq,
                        const float* cseq, const float* h0, const float* c0,
                        const float* mask, const float* w_hh,
                        const float* checks, const float* dy, const float* dyc,
                        float* dxw, float* dw, float* dchecks, float* dh0,
                        float* dc0, float* pbuf, int B, int T, int H, int U,
                        cudaStream_t stream) {
  void* args[] = {&gates, &hseq, &cseq, &h0,      &c0,  &mask, &w_hh,
                  &checks, &dy,  &dyc,  &dxw,     &dw,  &dchecks,
                  &dh0,   &dc0,  &pbuf, &B,       &T,   &H};
  switch (U) {
    case 1: return launch_bwd<1>(args, B, H, stream);
    case 2: return launch_bwd<2>(args, B, H, stream);
    case 4: return launch_bwd<4>(args, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
