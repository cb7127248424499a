// Hidden-blocked LSTM forward: the whole time loop of one direction in
// one launch, for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_fwd_kernel_blocked
// (_fwd_call_blocked).  The TPU kernel runs a sequential grid (T, H/128):
// for each step it streams w_hh as [H, 4*128] column blocks while the
// full [B, H] h/c state carries in VMEM.  On Hopper the step runs on a
// persistent cooperative grid, on lstm_wg.cuh's tensor-core step product:
//
// - gates_t = xw_t + h_{t-1} w_hh is C[rows, cols] = A[rows, K] B[cols,
//   K]^T with A = h_{t-1}'s bf16 hi/lo planes ([B, Kp], K = H, Kp = H
//   rounded up to 64) in step t's compacted row order, and B = w_hh's
//   transpose as planes [N, Kp] that the prologue writes straight from
//   w_hh (through shared memory, read along w_hh's rows).  N = 4 Hu, Hu =
//   H rounded up to 32: the kernel orders B's rows unit block x gate x
//   unit (row 128 ub + 32 g + u is gate g of unit 32 ub + u, zeros past
//   H), so a 128-column tile holds all four gates of its 32 units.
// - Tiles of 128 compacted rows x 128 columns x one K slice (the wrapper
//   picks the slices: at B 128, H 1280, 40 column blocks x 3 slices of 7
//   chunks, 120 tiles; at H 2048, 64 x 2 of 16, 128) write their sums by
//   slice; after a grid barrier each (row, unit) pair adds xw_t and the
//   slices in order, runs the gate math (peepholes i, f on c_{t-1}, o on
//   c_t; the masked keep of h and c) and writes H, C and the gates, and
//   h_t's planes at the row's rank in step t + 1's order.  Every row
//   valid at t + 1 gets its planes, a row padded at t too (its kept
//   state).  A padded step keeps h and c, skips its product and writes
//   its gates as 0 (the backward's masked split never reads them).
// - The prologue writes h0's planes in step 0's order.  Two grid barriers
//   a step (tiles | pairs | the next step's tiles).  The carries are the
//   kept sequences themselves: h_{t-1} and c_{t-1} are read back from H
//   and C, so no state lives in a CTA between steps.
//
// xw, the gates, H and C are fp32 here; the port's wrapper casts a bf16
// xw to fp32 (exactly) before the launch, and the gate math is fp32, as in
// the TPU kernel.  The products are three bf16 passes of the f32 operands'
// hi and lo parts, each 64-wide K chunk drained into f32 (lstm_wg.cuh).
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H flops in
// three bf16 passes; at the bench feed (B 128, T 100, lengths in [50,
// 100], 9406 valid row-steps) and H = 1280, 3 x 123.3 GFLOP at 989
// TFLOP/s: 374.0 us (1.84 ms at the fp32 rate).  Per step the tiles read
// 40 x A's slice planes (26 MB in all) and w_hh's planes (26 MB) from L2.
#include "lstm_wg.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

namespace {
constexpr int kCta = 384;                // three warpgroups
constexpr int kUnits = lwg::kCols / 4;   // hidden units a column block
constexpr int kTk = 256;                 // k values of a transpose tile
}  // namespace

struct FwdArgs {
  const float* xw;
  const float* mask;
  const float* w_hh;
  const float* checks;
  const float* h0;
  const float* c0;
  float* hseq;
  float* cseq;
  float* gates;
  float* part;  // [S, B, N] the step product by K slice, compacted rows
  int* rank;    // [T, B] row b's rank among step t's valid rows (-1
                // padded), then [T] the counts
  __nv_bfloat16* wpl;  // [2, N, Kp] w_hh^T's planes (hi, lo)
  __nv_bfloat16* apl;  // [2, B, Kp] h planes (hi, lo), compacted
  int B, T, H, Kp, N;
};

// w_hh^T's planes: wpl[n][k] = w_hh[k][g H + 32 ub + u] for n = 128 ub +
// 32 g + u (0 past H).  Tiles of 32 plane rows x kTk values pass through
// shared memory (tile, kTk x 33 floats): read along w_hh's rows, written
// along the planes' rows.
__device__ __forceinline__ void split_w_t(const FwdArgs& a, float* tile) {
  const int H = a.H;
  const int nkb = (H + kTk - 1) / kTk, n_tiles = a.N / 32 * nkb;
  const long lo = (long)a.N * a.Kp;
  for (int tt = blockIdx.x; tt < n_tiles; tt += gridDim.x) {
    const int nb = tt / nkb, k0 = tt % nkb * kTk;
    const int col = nb % 4 * H + nb / 4 * kUnits;  // w_hh column of u = 0
    const int units = min(kUnits, H - nb / 4 * kUnits);
    __syncthreads();  // the last tile is written out
#pragma unroll 4
    for (int i = threadIdx.x; i < kTk * 32; i += kCta) {
      const int kk = i / 32, u = i % 32, k = k0 + kk;
      tile[kk * 33 + u] = u < units && k < H
                              ? __ldg(a.w_hh + (long)k * 4 * H + col + u)
                              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < kTk * 32; i += kCta) {
      const int u = i / kTk, kk = i % kTk, k = k0 + kk;
      if (k < H)
        put_split(a.wpl + (long)(32 * nb + u) * a.Kp + k, lo,
                  tile[kk * 33 + u]);
    }
  }
}

// A (row, unit) pair p = b * H + unit of step t, as far as it goes before
// the slices' sums: its ranks at t and t + 1 (-1: padded), h_{t-1},
// c_{t-1}, the mask and xw_t (pre, which the sums then join).
struct Pair {
  long o_s, o_g;
  int unit, r, r1;
  float h_prev, c_prev, m, pre[4];
};

__device__ __forceinline__ void pair_in(const FwdArgs& a, int t, long p,
                                        Pair& v) {
  const int H = a.H, T = a.T, B = a.B, b = (int)(p / H);
  v.unit = (int)(p % H);
  v.r = __ldcg(a.rank + (long)t * B + b);
  v.r1 = t + 1 < T ? __ldcg(a.rank + (long)(t + 1) * B + b) : -1;
  v.o_s = b * (long)T * H + (long)t * H + v.unit;
  v.o_g = 4 * b * (long)T * H + (long)t * 4 * H + v.unit;
  v.h_prev = t == 0 ? a.h0[p] : __ldcg(a.hseq + v.o_s - H);
  v.c_prev = t == 0 ? a.c0[p] : __ldcg(a.cseq + v.o_s - H);
  v.m = a.mask[(long)b * T + t];
#pragma unroll
  for (int g = 0; g < 4; ++g) v.pre[g] = __ldcs(a.xw + v.o_g + g * H);
}

// The pair's row of the step product in slice 0 (a padded row reads row
// 0's sums and drops them: no branch in the loads).
__device__ __forceinline__ const float* pair_sums(const FwdArgs& a,
                                                  const Pair& v) {
  return a.part + (long)max(v.r, 0) * a.N + v.unit / kUnits * lwg::kCols +
         v.unit % kUnits;
}

// The gate math, the masked keep, and the pair's outputs: H, C, the
// gates (0 when padded) and h_t's planes at the row's rank at t + 1.
__device__ __forceinline__ void pair_out(const FwdArgs& a, const Pair& v) {
  const int H = a.H;
  float h = v.h_prev, c = v.c_prev, i = 0.f, f = 0.f, gg = 0.f, o = 0.f;
  if (v.r >= 0) {
    i = sigm(v.pre[0] + v.c_prev * a.checks[v.unit]);
    f = sigm(v.pre[1] + v.c_prev * a.checks[H + v.unit]);
    gg = tanhf(v.pre[2]);
    const float cn = f * v.c_prev + i * gg;
    o = sigm(v.pre[3] + cn * a.checks[2 * H + v.unit]);
    const float hn = o * tanhf(cn);
    h = v.m * hn + (1.f - v.m) * v.h_prev;
    c = v.m * cn + (1.f - v.m) * v.c_prev;
  }
  a.hseq[v.o_s] = h;
  a.cseq[v.o_s] = c;
  __stcs(a.gates + v.o_g, i);
  __stcs(a.gates + v.o_g + H, f);
  __stcs(a.gates + v.o_g + 2 * H, gg);
  __stcs(a.gates + v.o_g + 3 * H, o);
  if (v.r1 >= 0)
    put_split(a.apl + (long)v.r1 * a.Kp + v.unit, (long)a.B * a.Kp, h);
}

__global__ void __launch_bounds__(kCta, 1) lstm_fwd_blocked_kernel(
    FwdArgs a, const __grid_constant__ CUtensorMap tm_ahi,
    const __grid_constant__ CUtensorMap tm_alo,
    const __grid_constant__ CUtensorMap tm_whi,
    const __grid_constant__ CUtensorMap tm_wlo, int n_slices, int cps) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  __shared__ uint64_t full[lwg::kStages];
  __shared__ int warp_n[kCta / 32];
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, H = a.H;
  const long BH = (long)B * H;
  const long first = (long)blockIdx.x * kCta + tid;
  const long stride = (long)gridDim.x * kCta;

  // prologue: w_hh^T's planes, the step ranks, the ring's barriers; then
  // h0's planes in step 0's order
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
    if (r >= 0)
      put_split(a.apl + (long)r * a.Kp + p % H, (long)B * a.Kp, a.h0[p]);
  }
  fence_proxy_global();
  grid.sync();

  const int n_cb = a.N / lwg::kCols;
  Tiles tl{&tm_ahi, &tm_alo, &tm_whi, &tm_wlo, ring, full, n_slices, cps,
           a.Kp / lwg::kChunk, n_cb,
           (B + lwg::kRows - 1) / lwg::kRows * n_cb * n_slices, 0u, -1};
  const long slice = (long)B * a.N;  // floats of one slice's sums
  for (int t = 0; t < T; ++t) {
    tl.step(__ldcg(a.rank + (long)T * B + t), a.part, B, a.N, a.N);
    if (tid == 0 && t + 1 < T) tl.ahead(__ldcg(a.rank + (long)T * B + t + 1));
    grid.sync();  // step
    // two pairs an iteration (the second clamped onto the first past BH):
    // both pairs' loads, then both's slice sums, in slice order, then
    // both's arithmetic -- the phase waits on L2, not on operations
    for (long p = first; p < BH; p += 2 * stride) {
      Pair v0, v1;
      pair_in(a, t, p, v0);
      pair_in(a, t, p + stride < BH ? p + stride : p, v1);
      const float* q0 = pair_sums(a, v0);
      const float* q1 = pair_sums(a, v1);
      for (int sl = 0; sl < n_slices; ++sl)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          v0.pre[g] += __ldcg(q0 + sl * slice + g * kUnits);
          v1.pre[g] += __ldcg(q1 + sl * slice + g * kUnits);
        }
      pair_out(a, v0);
      pair_out(a, v1);
    }
    fence_proxy_global();
    if (t + 1 < T) grid.sync();  // step
  }
}

// Scratch: part [n_slices, B, N] f32 (N = 4 Hu, Hu = H rounded up to
// 32); rank T*B + T ints; wpl [2, N, Kp] and apl [2, B, Kp] bf16, Kp = H
// rounded up to 64.  n_slices cuts the ceil(H / 64) chunks of K into
// slices of ceil(chunks / n_slices), none empty.
extern "C" int lstm_fwd_blocked(const float* xw, const float* mask,
                                const float* w_hh, const float* checks,
                                const float* h0, const float* c0, float* hseq,
                                float* cseq, float* gates, float* part,
                                int* rank, void* wpl, void* apl, int B, int T,
                                int H, int n_slices, cudaStream_t stream) {
  const int Kp = round_up(H, lwg::kChunk), N = 4 * round_up(H, kUnits);
  int cps = slice_chunks(Kp / lwg::kChunk, n_slices);
  if (cps < 0) return (int)cudaErrorInvalidValue;
  auto* w_planes = static_cast<__nv_bfloat16*>(wpl);
  auto* a_planes = static_cast<__nv_bfloat16*>(apl);
  CUtensorMap tm_ahi, tm_alo, tm_whi, tm_wlo;
  if (!plane_map(&tm_ahi, a_planes, B, H, Kp) ||
      !plane_map(&tm_alo, a_planes + (long)B * Kp, B, H, Kp) ||
      !plane_map(&tm_whi, w_planes, N, H, Kp) ||
      !plane_map(&tm_wlo, w_planes + (long)N * Kp, N, H, Kp))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{xw,   mask, w_hh,     checks,   h0, c0, hseq, cseq, gates,
            part, rank, w_planes, a_planes, B,  T,  H,    Kp,   N};
  void* args[] = {&a, &tm_ahi, &tm_alo, &tm_whi, &tm_wlo, &n_slices, &cps};
  return launch_resident(lstm_fwd_blocked_kernel, kCta, args, stream);
}
