// Fused LSTM forward: the whole time loop of one direction in one launch,
// for H <= 512.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_fwd_kernel (_fwd_call), which
// runs a sequential grid over T on one TPU core with h/c carried in VMEM
// and w_hh resident.  On Hopper the time loop becomes a loop inside a
// persistent cooperative grid of ceil(H / U) CTAs (U hidden units a CTA,
// ops.lstm.units_per_cta), one grid barrier a step:
//
// - CTA x owns hidden units [xU, xU + U).  Its 4U gate columns of w_hh
//   stay in shared memory for all T steps as bf16 hi/lo planes, K-major in
//   the 128-byte swizzle (16 rows: row 4g + u is gate g of unit u, zeros
//   past U, past H and past K; 32 KB at H 512), and the h and c carries of
//   its units stay in shared memory.
// - Step t: gates[b, own cols] = xw_t + h_{t-1} w_hh[:, own cols] for every
//   row b -- a padded row's gates too, from its kept state, as the
//   reference computes them -- on wgmma m64n16k16 (wgmma.cuh), two
//   warpgroups of 64 rows: A = h_{t-1}'s bf16 hi/lo planes ([B, Kp], Kp =
//   H rounded up to 64), read by TMA in boxes of 128 rows x 64 values
//   through a ring of kAStages stages; B = the resident planes; three
//   passes hi*hi + hi*lo + lo*hi, each 64-wide K chunk's sums drained into
//   f32 registers (lstm_wg.cuh's numbers).  The sums pass through shared
//   memory to the gate math of the CTA's units (peepholes i, f on c_{t-1},
//   o on c_t; the masked keep of h and c), which writes H_t, C_t, the
//   gates, and h_t's planes for step t + 1.
// - h's planes alternate between two buffers by step parity: a CTA writes
//   h_t's while another may still read h_{t-1}'s, so one barrier a step
//   suffices.  The planes are written by the generic proxy and read by TMA
//   after the barrier: the writers run fence.proxy.async.global before it.
//
// Every row takes part in every step's product (the gates of a padded step
// are part of the contract), so there are no ranks: row b of the planes is
// batch row b.  Each CTA reads all of h_{t-1}'s planes from L2 a step (256
// KB at B 128, H 512), and xw_t's values are loaded before the product so
// that their latency hides behind it.
//
// Bound on this card: bytes (each input read once, each output written
// once, ~266 MB at B 128, T 100, H 512: ~79 us); the recurrent product of
// the valid row-steps in three bf16 passes, 3 x 19.7 GFLOP at 989 TFLOP/s
// (9406 valid row-steps), takes ~60 us.
#include "lstm_wg.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

namespace {
constexpr int kN = 16;                    // B columns: 4 gates x 4 units
constexpr int kMaxChunks = 8;             // H <= 512: K in 8 chunks of 64
constexpr int kWPlane = kN * 128;         // bytes of a chunk of a w plane
constexpr int kAPlane = lwg::kRows * 128; // bytes of a chunk of an A plane
constexpr int kAStage = 2 * kAPlane;      // A hi, A lo
constexpr int kAStages = 4;
constexpr int kAAhead = kAStages - 1;     // chunks in flight
constexpr int kEp = kN + 1;               // floats a row of the sums
// shared memory: alignment, w's planes, the ring, the sums; then the
// carries (2 B U floats)
constexpr long kFixedBytes = 1024 + 2L * kMaxChunks * kWPlane +
                             (long)kAStages * kAStage +
                             4L * lwg::kRows * kEp;
static_assert(2 * kMaxChunks * kWPlane % 1024 == 0, "the ring's alignment");
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
  __nv_bfloat16* apl;  // [2, 2, B, Kp] h's planes (hi, lo) by step parity
  int B, T, H, Kp;
};

template <int U>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_wg_kernel(
    FwdArgs a, const __grid_constant__ CUtensorMap tm_h0,
    const __grid_constant__ CUtensorMap tm_l0,
    const __grid_constant__ CUtensorMap tm_h1,
    const __grid_constant__ CUtensorMap tm_l1) {
  static_assert(4 * U <= kN, "a CTA's gate columns");
  constexpr int kPairs = (lwg::kRows * U + kThreads - 1) / kThreads;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wpl = wg::align1024(smem_raw);  // [chunk][hi, lo] tiles
  unsigned char* ring = wpl + 2 * kMaxChunks * kWPlane;
  float* ep = reinterpret_cast<float*>(ring + kAStages * kAStage);
  float* hs = ep + lwg::kRows * kEp;   // [B, U]
  float* cs = hs + a.B * U;            // [B, U]
  __shared__ uint64_t full[kAStages];
  __shared__ float ck[3][U];
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int B = a.B, T = a.T, H = a.H, Kp = a.Kp, u0 = blockIdx.x * U;
  const int nch = Kp / lwg::kChunk;
  const long TH = (long)T * H, plane = (long)B * Kp;

  // prologue: w_hh's columns as planes, the carries and h0's planes (the
  // buffer of step 0), the peepholes, the ring's barriers
  if (tid == 0) {
    for (int s = 0; s < kAStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  for (int i = tid; i < Kp * kN; i += kThreads) {
    const int k = i / kN, n = i % kN, u = n % 4, unit = u0 + u;
    const float x = u < U && unit < H && k < H
                        ? a.w_hh[(long)k * 4 * H + n / 4 * H + unit]
                        : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    unsigned char* p = wpl + 2 * (k / lwg::kChunk) * kWPlane +
                       wg::swz<128>(n * 128 + k % lwg::kChunk * 2);
    *reinterpret_cast<__nv_bfloat16*>(p) = hi;
    *reinterpret_cast<__nv_bfloat16*>(p + kWPlane) =
        __float2bfloat16_rn(x - __bfloat162float(hi));
  }
  for (int i = tid; i < B * U; i += kThreads) {
    const int b = i / U, unit = u0 + i % U;
    const float h = unit < H ? a.h0[(long)b * H + unit] : 0.f;
    hs[i] = h;
    cs[i] = unit < H ? a.c0[(long)b * H + unit] : 0.f;
    if (unit < H) put_split(a.apl + (long)b * Kp + unit, plane, h);
  }
  if (tid < 3 * U)
    ck[tid / U][tid % U] =
        u0 + tid % U < H ? a.checks[tid / U * H + u0 + tid % U] : 0.f;
  wg::fence_proxy_async();  // w's planes: generic writes, then wgmma
  fence_proxy_global();
  grid.sync();

  const uint32_t ring_addr = wg::smem_u32(ring), w_addr = wg::smem_u32(wpl);
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const int g8 = lane >> 2, tq = lane & 3;
  uint32_t it = 0;   // chunks this CTA has taken through the ring
  for (int t = 0; t < T; ++t) {
    const CUtensorMap* mh = t % 2 ? &tm_h1 : &tm_h0;
    const CUtensorMap* ml = t % 2 ? &tm_l1 : &tm_l0;
    __nv_bfloat16* next = a.apl + (long)((t + 1) % 2) * 2 * plane;
    for (int r0 = 0; r0 < B; r0 += lwg::kRows) {
      float pre[kPairs][4];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int idx = tid + k * kThreads, b = r0 + idx / U;
        const int unit = u0 + idx % U;
        const bool ok = idx < lwg::kRows * U && b < B && unit < H;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[k][g] =
              ok ? __ldcs(a.xw + 4 * b * TH + (long)t * 4 * H + g * H + unit)
                 : 0.f;
      }
      // chunk i of the block's rows into the ring slot of chunk it + i
      auto load = [&](int i) {
        const int s = (it + i) % kAStages;
        unsigned char* st = ring + s * kAStage;
        wg::mbar_expect(full + s, kAStage);
        wg::tma_load_2d(st, mh, full + s, i * lwg::kChunk, r0);
        wg::tma_load_2d(st + kAPlane, ml, full + s, i * lwg::kChunk, r0);
      };
      if (tid == 0) {
        fence_proxy_global();
        for (int i = 0; i < kAAhead && i < nch; ++i) load(i);
      }
      float acc[8], tot[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = tot[e] = 0.f;
      const bool active = r0 + 64 * wgi < B;
      for (int i = 0; i < nch; ++i) {
        // the slot of chunk i - 1 is free: its products retired before
        // the last __syncthreads
        if (tid == 0 && i + kAAhead < nch) load(i + kAAhead);
        const uint32_t j = it + i;
        wg::mbar_wait(full + j % kAStages, (j / kAStages) & 1);
        if (active) {
          const uint32_t sb = ring_addr + (j % kAStages) * kAStage;
          const uint64_t ah = wg::desc<128>(sb + wgi * 64 * 128, 16, 1024);
          const uint64_t al = ah + (kAPlane >> 4);
          const uint64_t bh =
              wg::desc<128>(w_addr + 2 * i * kWPlane, 16, 1024);
          const uint64_t bl = bh + (kWPlane >> 4);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < lwg::kChunk / 16; ++kk) {
            wg::mma_ss_n16(acc, ah + 2 * kk, bh + 2 * kk, kk > 0);
            wg::mma_ss_n16(acc, ah + 2 * kk, bl + 2 * kk, 1);
            wg::mma_ss_n16(acc, al + 2 * kk, bh + 2 * kk, 1);
          }
          wg::commit();
          wg::wait<0>();
          wg::fence_acc<8>(acc);
#pragma unroll
          for (int e = 0; e < 8; ++e) tot[e] += acc[e];
        }
        __syncthreads();
      }
      it += nch;
      // the sums: accumulator rows g8 and g8 + 8 of warp wq's 16, columns
      // 8 jb + 2 tq, + 1
      if (active) {
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          float* row = ep + (64 * wgi + 16 * wq + g8 + 8 * h8) * kEp;
#pragma unroll
          for (int jb = 0; jb < 2; ++jb) {
            row[8 * jb + 2 * tq] = tot[4 * jb + 2 * h8];
            row[8 * jb + 2 * tq + 1] = tot[4 * jb + 2 * h8 + 1];
          }
        }
      }
      __syncthreads();
      // the gate math of the block's (row, unit) pairs
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int idx = tid + k * kThreads, r = idx / U, u = idx % U;
        const int b = r0 + r, unit = u0 + u;
        if (idx >= lwg::kRows * U || b >= B || unit >= H) continue;
        const float* q = ep + r * kEp + u;
        const float c_prev = cs[b * U + u], h_prev = hs[b * U + u];
        const float i = sigm(pre[k][0] + q[0] + c_prev * ck[0][u]);
        const float f = sigm(pre[k][1] + q[4] + c_prev * ck[1][u]);
        const float gg = tanhf(pre[k][2] + q[8]);
        const float cn = f * c_prev + i * gg;
        const float o = sigm(pre[k][3] + q[12] + cn * ck[2][u]);
        const float hn = o * tanhf(cn);
        const float m = a.mask[(long)b * T + t];
        const float h = m * hn + (1.f - m) * h_prev;
        const float c = m * cn + (1.f - m) * c_prev;
        hs[b * U + u] = h;
        cs[b * U + u] = c;
        const long o_s = b * TH + (long)t * H + unit;
        a.hseq[o_s] = h;
        a.cseq[o_s] = c;
        float* go = a.gates + 4 * b * TH + (long)t * 4 * H + unit;
        __stcs(go, i);
        __stcs(go + H, f);
        __stcs(go + 2 * H, gg);
        __stcs(go + 3 * H, o);
        if (t + 1 < T) put_split(next + (long)b * Kp + unit, plane, h);
      }
      __syncthreads();  // the sums' buffer is the next block's
    }
    fence_proxy_global();
    if (t + 1 < T) grid.sync();  // step
  }
}

// Scratch: apl [2, 2, B, Kp] bf16 (h's hi and lo planes, two buffers by
// step parity; Kp = H rounded up to 64).  U in {1, 2, 4}; H <= 512.
extern "C" int lstm_fwd(const float* xw, const float* mask, const float* w_hh,
                        const float* checks, const float* h0, const float* c0,
                        float* hseq, float* cseq, float* gates, void* apl,
                        int B, int T, int H, int U, cudaStream_t stream) {
  if (H < 1 || H > kMaxChunks * lwg::kChunk) return (int)cudaErrorInvalidValue;
  const int Kp = round_up(H, lwg::kChunk);
  auto* planes = static_cast<__nv_bfloat16*>(apl);
  CUtensorMap tm[4];
  for (int q = 0; q < 4; ++q)
    if (!plane_map(tm + q, planes + (long)q * B * Kp, B, H, Kp))
      return (int)cudaErrorInvalidValue;
  FwdArgs a{xw, mask, w_hh, checks, h0, c0, hseq, cseq, gates, planes,
            B,  T,    H,    Kp};
  void* args[] = {&a, tm, tm + 1, tm + 2, tm + 3};
  const long smem_floats = (kFixedBytes + 8L * B * U) / 4;
  switch (U) {
    case 1:
      return cooperative_launch(lstm_fwd_wg_kernel<1>, H, 1, smem_floats,
                                args, stream);
    case 2:
      return cooperative_launch(lstm_fwd_wg_kernel<2>, H, 2, smem_floats,
                                args, stream);
    case 4:
      return cooperative_launch(lstm_fwd_wg_kernel<4>, H, 4, smem_floats,
                                args, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
