// Hidden-blocked LSTM backward (BPTT without dW), for 512 < H.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_bwd_kernel_blocked
// (_bwd_call_blocked): the reversed time loop with the dh/dc carries,
// writing dxw (= dgates) every step and dh0/dc0 at the end.  dW_hh is
// lstm_dw_blocked.cu's product over the dxw this kernel writes, and the
// peephole grads are reductions over dxw in the wrapper, as in the TPU
// tier.
//
// The one cross-unit coupling is the recurrent pull-back
// dh_prev = dgates_t @ w_hh^T, [rows, 4H] x [4H, H].  Here it is a plain
// TN product on the tensor cores (wgmma.cuh): C[rows, units] =
// A[rows, K] B[units, K]^T with A = dgates_t and B = w_hh's rows, both
// K-major (K = 4H contiguous), both read by TMA in the 128-byte swizzle.
//
// Numbers.  The contract is f32.  Each f32 operand is carried as hi =
// bf16(x) and lo = bf16(x - hi), and a product as hi*hi + hi*lo + lo*hi
// (three bf16 passes, f32 accumulators); each 64-wide K chunk's sums
// leave the accumulators for IEEE f32 adds into registers, so the tensor
// cores' accumulation error stays that of one chunk (dw_wg.cuh's rule).
//
// Operands the kernel writes itself, once: w_hh's hi and lo planes
// ([H, Kp] bf16 each, Kp = 4H rounded up to 64, the pitch of a whole
// swizzle row) in a prologue, since w_hh does not change over T; and
// dgates_t's planes ([B, Kp] each), written by phase A beside the f32 dxw
// in compacted order: the rows valid at step t first, by rank (a table
// of ranks and counts a step, also made in the prologue).  So the
// product loads ready planes, a step runs ceil(n_t / 64) row blocks of
// 64 over contiguous rows, and padded rows (exact zero dgates) cost
// nothing.  TMA reads past 4H and past the planes' rows as zeros, so any
// H (H % 4 != 0 too) and any B take the same path.
//
// Tiles: 128 compacted rows x 128 units x one K slice of `cps` chunks
// (the wrapper picks n_slices so that the tiles of a 128-row block about
// fill the co-resident CTAs: at B 128, H 1280, 10 unit blocks x 12
// slices of 7 chunks, 120 tiles).  Warpgroup w < 2 takes rows 64w .. 64w
// + 63 of the tile (64 x 128 f32 accumulators and their running sum); a
// ring of three stages of four planes (A hi, A lo, B hi, B lo: 128 rows x
// 64 values each, 64 KB a stage) keeps two chunks in flight.  w_hh's
// planes of a CTA's next tile's first two chunks do not depend on the
// step: they are asked for before the step's barrier, so only the
// dgates' wait after it.  A tile writes its slice's sums into
// part[slice] (8-byte stores); after the grid barrier each valid (row,
// unit) pair adds the slices in order -- a fixed order, no atomics.
// w_hh's planes (26 MB at H 1280) stream from L2: held in shared memory
// they would leave no room for A's ring.
//
// A persistent cooperative grid (one CTA an SM, three warpgroups: the
// third only works on the pairs, whose phase wants threads in flight
// more than registers) walks the tiles with its stride, then the (row,
// unit) pairs with its thread stride:
//
//   prologue: w_hh's planes; the step ranks; barrier
//             phase A of step T-1 for every pair (zero carries); barrier
//   for t = T-1 .. 0:
//     per tile: part[slice] = pull-back of dgates_t's planes
//     barrier
//     per pair: dh = (1-m) dh_tot (step t) + part[0..S) (valid rows);
//               t > 0: phase A of step t-1 with carries (dh, dc) --
//               dgates_{t-1} into dxw and its planes, the new dc and
//               (1-m) dh_tot into scratch; t = 0: dh0, dc0
//     barrier
//
// Phase A is the TPU kernel's gate-derivative arithmetic: the external
// dy/dyc join the carries before the masked split, peepholes i, f on
// c_prev and o on c.  What it reads once (gates, dy, dyc) and dxw pass
// L2 with the streaming hint, so they do not push out the planes.
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H flops in
// three bf16 passes: 374.0 us at the bench feed (9406 valid row-steps)
// and H = 1280 (1.84 ms at the fp32 rate).
#include <cuda_bf16.h>

#include "lstm_common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;
using namespace lstm;

namespace lbw {
constexpr int kCta = 384;                  // threads: three warpgroups
constexpr int kRows = 128;                 // compacted rows of a tile
constexpr int kUnits = 128;                // hidden units of a tile
constexpr int kChunk = 64;                 // K values a chunk (128 bytes)
constexpr int kPlane = kRows * 128;        // bytes of one plane's chunk
constexpr int kStage = 4 * kPlane;         // A hi, A lo, B hi, B lo
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;        // chunks in flight
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStage;
static_assert(kUnits == kRows, "one box shape serves both operands");
}  // namespace lbw

struct BwdArgs {
  const float* gates;
  const float* cseq;
  const float* c0;
  const float* mask;
  const float* checks;
  const float* dy;
  const float* dyc;
  float* dxw;
  float* dhp;   // [B, H] (1-m) * dh_tot of the last phase A
  float* dcc;   // [B, H] dc carry
  float* part;  // [S, B, H] the pull-back by K slice, compacted rows
  int* rank;    // [T, B] row b's rank among step t's valid rows (-1
                // padded), then [T] the counts
  __nv_bfloat16* apl;  // [2, B, Kp] dgates planes (hi, lo), compacted
  int B, T, H, Kp;
};

// Orders this thread's generic writes to global memory before later
// reads of them by the async proxy (the TMA loads of the planes).
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// x as hi = bf16(x) at p[0] and lo = bf16(x - hi) at p[lo].
__device__ __forceinline__ void put_split(__nv_bfloat16* p, long lo,
                                          float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  p[0] = h;
  p[lo] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// Step s for (b, unit) with incoming carries dh_c, dc_c; r is row b's
// rank among step s's valid rows (-1: padded, no planes written).
__device__ __forceinline__ void phase_a(const BwdArgs& a, int s, int b,
                                        int unit, float dh_c, float dc_c,
                                        int r) {
  const int H = a.H;
  const long TH = (long)a.T * H;
  const long o_s = b * TH + (long)s * H + unit;
  const long o_g = 4 * b * TH + (long)s * 4 * H + unit;
  const float gi = __ldcs(a.gates + o_g), gf = __ldcs(a.gates + o_g + H);
  const float gg = __ldcs(a.gates + o_g + 2 * H);
  const float go = __ldcs(a.gates + o_g + 3 * H);
  const float c_prev = s > 0 ? a.cseq[o_s - H] : a.c0[(long)b * H + unit];
  const float c = a.cseq[o_s];
  const float m = a.mask[(long)b * a.T + s];
  const float tanh_c = tanhf(c);
  const float dh_tot = __ldcs(a.dy + o_s) + dh_c;
  const float dc_tot = __ldcs(a.dyc + o_s) + dc_c;
  const float dh = m * dh_tot;
  const float do_pre = dh * tanh_c * go * (1.f - go);
  const float dc = m * dc_tot + dh * go * (1.f - tanh_c * tanh_c) +
                   do_pre * a.checks[2 * H + unit];
  const float di_pre = dc * gg * gi * (1.f - gi);
  const float df_pre = dc * c_prev * gf * (1.f - gf);
  const float dg_pre = dc * gi * (1.f - gg * gg);
  __stcs(a.dxw + o_g, di_pre);
  __stcs(a.dxw + o_g + H, df_pre);
  __stcs(a.dxw + o_g + 2 * H, dg_pre);
  __stcs(a.dxw + o_g + 3 * H, do_pre);
  if (r >= 0) {
    __nv_bfloat16* p = a.apl + (long)r * a.Kp + unit;
    const long lo = (long)a.B * a.Kp;
    put_split(p, lo, di_pre);
    put_split(p + H, lo, df_pre);
    put_split(p + 2 * H, lo, dg_pre);
    put_split(p + 3 * H, lo, do_pre);
  }
  const long o_c = (long)b * H + unit;
  a.dcc[o_c] = (1.f - m) * dc_tot + dc * gf + di_pre * a.checks[unit] +
               df_pre * a.checks[H + unit];
  a.dhp[o_c] = (1.f - m) * dh_tot;
}

// Ranks of step s's rows among its valid ones (mask != 0), ascending b:
// rank[s * B + b] (-1 when padded) and the count at rank[T * B + s].
__device__ __forceinline__ void step_ranks(const float* mask, int B, int T,
                                           int s, int* rank, int* warp_n) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += lbw::kCta) {
    const int b = b0 + tid;
    const bool v = b < B && mask[(long)b * T + s] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_n[w] = __popc(bal);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int k = 0; k < lbw::kCta / 32; ++k) {
      if (k < w) before += warp_n[k];
      all += warp_n[k];
    }
    if (b < B)
      rank[(long)s * B + b] =
          v ? base + before + __popc(bal & ((1u << lane) - 1u)) : -1;
    base += all;
    __syncthreads();
  }
  if (threadIdx.x == 0) rank[(long)T * B + s] = base;
}

__global__ void __launch_bounds__(lbw::kCta, 1) lstm_bwd_blocked_kernel(
    BwdArgs a, const __grid_constant__ CUtensorMap tm_ahi,
    const __grid_constant__ CUtensorMap tm_alo,
    const __grid_constant__ CUtensorMap tm_whi,
    const __grid_constant__ CUtensorMap tm_wlo,
    const float* __restrict__ w_hh, __nv_bfloat16* wpl, float* dh0,
    float* dc0, int n_slices, int cps) {
  using lbw::kAhead, lbw::kChunk, lbw::kPlane, lbw::kStage, lbw::kStages;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  __shared__ uint64_t full[kStages];
  __shared__ int warp_n[lbw::kCta / 32];
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int B = a.B, T = a.T, H = a.H, K = 4 * H;
  const long BH = (long)B * H;
  const long first = (long)blockIdx.x * lbw::kCta + tid;
  const long stride = (long)gridDim.x * lbw::kCta;

  // prologue: w_hh's planes, the step ranks, the ring's barriers
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  for (long i = first; i < (long)H * K; i += stride)
    put_split(wpl + i / K * a.Kp + i % K, (long)H * a.Kp, w_hh[i]);
  for (int s = blockIdx.x; s < T; s += gridDim.x)
    step_ranks(a.mask, B, T, s, a.rank, warp_n);
  fence_proxy_global();
  grid.sync();
  for (long p = first; p < BH; p += stride) {
    const int b = (int)(p / H);
    phase_a(a, T - 1, b, (int)(p % H), 0.f, 0.f,
            __ldcg(a.rank + (long)(T - 1) * B + b));
  }
  fence_proxy_global();
  grid.sync();

  const int nch = a.Kp / kChunk;
  const int n_ub = (H + lbw::kUnits - 1) / lbw::kUnits;
  const int n_tiles = (B + lbw::kRows - 1) / lbw::kRows * n_ub * n_slices;
  const uint32_t ring_addr = wg::smem_u32(ring);
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  uint32_t it = 0;  // chunks this CTA has taken through the ring
  int pf_tile = -1;  // (thread 0) the tile whose first w_hh boxes are asked
  // a tile's first compacted row, K slice and first unit
  auto decode = [&](int tile, int& r0, int& sl, int& u0) {
    sl = tile % n_slices;
    u0 = tile / n_slices % n_ub * lbw::kUnits;
    r0 = tile / (n_slices * n_ub) * lbw::kRows;
  };
  // w_hh's planes of the chunk at k0, units u0.., into ring slot s
  auto load_w = [&](int s, int k0, int u0) {
    unsigned char* st = ring + s * kStage;
    wg::tma_load_2d(st + 2 * kPlane, &tm_whi, full + s, k0, u0);
    wg::tma_load_2d(st + 3 * kPlane, &tm_wlo, full + s, k0, u0);
  };

  for (int t = T - 1; t >= 0; --t) {
    const int n = __ldcg(a.rank + (long)T * B + t);  // valid rows at t
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int r0, sl, u0;
      decode(tile, r0, sl, u0);
      if (r0 >= n) continue;
      const int c0 = sl * cps, nc = min(cps, nch - c0);
      // chunk c0 + i into the ring slot of the CTA's chunk it + i
      auto load = [&](int i, bool with_w) {
        const int s = (it + i) % kStages, k0 = (c0 + i) * kChunk;
        unsigned char* st = ring + s * kStage;
        wg::mbar_expect(full + s, kStage);
        wg::tma_load_2d(st, &tm_ahi, full + s, k0, r0);
        wg::tma_load_2d(st + kPlane, &tm_alo, full + s, k0, r0);
        if (with_w) load_w(s, k0, u0);
      };
      if (tid == 0) {
        fence_proxy_global();
        for (int i = 0; i < kAhead && i < nc; ++i) load(i, tile != pf_tile);
        pf_tile = -1;
      }
      float acc[64], tot[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
      const bool active = wgi < 2 && r0 + 64 * wgi < n;
      for (int i = 0; i < nc; ++i) {
        // the slot of chunk i - 1 is free: its products retired before
        // the last barrier
        if (tid == 0 && i + kAhead < nc) load(i + kAhead, true);
        const uint32_t j = it + i;
        wg::mbar_wait(full + j % kStages, (j / kStages) & 1);
        if (active) {
          const uint32_t sb = ring_addr + (j % kStages) * kStage;
          const uint64_t ah = wg::desc<128>(sb + wgi * 64 * 128, 16, 1024);
          const uint64_t al = ah + (kPlane >> 4);
          const uint64_t bh = wg::desc<128>(sb + 2 * kPlane, 16, 1024);
          const uint64_t bl = bh + (kPlane >> 4);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {  // 32 bytes a k step
            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, bh + 2 * kk, kk > 0);
            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, bl + 2 * kk, 1);
            wg::mma_ss_n128<0, 0>(acc, al + 2 * kk, bh + 2 * kk, 1);
          }
          wg::commit();
          wg::wait<0>();
          wg::fence_acc<64>(acc);
#pragma unroll
          for (int e = 0; e < 64; ++e) tot[e] += acc[e];
        }
        __syncthreads();
      }
      it += nc;
      // accumulator rows g and g + 8 of warp wq's 16, columns 8j + 2tq, + 1
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int row = r0 + 64 * wgi + 16 * wq + g + 8 * h8;
        if (row >= n || wgi >= 2) continue;
        float* dst = a.part + ((long)sl * B + row) * H;
#pragma unroll
        for (int jb = 0; jb < 16; ++jb) {
          const int u = u0 + 8 * jb + 2 * tq;
          const float v0 = tot[4 * jb + 2 * h8], v1 = tot[4 * jb + 2 * h8 + 1];
          if (H % 2 == 0 && u + 1 < H) {   // 8-byte aligned pairs
            *reinterpret_cast<float2*>(dst + u) = make_float2(v0, v1);
          } else {
            if (u < H) dst[u] = v0;
            if (u + 1 < H) dst[u + 1] = v1;
          }
        }
      }
    }
    // w_hh's planes of the first chunks of this CTA's first tile at step
    // t - 1 into their slots now (they do not depend on the step); their
    // bytes count on the slots' barriers before the arrivals expect them
    if (tid == 0 && t > 0) {
      const int n1 = __ldcg(a.rank + (long)T * B + t - 1);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int r0, sl, u0;
        decode(tile, r0, sl, u0);
        if (r0 >= n1) continue;
        // exactly the chunks the tile's first loads take (load(i, false))
        for (int i = 0; i < kAhead && i < min(cps, nch - sl * cps); ++i)
          load_w((it + i) % kStages, (sl * cps + i) * kChunk, u0);
        pf_tile = tile;
        break;
      }
    }
    grid.sync();  // step
    for (long p = first; p < BH; p += stride) {
      const int b = (int)(p / H), unit = (int)(p % H);
      float dh = __ldcg(a.dhp + p);
      const int r = __ldcg(a.rank + (long)t * B + b);
      if (r >= 0)
        for (int sl = 0; sl < n_slices; ++sl)
          dh += __ldcg(a.part + ((long)sl * B + r) * H + unit);
      const float dc = __ldcg(a.dcc + p);
      if (t > 0) {
        phase_a(a, t - 1, b, unit, dh, dc,
                __ldcg(a.rank + (long)(t - 1) * B + b));
      } else {
        dh0[p] = dh;
        dc0[p] = dc;
      }
    }
    fence_proxy_global();
    if (t > 0) grid.sync();  // step
  }
}

namespace {

// A [rows, 4H] bf16 plane of pitch Kp as a 2-d tensor map: boxes of
// 128 rows x 64 values (128 bytes, the swizzle's row); TMA reads past 4H
// and past `rows` as zeros.
bool plane_map(CUtensorMap* m, const void* base, int rows, int H, int Kp) {
  const uint64_t dims[2] = {(uint64_t)4 * H, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)Kp * 2};
  const uint32_t box[2] = {lbw::kChunk, lbw::kRows};
  return wg::tma_map(m, base, 2, dims, strides, box, 128);
}

}  // namespace

// Scratch: dhp, dcc [B, H]; part [n_slices, B, H]; rank T*B + T ints;
// wpl [2, H, Kp] and apl [2, B, Kp] bf16, Kp = 4H rounded up to 64.
// n_slices cuts the ceil(4H / 64) chunks of K into slices of
// ceil(chunks / n_slices), none empty.
extern "C" int lstm_bwd_blocked(const float* gates, const float* cseq,
                                const float* c0, const float* mask,
                                const float* w_hh, const float* checks,
                                const float* dy, const float* dyc, float* dxw,
                                float* dh0, float* dc0, float* dhp,
                                float* dcc, float* part, int* rank,
                                void* wpl, void* apl, int B, int T, int H,
                                int n_slices, cudaStream_t stream) {
  const int Kp = round_up(4 * H, lbw::kChunk), nch = Kp / lbw::kChunk;
  if (n_slices < 1 || n_slices > nch) return (int)cudaErrorInvalidValue;
  const int cps = (nch + n_slices - 1) / n_slices;
  if ((n_slices - 1) * cps >= nch) return (int)cudaErrorInvalidValue;
  auto* w_planes = static_cast<__nv_bfloat16*>(wpl);
  auto* a_planes = static_cast<__nv_bfloat16*>(apl);
  CUtensorMap tm_ahi, tm_alo, tm_whi, tm_wlo;
  if (!plane_map(&tm_ahi, a_planes, B, H, Kp) ||
      !plane_map(&tm_alo, a_planes + (long)B * Kp, B, H, Kp) ||
      !plane_map(&tm_whi, w_planes, H, H, Kp) ||
      !plane_map(&tm_wlo, w_planes + (long)H * Kp, H, H, Kp))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{gates, cseq, c0,   mask, checks,   dy, dyc, dxw, dhp,
            dcc,   part, rank, a_planes, B, T,  H,   Kp};
  void* args[] = {&a,    &tm_ahi, &tm_alo, &tm_whi, &tm_wlo,   &w_hh,
                  &w_planes, &dh0, &dc0,  &n_slices, (void*)&cps};
  // one CTA an SM (the ring takes most of its shared memory), every one
  // co-resident: the pairs' loop runs on all of them
  const long resident = resident_ctas(
      lstm_bwd_blocked_kernel, lbw::kSmemBytes / sizeof(float), lbw::kCta);
  if (resident < 0) return (int)-resident;
  if (resident == 0) return -1;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)lstm_bwd_blocked_kernel, dim3((unsigned)resident),
      dim3(lbw::kCta), args, lbw::kSmemBytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
