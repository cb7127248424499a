// The blocked tiers' dW product on Hopper's tensor cores (wgmma.cuh):
// dW[k, c] = sum over the listed valid rows j of arow(j)[k] * brow(j)[c],
// f32 in and out, one CTA of lstm::kThreads (two warpgroups) per (128 x 128
// output tile, split of the row list).  Kernels 12 (lstm_dw_blocked.cu),
// 17 (gru_dw_blocked.cu), 9 and 14 (after their time loops, lstm_wg.cuh,
// gru_wg.cuh) run on it, each with its own row accessors (arow(j), brow(j): pointers to
// listed row j's K and C values).
//
// Numbers.  The contract sums f32 products in f32.  Each f32 operand is
// carried as hi = bf16(x) and lo = bf16(x - hi), and a product as
// hi*hi + hi*lo + lo*hi -- three bf16 tensor-core passes with f32
// accumulators (the conv loop's fp32 convention, conv3x3_tc.cuh).  The
// tensor cores' accumulation error grows with the rows it runs over, so
// each chunk's sums leave the accumulators for IEEE f32 adds into
// registers (tot): the error of that accumulation stays that of one
// chunk of 64 rows.
//
// Bound on the H100 at kernel 17's main shape (B 128, T 30, H 1024, 3840
// valid rows): 2 * 3840 * H * 3H = 24.16 GFLOP of the contract, three
// bf16 passes at 989 TFLOP/s: 73.3 us; its bytes (about 91 MB) take 27
// us, so operations bound it.
//
// Design.  Warpgroup w owns output rows k0 + 64w .. + 63 and all 128
// columns: a 64 x 128 f32 accumulator (64 registers a thread) and its
// running sum tot.  The listed rows stream in chunks of 64 through a ring
// of three stages; a stage holds four bf16 planes of [64 rows, 128
// values] (A hi, A lo, B hi, B lo; 16 KB each), each two column blocks of
// [64 rows, 128 bytes] in the 128-byte swizzle.  The rows run along the
// reduction and the values along the output, so A is MN-major (wgmma's A
// transpose, SS only) as B is.  Each thread owns 8 groups of 8 values a
// chunk (4 rows of A, 4 of B): it copies a group's first 4 floats by
// cp.async into the group's 16-byte place in the hi plane and the last 4
// into its place in the lo plane, gathered through the row list, and
// after the wait it splits its own copies in place (no barrier, no
// registers held for copies in flight; fence.proxy.async hands the
// generic stores to the wgmma's reads).  One chunk's products (4 k steps
// x 3 passes of m64n128k16 a warpgroup) run while the thread splits the
// next chunk and the copies of the one after are in flight.  H % 4 != 0
// (rows not 16-byte aligned) loads the values one by one instead.  The
// same bits on every run: the order of every sum is fixed.
#pragma once

#include <cuda_bf16.h>

#include "lstm_common.cuh"
#include "wgmma.cuh"

namespace lstm {

namespace dwg {
constexpr int kRows = 64;                  // listed rows a chunk
constexpr int kTile = 128;                 // output tile: kTile x kTile
constexpr int kBlk = kRows * 128;          // bytes of a plane's column block
constexpr int kPlane = 2 * kBlk;           // bytes of a plane (128 values)
constexpr int kStage = 4 * kPlane;         // A hi, A lo, B hi, B lo
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;        // chunks whose copies are in flight
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStage;
constexpr int kMaxSplit = 4;               // splits of the row list
}  // namespace dwg

// Splits of the row list for n_tiles output tiles of `kernel` (a dW
// kernel on dw_tile_wg: kThreads threads, dwg::kSmemBytes of shared
// memory) on the current card: the fewest that minimise rounds of the
// co-resident CTAs per unit of work; 0 on a CUDA error.
template <typename K>
__host__ inline int dw_blocked_splits(K kernel, long n_tiles) {
  constexpr size_t smem = dwg::kSmemBytes;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem) !=
          cudaSuccess)
    return 0;
  const long slots = (long)per_sm * sms;
  if (slots < 1) return 1;
  int best = 1;
  for (int s = 2; s <= dwg::kMaxSplit; ++s)  // rounds / s < rounds_best / best
    if ((n_tiles * s + slots - 1) / slots * best <
        (n_tiles * best + slots - 1) / slots * s)
      best = s;
  return best;
}

// 16 bytes from global to shared memory, asynchronously, through L1 (.ca:
// the two halves of a group share 32-byte sectors, so the second copy
// finds the first one's sector there); zeros when !ok (src not read).
__device__ __forceinline__ void cp_async16_l1(void* dst, const float* src,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Byte offset of group u (values 8u .. 8u + 7) of row r inside a plane.
__device__ __forceinline__ uint32_t dw_off(int r, int u) {
  return (u >> 3) * dwg::kBlk + wg::swz<128>(r * 128 + (u & 7) * 16);
}

// 8 f32 values into hi and lo bf16 at h and l (16 bytes each).
__device__ __forceinline__ void dw_split8(const float* x, unsigned char* h,
                                          unsigned char* l) {
  uint32_t hv[4], lv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    __nv_bfloat162 lb =
        __floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
    hv[i] = *reinterpret_cast<uint32_t*>(&hb);
    lv[i] = *reinterpret_cast<uint32_t*>(&lb);
  }
  *reinterpret_cast<uint4*>(h) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
  *reinterpret_cast<uint4*>(l) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
}

// One group of 8 values of a listed row (src, valid when `in`), values
// c .. c + 7 (zeros past lim), into its places at hi and hi + kPlane.
// kVec: two cp.async halves, split later by dw_split_own; else loaded
// and split here.
template <bool kVec>
__device__ __forceinline__ void dw_group(unsigned char* hi, int r, int u,
                                         const float* src, bool in, int c,
                                         int lim, const float* any) {
  unsigned char* h = hi + dw_off(r, u);
  unsigned char* l = h + dwg::kPlane;
  if constexpr (kVec) {
    const bool ok0 = in && c < lim, ok1 = in && c + 4 < lim;
    cp_async16_l1(h, ok0 ? src + c : any, ok0);
    cp_async16_l1(l, ok1 ? src + c + 4 : any, ok1);
  } else {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = in && c + e < lim ? __ldcg(src + c + e) : 0.f;
    dw_split8(x, h, l);
  }
}

// The thread's share of the chunk of listed rows j0 .. j0 + kRows - 1
// into the stage st: rows tid / 16 + 16i, values ka + 8u .. + 7 of A and
// kb + 8u .. + 7 of B (u = tid % 16; zeros past n rows and past K or C
// values).  Every row lookup is issued before any copy needs it (one
// round trip a chunk, not one a row); a row past n looks up row n - 1
// (n >= 1 whenever a chunk exists) and is zero-filled.
template <bool kVec, class ARow, class BRow>
__device__ __forceinline__ void dw_fetch(unsigned char* st, ARow arow,
                                         BRow brow, int j0, int n, int ka,
                                         int K, int kb, int C,
                                         const float* any) {
  constexpr int kR = dwg::kRows / 16;
  const int u = threadIdx.x & 15, r0 = threadIdx.x >> 4;
  const float* a[kR];
  const float* b[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int j = min(j0 + r0 + 16 * i, n - 1);
    a[i] = arow(j);
    b[i] = brow(j);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = r0 + 16 * i;
    const bool in = j0 + r < n;
    dw_group<kVec>(st, r, u, a[i], in, ka + 8 * u, K, any);
    dw_group<kVec>(st + 2 * dwg::kPlane, r, u, b[i], in, kb + 8 * u, C,
                   any);
  }
}

// kVec: the thread's own copies of both operands of a stage, split in
// place into hi and lo.
__device__ __forceinline__ void dw_split_own(unsigned char* stage) {
  const int u = threadIdx.x & 15, r0 = threadIdx.x >> 4;
#pragma unroll
  for (int op = 0; op < 2; ++op)
#pragma unroll
    for (int i = 0; i < dwg::kRows / 16; ++i) {
      unsigned char* h =
          stage + 2 * op * dwg::kPlane + dw_off(r0 + 16 * i, u);
      unsigned char* l = h + dwg::kPlane;
      const float4 a = *reinterpret_cast<const float4*>(h);
      const float4 b = *reinterpret_cast<const float4*>(l);
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      dw_split8(x, h, l);
    }
}

// One tile over split `split` of `n_split` of the n listed rows: dW rows
// k0 .. k0 + 127 (k < K), columns col0 .. col0 + 127 (c < C), written at
// dst[k * ldw + c].  smem: dwg::kStages * dwg::kStage bytes, 1024-byte
// aligned.  kVec: every row start and K, C multiples of 4 floats (16-byte
// copies); else the values are loaded one by one.
template <bool kVec, class ARow, class BRow>
__device__ __forceinline__ void dw_tile_wg(ARow arow, BRow brow, int n,
                                           int split, int n_split, int K,
                                           int C, int k0, int col0,
                                           float* dst, long ldw,
                                           unsigned char* smem,
                                           const float* any) {
  using dwg::kAhead, dwg::kPlane, dwg::kRows, dwg::kStage, dwg::kStages;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int nch = (n + kRows - 1) / kRows;
  const int ch0 = (int)((long)nch * split / n_split);
  const int ch1 = (int)((long)nch * (split + 1) / n_split);
  auto stage = [&](int ch) {
    return smem + ((ch - ch0) % kStages) * kStage;
  };
  auto fetch = [&](int ch) {
    dw_fetch<kVec>(stage(ch), arow, brow, ch * kRows, n, k0, K, col0, C,
                   any);
  };

  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (ch0 + s < ch1) fetch(ch0 + s);
    cp_commit();
  }
  cp_wait<kAhead - 1>();
  if (kVec && ch0 < ch1) dw_split_own(stage(ch0));
  wg::fence_proxy_async();
  __syncthreads();
  constexpr uint64_t kStep = 16 * 128 >> 4;     // 16 rows: a k step
  for (int ch = ch0; ch < ch1; ++ch) {
    // the chunk's products: A of this warpgroup's 64 rows, both MN-major
    const uint32_t sb = wg::smem_u32(stage(ch));
    const uint64_t a_hi = wg::desc<128>(sb + wgi * dwg::kBlk, dwg::kBlk,
                                        1024);
    const uint64_t a_lo = a_hi + (kPlane >> 4);
    const uint64_t b_hi = wg::desc<128>(sb + 2 * kPlane, dwg::kBlk, 1024);
    const uint64_t b_lo = b_hi + (kPlane >> 4);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wg::mma_ss_n128<1, 1>(acc, a_hi + kk * kStep, b_hi + kk * kStep, 1);
      wg::mma_ss_n128<1, 1>(acc, a_hi + kk * kStep, b_lo + kk * kStep, 1);
      wg::mma_ss_n128<1, 1>(acc, a_lo + kk * kStep, b_hi + kk * kStep, 1);
    }
    wg::commit();
    // meanwhile: the copies of chunk ch + kAhead into the stage chunk
    // ch - 1 left (its products retired before the last barrier), and the
    // split of chunk ch + 1
    if (ch + kAhead < ch1) fetch(ch + kAhead);
    cp_commit();
    cp_wait<kAhead - 1>();
    if (kVec && ch + 1 < ch1) dw_split_own(stage(ch + 1));
    wg::fence_proxy_async();
    wg::wait<0>();
    wg::fence_acc<64>(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      tot[i] += acc[i];
      acc[i] = 0.f;
    }
    __syncthreads();
  }

  // accumulator rows g and g + 8 of warp wq's 16, columns 8j + 2t, + 1
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    const int k = k0 + 64 * wgi + 16 * wq + g + 8 * h8;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      if (col >= C) continue;
      float* d = dst + (long)k * ldw + col;
      const float v0 = tot[4 * j + 2 * h8], v1 = tot[4 * j + 2 * h8 + 1];
      if constexpr (kVec) {
        *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
      } else {
        d[0] = v0;
        if (col + 1 < C) d[1] = v1;
      }
    }
  }
}

}  // namespace lstm
