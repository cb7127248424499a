// Shared pieces of the training flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tensor-core fragments
// (mma.sync m16n8k16 bf16 -> f32, ldmatrix), cp.async tile loads, the
// hi/lo bf16 split and the element masks.
//
// Tiles.  A CTA is 4 warps; its outer tile is 64 rows (16 a warp) of one
// (batch row, head), and it walks inner tiles of BN rows of the other
// sequence (BN = 64 for head dim <= 64, 32 for 128, to keep the
// accumulators in registers).  Inner windows come in units of 64 rows.
// Shared-memory planes hold bf16 rows of D values at a stride of D + 8
// (16 bytes of padding: the 8 rows an ldmatrix reads land in 8 distinct
// 16-byte bank groups).
//
// Numbers.  Inputs are bf16 or fp32.  A bf16 product of bf16 values
// accumulated in f32 is the f32 product of those values, so products of
// bf16 inputs are the contract's numbers up to summation order.  An
// fp32 operand is held as hi = bf16(x) and lo = bf16(x - hi) planes and
// a product is hi*hi + hi*lo + lo*hi (about 16 significant bits of each
// operand).  f32 intermediates fed back into a product (P, dS) are split
// the same way in registers: hi*B + lo*B.  Exponentials are 2^x by
// ex2.approx (relative error below 2^-22) of scores in log2 units.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // masked score (the reference's NEG_INF)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // outer tile rows; window unit

template <int D>
struct Tile {
  static constexpr int LDS = D + 8;               // plane row stride (bf16)
  static constexpr int BN = D <= 64 ? 64 : 32;    // inner tile rows
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// hi = bf16(x), lo = bf16(x - hi) for the pair (x0, x1), packed as an
// mma operand register each (x0 in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = as_u32(h);
  *lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 2^x (ex2.approx: relative error below 2^-22; 0 for x far below -126).
// The kernels take exp(x) as 2^(x * log2 e) with the log2 e folded into
// the score scale.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------------------- loads
// Rows [row0, row0 + R) of one (batch row, head) operand into a plane:
// src points at its row 0, rows lie tok_stride elements apart, D values
// each.  Rows at or past `limit` read as zeros.  bf16 rows go by
// cp.async (completed by cp_wait); fp32 rows are read, split and stored
// now, hi into `hi` and lo into hi + lo_off.
template <int D, int R, typename T>
__device__ __forceinline__ void load_rows(bf16* hi, int lo_off,
                                          const T* __restrict__ src,
                                          long long tok_stride, int row0,
                                          int limit) {
  constexpr int LDS = Tile<D>::LDS;
  if constexpr (sizeof(T) == 2) {
    constexpr int CH = D / 8;                     // 16-byte chunks a row
    for (int i = threadIdx.x; i < R * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = row0 + r < limit;
      const T* g =
          src + (ok ? (long long)(row0 + r) * tok_stride : 0) + c * 8;
      cp_async16(hi + r * LDS + c * 8, g, ok);
    }
  } else {
    constexpr int CH = D / 4;                     // float4 a chunk
    for (int i = threadIdx.x; i < R * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < limit)
        x = __ldg(reinterpret_cast<const float4*>(
            src + (long long)(row0 + r) * tok_stride + c * 4));
      uint32_t h[2], l[2];
      split2(x.x, x.y, &h[0], &l[0]);
      split2(x.z, x.w, &h[1], &l[1]);
      *reinterpret_cast<uint2*>(hi + r * LDS + c * 4) =
          make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(hi + lo_off + r * LDS + c * 4) =
          make_uint2(l[0], l[1]);
    }
  }
}

// n int32 / f32 values src[i0 + i], i < n, into smem by cp.async (zeros
// past `limit`).
template <typename T>
__device__ __forceinline__ void load_vec(T* dst, const T* __restrict__ src,
                                         int i0, int n, int limit) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = i0 + i < limit;
    cp_async4(dst + i, src + (ok ? i0 + i : 0), ok);
  }
}

// ------------------------------------------------------------ products
// acc[16 x N] += A[16 x D] * B^T for the warp's 16 rows `a` of a plane
// and N rows `b` of another (both D wide): S = Q K^T, dP = dO V^T and
// their transposes.  SPLIT adds hi*lo + lo*hi (the lo planes at a + a_lo
// and b + b_lo).
template <int D, int N, bool SPLIT>
__device__ __forceinline__ void gemm_nt(float (*acc)[4], const bf16* a,
                                        int a_lo, const bf16* b, int b_lo) {
  constexpr int LDS = Tile<D>::LDS;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t ah[4], al[4];
    const bf16* pa = a + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8;
    ldsm4(ah, pa);
    if constexpr (SPLIT) ldsm4(al, pa + a_lo);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bh[4], bl[4];
      const bf16* pb = b + (np * 16 + (mi >> 1) * 8 + ri) * LDS + kk * 16 +
                       (mi & 1) * 8;
      ldsm4(bh, pb);
      mma(acc[2 * np], ah, bh[0], bh[1]);
      mma(acc[2 * np + 1], ah, bh[2], bh[3]);
      if constexpr (SPLIT) {
        ldsm4(bl, pb + b_lo);
        mma(acc[2 * np], ah, bl[0], bl[1]);
        mma(acc[2 * np + 1], ah, bl[2], bl[3]);
        mma(acc[2 * np], al, bh[0], bh[1]);
        mma(acc[2 * np + 1], al, bh[2], bh[3]);
      }
    }
  }
}

// acc[16 x D] += P[16 x K] * B for P held in accumulator layout
// (p[K/8][4], f32, split hi/lo here) and K rows `b` of a plane (D wide):
// O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q.  SPLIT (fp32 B)
// adds hi(P) * lo(B).
template <int D, int K, bool SPLIT>
__device__ __forceinline__ void gemm_pn(float (*acc)[4], const float (*p)[4],
                                        const bf16* b, int lo_off) {
  constexpr int LDS = Tile<D>::LDS;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t ah[4], al[4];
    split2(p[2 * kk][0], p[2 * kk][1], &ah[0], &al[0]);
    split2(p[2 * kk][2], p[2 * kk][3], &ah[1], &al[1]);
    split2(p[2 * kk + 1][0], p[2 * kk + 1][1], &ah[2], &al[2]);
    split2(p[2 * kk + 1][2], p[2 * kk + 1][3], &ah[3], &al[3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bh[4], bl[4];
      const bf16* pb = b + (kk * 16 + (mi & 1) * 8 + ri) * LDS + np * 16 +
                       (mi >> 1) * 8;
      ldsm4t(bh, pb);
      mma(acc[2 * np], ah, bh[0], bh[1]);
      mma(acc[2 * np + 1], ah, bh[2], bh[3]);
      mma(acc[2 * np], al, bh[0], bh[1]);
      mma(acc[2 * np + 1], al, bh[2], bh[3]);
      if constexpr (SPLIT) {
        ldsm4t(bl, pb + lo_off);
        mma(acc[2 * np], ah, bl[0], bl[1]);
        mma(acc[2 * np + 1], ah, bl[2], bl[3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// ---------------------------------------------------------------- masks
// Element validity of (query qi, key kj), the reference's _tile_mask:
// key inside the valid length, on or below the diagonal when causal,
// and (packed) the same segment id, -1 = padding seeing nothing.
__device__ __forceinline__ bool valid(int qi, int kj, int kv_len, bool causal,
                                      bool packed, int seg_q, int seg_k) {
  bool ok = kj < kv_len;
  if (causal) ok = ok && qi >= kj;
  if (packed) ok = ok && seg_q == seg_k && seg_q >= 0;
  return ok;
}

// Row-wise reductions over the 4 lanes of a quad (the lanes holding one
// accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Output pair (x0, x1) at p (2 consecutive elements).
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// Shared memory a kernel needs beyond 48 KB is granted once per
// instantiation; returns the launch error.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// f(std::integral_constant<int, D>{}, T{}) for D in {32, 64, 128} and
// T = bf16 (dtype 0) or float (dtype 1); anything else is an
// invalid-value error (the wrapper checks first).
template <typename F>
inline cudaError_t dispatch(int D, int dtype, F&& f) {
  if (dtype == 0) {
    if (D == 32) return f(std::integral_constant<int, 32>{}, bf16{});
    if (D == 64) return f(std::integral_constant<int, 64>{}, bf16{});
    if (D == 128) return f(std::integral_constant<int, 128>{}, bf16{});
  } else if (dtype == 1) {
    if (D == 32) return f(std::integral_constant<int, 32>{}, 0.f);
    if (D == 64) return f(std::integral_constant<int, 64>{}, 0.f);
    if (D == 128) return f(std::integral_constant<int, 128>{}, 0.f);
  }
  return cudaErrorInvalidValue;
}

// Shared-memory bytes of a plane of R rows (hi and, for fp32, lo).
template <int D, typename T>
constexpr int plane_bytes(int R) {
  return R * Tile<D>::LDS * 2 * (sizeof(T) == 4 ? 2 : 1);
}

}  // namespace fa
