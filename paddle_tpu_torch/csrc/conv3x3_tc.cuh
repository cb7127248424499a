// The tensor-core main loop of the 3x3 stride-1 pad-1 NHWC conv kernels
// on Hopper's wgmma (wgmma.cuh), fp32 and bf16.  The hooks are those of
// conv3x3_common.cuh (a LOAD hook forms the f32 operand, an EPILOGUE hook
// takes the f32 sums); every kernel of the family runs here:
//
//   kernel 18 (conv3x3_dx.cu)        kLoadBnBwd   kEpiStore
//   kernel 19 (conv3x3_fwd.cu)       kLoadAffine  kEpiStore
//   kernel 20 (conv3x3_fwd_bwd.cu)   kLoadPlain   kEpiAffineBwd
//   kernel 21 (conv3x3_chain_bwd.cu) kLoadBnBwd   kEpiAffineBwd
//
// It replaces the TPU kernels paddle_tpu/ops/pallas_conv.py::_fwd_kernel,
// _dx_kernel, _fwd_bwd_kernel and _chain_bwd_kernel: per image, the
// operand formed in f32 into a zero-padded VMEM scratch, then nine
// shifted [H*W, KC] @ [KC, NC] dot_generals of f32 operands with f32
// sums.  A backward-data conv is such a conv of its cotangent with the
// flipped, I/O-transposed weights.
//
// Numbers.  The contract multiplies the f32 operand (x = act(A*z + C), or
// dz = A*dy + B*z + C, or dy) by the weights and sums in f32.  Rounding
// it once to bf16 (2^-9) would miss the checks' 1e-5 of max|out| by two
// orders, so it is carried as hi = bf16(x) and lo = bf16(x - hi) (about
// 16 significant bits, the flash kernels' convention): each product is
// hi * w + lo * w, two bf16 tensor-core passes with f32 accumulators,
// bf16 weights being exact.  fp32 weights come split the same way, and
// the products are hi*hi + hi*lo + lo*hi.  kLoadPlain's bf16 operand (dy
// as it is) is exact in bf16: lo is 0, so it takes one pass and has no
// lo plane.  The affines round each product and sum (__fmul_rn,
// __fadd_rn), so a ReLU mask and a stored dz have the plain version's
// bits.
//
// Bound on the H100, a ResNet-50 stage at B 128 (56^2 x 64, 28^2 x 128,
// 14^2 x 256, 7^2 x 512, Cin = Cout): 2 * M * 9 * KC * NC = 29.6 GFLOP of
// the contract; its two bf16 passes at 989 TFLOP/s take 59.8 us, one
// pass 29.9 us.  Kernel 19's bytes (z, out, w once each: 102.8 MB) take
// 30.7 us, so operations bound it; kernel 18's (dy, z in, dx, dz out:
// 205.6 MB) 61.4 us, kernel 20's (dy, z in, dz, x out: 205.6 MB) 61.4 us
// and kernel 21's (dy, z2, z1 in, dz2, dz1, x1 out: 308.4 MB) 92.1 us, so
// bytes bound those three.
//
// Design.  A CTA owns 128 consecutive pixels of the flattened N*H*W range
// (starting at p0) and 64 output channels: two warpgroups of 64 pixels,
// each a 64 x 64 wgmma accumulator.  It walks the input channels in
// chunks of 64.  For each chunk it forms the operand ONCE over the tile's
// halo -- the pixels [p0 - W - 1, p0 + 128 + W + 1) that the nine taps
// reach, or, for W > 130, three bands of 130 pixels, one per tap row --
// with 16-byte loads (8 or 4 in flight a thread; see Cfg), the affine in
// f32, and the hi / lo split, or by cp.async copies of the raw rows,
// into two bf16 planes (one for kLoadPlain's bf16 dy) in shared memory
// (128-byte rows, 16-byte chunks
// XOR-swizzled by row so that ldmatrix is free of bank conflicts), plus
// one all-zero row.  The nine taps are then gathered views of the planes:
// output pixel p = (n, h, w) reads, for tap (a, b), the halo row of pixel
// p + (a - 1) W + (b - 1) when (h + a - 1, w + b - 1) lies inside image
// n, else the zero row (ops/conv.halo_gather_map is the same map in plain
// index arithmetic).  So the border is 0 in the transformed space (as the
// Pallas scratch makes it), and a tile that spans two images never reads
// the neighbour image.  ldmatrix takes one row address per lane, so the
// gather costs nothing: the A fragments go to wgmma from registers (RS).
// The weights of each (tap, chunk), [64 KC, 64 NC] bf16 planes (8 KB
// each), stream by TMA (one thread, the tensor map built on the host, an
// mbarrier a slot) into a ring kStages - 2 steps ahead, in the MN-major
// 128-byte swizzled layout that the wgmma descriptor reads.  A tap is two
// product groups (hi, lo), and each warpgroup keeps two in flight: the lo
// fragments are gathered while the hi products run, the next tap's hi
// fragments while the lo products run.  kLoadPlain's bf16 form has one
// group a tap, and the nine taps, unrolled, alternate two fragment sets:
// a tap's fragments are gathered while the previous tap's products run.
//
// kLoadBnBwd writes dz exactly once: a CTA of the first channel block
// (blockIdx.y == 0) stores the dz of the halo rows that are its own 128
// pixels (p0 <= q < p0 + 128, q < N*H*W).  Each pixel lies once in a
// contiguous halo and, in band mode, only in the middle band (W > 130),
// so the tiles, which partition the pixels, store each element once
// (ops/conv.halo_dz_stores is the same rule in plain index arithmetic).
// bf16 forms dz in place from cp.async copies of dy and z in the planes
// (no registers held for the loads in flight).  The products read the f32
// dz (hi + lo), not the stored one, as the Pallas kernel does.
//
// kLoadPlain copies bf16 dy rows into the hi plane by cp.async (rows
// outside [0, N*H*W) are stored as zeros); fp32 dy takes the register path
// and the hi / lo split without an affine.
//
// Epilogues.  kEpiStore: bf16 results leave through a free ring slot as
// 16-byte row stores; fp32 as 8-byte stores.  kEpiAffineBwd (after a CTA
// barrier, when the ring and the planes are free): u = A1*z1 + C1,
// du = act'(u)*t, dz1 = A1*du, x1 = act(u), rounded as the plain version
// does; bf16 stages z1, dz1 and x1 through three ring slots a warpgroup
// with 16-byte row accesses, fp32 reads and writes 8 bytes a lane in the
// accumulator layout (32 contiguous bytes a quad).  The channel sums
// sum z1*du and sum du are reduced in a fixed order -- over a lane's two
// rows, over the 8 lanes of a column by shuffles, over the 8 warps in
// shared memory -- into part[2, NC, gridDim.x], which reduce_parts_kernel
// sums in a fixed order: no atomics, so the sums are deterministic.
#pragma once

#include "conv3x3_common.cuh"
#include "wgmma.cuh"

namespace conv3x3_tc {

using conv3x3::Params;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;             // pixels a CTA
constexpr int kBN = 64;              // output channels a CTA
constexpr int kKC = 64;              // input channels a chunk
constexpr int kThreads = 256;        // two warpgroups
constexpr int kRow = 2 * kKC;        // bytes of a plane row (bf16)
constexpr int kPlane = kKC * kBN * 2;   // bytes of one weight slice
constexpr int kBand = kBM + 2;       // pixels of one tap row's band
constexpr int kMaxHalo = 3 * kBand;

// Per input type and load hook: weight planes a (tap, chunk) slice (bf16
// weights are exact; fp32 weights come as hi and lo bf16 planes), operand
// planes (hi and lo, or hi alone for kLoadPlain's bf16 dy: one pass), the
// ring (slices kAhead = kStages - 2 steps ahead), and the 16-byte loads in
// flight a thread of each source in the halo loop's register path
// (kLoadBnBwd's fp32 reads two sources: half as deep; the bf16 forms of
// kLoadBnBwd and kLoadPlain copy by cp.async instead).  kEpiAffineBwd's
// bf16 staging takes three slots a warpgroup: all six.
template <typename T, int kLoad>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kOnePass = !kF32 && kLoad == conv3x3::kLoadPlain;
  static constexpr int kXPlanes = kOnePass ? 1 : 2;
  static constexpr int kWPlanes = kF32 ? 2 : 1;
  static constexpr int kSlice = kWPlanes * kPlane;
  static constexpr int kStages = kF32 ? 4 : 6;
  static constexpr int kAhead = kStages - 2;
  static constexpr int kDepth =
      kF32 ? (kLoad == conv3x3::kLoadBnBwd ? 2 : 4) : 8;
  static constexpr int kMinBlocks = kF32 ? 1 : 2;
};

// Halo rows a CTA forms for W-wide images, and the rows between the
// bands of tap rows a and a + 1: one contiguous range of 2W + 130 pixels
// when it is at most three bands, else three bands of 130.
__host__ __device__ inline int halo_rows(int w) {
  return 2 * w + kBand <= kMaxHalo ? 2 * w + kBand : kMaxHalo;
}
__host__ __device__ inline int halo_step(int w) {
  return 2 * w + kBand <= kMaxHalo ? w : kBand;
}

template <typename T, int kLoad>
inline size_t smem_bytes(int w) {
  using C = Cfg<T, kLoad>;
  return 1024 + C::kStages * C::kSlice +
         C::kXPlanes * (size_t)(halo_rows(w) + 1) * kRow +
         C::kStages * sizeof(uint64_t);
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(p)));
}

// 16 bytes from global to shared memory, asynchronously (cp.async, cached
// in L2 only), and the wait for all of a thread's copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 8 channels of z (16 bytes of bf16, 32 of fp32) as raw words.
template <typename T>
struct Raw8 {
  uint4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  return r;
}

__device__ __forceinline__ float2 pair(const Raw8<bf16>& r, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(r.v);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
}
__device__ __forceinline__ float2 pair(const Raw8<float>& r, int i) {
  const float* f = reinterpret_cast<const float*>(r.v);
  return make_float2(f[2 * i], f[2 * i + 1]);
}

// The load hook kLoadAffine on 8 channels: x = act(A*z + C) in f32,
// split into hi and lo bf16 (4 b32 each).
template <typename T>
__device__ __forceinline__ void affine_split8(const Raw8<T>& z,
                                              const float* a, const float* c,
                                              int relu, uint4* hi, uint4* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 zf = pair(z, i);
    float x0 = __fadd_rn(__fmul_rn(a[2 * i], zf.x), c[2 * i]);
    float x1 = __fadd_rn(__fmul_rn(a[2 * i + 1], zf.y), c[2 * i + 1]);
    if (relu) {
      x0 = fmaxf(x0, 0.f);
      x1 = fmaxf(x1, 0.f);
    }
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(hb);
    h[i] = as_u32(hb);
    l[i] = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
  }
  *hi = make_uint4(h[0], h[1], h[2], h[3]);
  *lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The load hook kLoadPlain on 8 channels of fp32 dy: split into hi and lo
// bf16 (4 b32 each).
template <typename T>
__device__ __forceinline__ void plain_split8(const Raw8<T>& d, uint4* hi,
                                             uint4* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = pair(d, i);
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x.x, x.y);
    const float2 hf = __bfloat1622float2(hb);
    h[i] = as_u32(hb);
    l[i] = as_u32(__floats2bfloat162_rn(x.x - hf.x, x.y - hf.y));
  }
  *hi = make_uint4(h[0], h[1], h[2], h[3]);
  *lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// The load hook kLoadBnBwd on 8 channels: dz = A*dy + B*z + C in f32 (the
// products and sums rounded as the plain version's), split into hi and lo
// bf16 (4 b32 each); the f32 values stay in x for an fp32 store.
template <typename T>
__device__ __forceinline__ void bn_bwd_split8(const Raw8<T>& dy,
                                              const Raw8<T>& z,
                                              const float* a, const float* b,
                                              const float* c, float* x,
                                              uint4* hi, uint4* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 df = pair(dy, i), zf = pair(z, i);
    x[2 * i] = __fadd_rn(__fadd_rn(__fmul_rn(a[2 * i], df.x),
                                   __fmul_rn(b[2 * i], zf.x)),
                         c[2 * i]);
    x[2 * i + 1] = __fadd_rn(__fadd_rn(__fmul_rn(a[2 * i + 1], df.y),
                                       __fmul_rn(b[2 * i + 1], zf.y)),
                             c[2 * i + 1]);
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    h[i] = as_u32(hb);
    l[i] = as_u32(
        __floats2bfloat162_rn(x[2 * i] - hf.x, x[2 * i + 1] - hf.y));
  }
  *hi = make_uint4(h[0], h[1], h[2], h[3]);
  *lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// kEpiAffineBwd on one accumulator element: t the conv's sum, z the
// prologue's input; returns dz1 and x1, adds z*du and du to the sums.
__device__ __forceinline__ void affine_bwd1(float t, float z, float a,
                                            float c, int relu, float* dz,
                                            float* x, float* sz, float* sd) {
  const float u = __fadd_rn(__fmul_rn(a, z), c);
  const float du = (!relu || u > 0.f) ? t : 0.f;
  *dz = __fmul_rn(a, du);
  *x = relu ? fmaxf(u, 0.f) : u;
  *sz += z * du;
  *sd += du;
}

// kEpiAffineBwd over a warpgroup's 64 x 64 tile of sums v (rows g and
// g + 8 of warp wq, columns 8j + 2t, + 1): dz1 and x1 out, the channel
// sums of the CTA's 8 warps into red[8][2][64] (lanes g == 0).  bf16
// stages z1, dz1 and x1 through three ring slots (st[0..2]).
template <typename T>
__device__ __forceinline__ void epi_affine_bwd(const Params& p,
                                               const float (&v)[32],
                                               unsigned char* const* st,
                                               float* red, long p0, int n0,
                                               int wgi) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const long m_total = (long)p.n * p.h * p.w;
  const T* z1 = static_cast<const T*>(p.ez);
  T* dz1 = static_cast<T*>(p.edz);
  T* x1 = static_cast<T*>(p.ex);
  const long m = p0 + wgi * 64 + wq * 16 + g;
  if constexpr (!kF32) {
    // z1's rows into st[0], zeros past the last pixel
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = (tid & 127) + 128 * k, row = i >> 3, u = i & 7;
      const long mm = p0 + wgi * 64 + row;
      *reinterpret_cast<uint4*>(st[0] + wg::swz<128>(row * kRow + u * 16)) =
          mm < m_total ? __ldg(reinterpret_cast<const uint4*>(
                             z1 + mm * p.nc + n0 + u * 8))
                       : make_uint4(0, 0, 0, 0);
    }
    if (wgi == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    const float a0 = __ldg(p.ep_aff + n), a1 = __ldg(p.ep_aff + n + 1);
    const float c0 = __ldg(p.ep_aff + p.nc + n),
                c1 = __ldg(p.ep_aff + p.nc + n + 1);
    float s[4] = {0.f, 0.f, 0.f, 0.f};   // z*du, du of columns n, n + 1
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const long mm = m + 8 * h8;
      float2 zf, dz, xo;
      if constexpr (kF32) {
        zf = mm < m_total
                 ? __ldg(reinterpret_cast<const float2*>(z1 + mm * p.nc + n))
                 : make_float2(0.f, 0.f);
      } else {
        zf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            st[0] + wg::swz<128>((wq * 16 + g + 8 * h8) * kRow + j * 16 +
                                 t * 4)));
      }
      affine_bwd1(v[4 * j + 2 * h8], zf.x, a0, c0, p.relu_ep, &dz.x, &xo.x,
                  &s[0], &s[2]);
      affine_bwd1(v[4 * j + 2 * h8 + 1], zf.y, a1, c1, p.relu_ep, &dz.y,
                  &xo.y, &s[1], &s[3]);
      if constexpr (kF32) {
        if (mm < m_total) {
          *reinterpret_cast<float2*>(dz1 + mm * p.nc + n) = dz;
          *reinterpret_cast<float2*>(x1 + mm * p.nc + n) = xo;
        }
      } else {
        const uint32_t off =
            wg::swz<128>((wq * 16 + g + 8 * h8) * kRow + j * 16 + t * 4);
        *reinterpret_cast<__nv_bfloat162*>(st[1] + off) =
            __floats2bfloat162_rn(dz.x, dz.y);
        *reinterpret_cast<__nv_bfloat162*>(st[2] + off) =
            __floats2bfloat162_rn(xo.x, xo.y);
      }
    }
    // the column's 16 rows of the warp: lanes g = 0..7 in a fixed tree
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 4);
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 8);
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 16);
    }
    if (g == 0) {
      float* r = red + (wgi * 4 + wq) * 2 * kBN + 8 * j + 2 * t;
      r[0] = s[0];
      r[1] = s[1];
      r[kBN] = s[2];
      r[kBN + 1] = s[3];
    }
  }
  if constexpr (!kF32) {
    if (wgi == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else asm volatile("bar.sync 2, 128;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = (tid & 127) + 128 * k, row = i >> 3, u = i & 7;
      const long mm = p0 + wgi * 64 + row;
      const uint32_t off = wg::swz<128>(row * kRow + u * 16);
      if (mm < m_total) {
        *reinterpret_cast<uint4*>(dz1 + mm * p.nc + n0 + u * 8) =
            *reinterpret_cast<const uint4*>(st[1] + off);
        *reinterpret_cast<uint4*>(x1 + mm * p.nc + n0 + u * 8) =
            *reinterpret_cast<const uint4*>(st[2] + off);
      }
    }
  }
  // the CTA's sums: the 8 warps in order
  __syncthreads();
  if (tid < 2 * kBN) {
    const int q = tid / kBN, c = tid % kBN;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) a += red[(w * 2 + q) * kBN + c];
    p.part[((long)q * p.nc + n0 + c) * gridDim.x + blockIdx.x] = a;
  }
}

template <typename T, int kLoad, int kEpi>
__global__ void __launch_bounds__(kThreads, Cfg<T, kLoad>::kMinBlocks)
conv3x3_tc_kernel(const Params p, const __grid_constant__ CUtensorMap tmw) {
  constexpr bool kBnBwd = kLoad == conv3x3::kLoadBnBwd;
  constexpr bool kPlain = kLoad == conv3x3::kLoadPlain;
  using C = Cfg<T, kLoad>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  const int rows = halo_rows(p.w), step = halo_step(p.w);
  const int band = step == p.w ? rows : kBand;
  unsigned char* hi = ring + C::kStages * C::kSlice;
  unsigned char* lo = hi + (rows + 1) * kRow;       // absent when kOnePass
  uint64_t* full =
      reinterpret_cast<uint64_t*>(hi + C::kXPlanes * (rows + 1) * kRow);

  const T* src = static_cast<const T*>(p.src);    // z, or dy
  const T* src2 = static_cast<const T*>(p.src2);  // z of kLoadBnBwd
  T* dz_out = static_cast<T*>(p.out_src);
  // kLoadBnBwd: the first channel block stores dz of its own pixels
  const bool write_dz = kBnBwd && blockIdx.y == 0;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int hw = p.h * p.w;
  const long m_total = (long)p.n * hw;
  const long p0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int n_chunks = p.kc / kKC, steps = 9 * n_chunks;

  // the zero row of each plane
  if (tid < 8 * C::kXPlanes)
    *reinterpret_cast<uint4*>((tid < 8 ? hi : lo) + rows * kRow +
                              (tid & 7) * 16) = make_uint4(0, 0, 0, 0);

  // the pixel whose row this lane addresses in ldmatrix, and its taps
  // inside the image (bit 3a + b)
  const int r = wgi * 64 + wq * 16 + (lane & 15);
  const int khalf = lane >> 4;
  int taps = 0;
  if (p0 + r < m_total) {
    const int rem = (int)((p0 + r) % hw);
    const int ph = rem / p.w, pw = rem % p.w;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        if (ph + a - 1 >= 0 && ph + a - 1 < p.h && pw + b - 1 >= 0 &&
            pw + b - 1 < p.w)
          taps |= 1 << (3 * a + b);
  }

  // the weights of step s = (chunk, tap), rows tap * Cin + chunk * 64 ..
  // of w as [9 Cin, Cout] (fp32: its hi plane, then its lo plane 9 Cin
  // rows further), into ring slot s % kStages by TMA (thread 0)
  auto load_w = [&](int s) {
    if (s >= steps) return;
    const int chunk = s / 9, tap = s - 9 * chunk;
    uint64_t* bar = full + s % C::kStages;
    wg::mbar_expect(bar, C::kSlice);
#pragma unroll
    for (int pl = 0; pl < C::kWPlanes; ++pl)
      wg::tma_load_2d(ring + (s % C::kStages) * C::kSlice + pl * kPlane,
                      &tmw, bar, n0, (pl * 9 + tap) * p.kc + chunk * kKC);
  };
  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) wg::mbar_init(full + i, 1);
    wg::mbar_fence_init();
    for (int s = 0; s < C::kAhead; ++s) load_w(s);
  }

  // fp32, and kEpiAffineBwd (whose channel sums add up the error of every
  // pixel's t): each chunk's sums (9 x 64 x 2 or 3 products) leave the
  // tensor cores' accumulators for IEEE f32 adds into tot, which keeps the
  // error of the tensor cores' accumulation to that of one chunk
  constexpr bool kTot = C::kF32 || kEpi == conv3x3::kEpiAffineBwd;
  float acc[32], tot[kTot ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTot ? 32 : 1); ++i) tot[i] = 0.f;

  // The halo loop gives each thread the same 8 channels (hu) of every
  // row it forms; the taps keep two product groups in flight: hi (x_hi
  // times w, or for fp32 x_hi times w_hi and w_lo) and lo (x_lo times w
  // or w_hi).
  const int hu = tid & 7;
  uint32_t fa[4][4], fb[4][4];
  int s = 0;                        // step (chunk, tap)
  // The start of step s: slot s - 2 is read (kAhead = kStages - 2), so
  // slice s + kAhead may load into it; slice s has arrived.  Gives the
  // halo row this lane gathers for the tap (the zero row outside the
  // image) and the slice's descriptor (w, or w_hi and w_lo kPlane
  // further); 16 rows further (a k step) add 2048 bytes.
  auto begin_step = [&](int tap, int* hrow) -> uint64_t {
    __syncthreads();
    if (tid == 0) load_w(s + C::kAhead);
    wg::mbar_wait(full + s % C::kStages, (s / C::kStages) & 1);
    const int a = tap / 3, b = tap - 3 * a;
    *hrow = (taps >> tap) & 1 ? a * step + r + b : rows;
    return wg::desc<128>(wg::smem_u32(ring + (s % C::kStages) * C::kSlice),
                         kPlane, 8 * kRow);
  };
  constexpr uint64_t kLoPlane = kPlane >> 4, kStep = 16 * kRow >> 4;
  for (int c = 0; c < n_chunks; ++c) {
    // the load hook's rows of the chunk, 8 channels a thread: (A, C) of
    // kLoadAffine, (A, B, C) of kLoadBnBwd (none for kLoadPlain)
    float ca[8], cb[kBnBwd ? 8 : 1], cc[8];
    if constexpr (!kPlain) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float* row = p.in_aff + c * kKC + hu * 8 + e;
        ca[e] = __ldg(row);
        if constexpr (kBnBwd) cb[e] = __ldg(row + p.kc);
        cc[e] = __ldg(row + (kBnBwd ? 2 : 1) * p.kc);
      }
    }
    __syncthreads();              // the planes of chunk c - 1 are read
    // the operand over the halo, once: row j is pixel p0 - W - 1 + j (+
    // the band shift).  bf16 kLoadPlain: each thread copies its dy rows
    // into the hi plane by cp.async.  bf16 kLoadBnBwd: each thread copies
    // its raw dy and z rows into the lo and hi planes by cp.async (all in
    // flight, no registers held), then forms dz in place from its own
    // copies.  Otherwise kDepth loads of each source in flight a thread.
    if constexpr (C::kOnePass) {
      for (int i = tid; i < rows * 8; i += kThreads) {
        const int j = i >> 3;
        const long q = p0 - p.w - 1 + j + (long)(j / band) * (p.w - band);
        const uint32_t so = wg::swz<128>(j * kRow + hu * 16);
        if (q >= 0 && q < m_total)
          cp_async16(hi + so, src + q * p.kc + c * kKC + hu * 8);
        else
          *reinterpret_cast<uint4*>(hi + so) = make_uint4(0, 0, 0, 0);
      }
      cp_async_wait_all();
    } else if constexpr (kBnBwd && !C::kF32) {
      for (int i = tid; i < rows * 8; i += kThreads) {
        const int j = i >> 3;
        const long q = p0 - p.w - 1 + j + (long)(j / band) * (p.w - band);
        if (q >= 0 && q < m_total) {
          const long off = q * p.kc + c * kKC + hu * 8;
          const uint32_t so = wg::swz<128>(j * kRow + hu * 16);
          cp_async16(lo + so, src + off);
          cp_async16(hi + so, src2 + off);
        }
      }
      cp_async_wait_all();
      for (int i = tid; i < rows * 8; i += kThreads) {
        const int j = i >> 3;
        const long q = p0 - p.w - 1 + j + (long)(j / band) * (p.w - band);
        const uint32_t so = wg::swz<128>(j * kRow + hu * 16);
        uint4 h4 = make_uint4(0, 0, 0, 0), l4 = h4;
        if (q >= 0 && q < m_total) {
          Raw8<T> dv, zv;
          dv.v[0] = *reinterpret_cast<const uint4*>(lo + so);
          zv.v[0] = *reinterpret_cast<const uint4*>(hi + so);
          float x[8];
          bn_bwd_split8(dv, zv, ca, cb, cc, x, &h4, &l4);
          if (write_dz && q >= p0 && q < p0 + kBM)
            *reinterpret_cast<uint4*>(dz_out + q * p.kc + c * kKC + hu * 8) =
                h4;                                // bf16(dz) is hi
        }
        *reinterpret_cast<uint4*>(hi + so) = h4;
        *reinterpret_cast<uint4*>(lo + so) = l4;
      }
    } else {
      for (int i0 = tid; i0 < rows * 8; i0 += C::kDepth * kThreads) {
        Raw8<T> v1[C::kDepth], v2[kBnBwd ? C::kDepth : 1];
        bool in[C::kDepth];
        int own[kBnBwd ? C::kDepth : 1];   // q - p0 of a dz to store, or -1
#pragma unroll
        for (int e = 0; e < C::kDepth; ++e) {
          const int j = (i0 + e * kThreads) >> 3;
          const long q = p0 - p.w - 1 + j + (long)(j / band) * (p.w - band);
          in[e] = j < rows && q >= 0 && q < m_total;
          const long off = q * p.kc + c * kKC + hu * 8;
          v1[e] = in[e] ? load8(src + off) : Raw8<T>{};
          if constexpr (kBnBwd) {
            v2[e] = in[e] ? load8(src2 + off) : Raw8<T>{};
            own[e] = write_dz && in[e] && q >= p0 && q < p0 + kBM
                         ? (int)(q - p0) : -1;
          }
        }
#pragma unroll
        for (int e = 0; e < C::kDepth; ++e) {
          const int j = (i0 + e * kThreads) >> 3;
          if (j >= rows) break;
          uint4 h4 = make_uint4(0, 0, 0, 0), l4 = h4;
          if constexpr (kBnBwd) {         // fp32 here
            float x[8];
            if (in[e]) bn_bwd_split8(v1[e], v2[e], ca, cb, cc, x, &h4, &l4);
            if (own[e] >= 0) {
              T* d = dz_out + (p0 + own[e]) * p.kc + c * kKC + hu * 8;
              reinterpret_cast<float4*>(d)[0] =
                  make_float4(x[0], x[1], x[2], x[3]);
              reinterpret_cast<float4*>(d)[1] =
                  make_float4(x[4], x[5], x[6], x[7]);
            }
          } else if constexpr (kPlain) {  // fp32 here
            if (in[e]) plain_split8(v1[e], &h4, &l4);
          } else {
            if (in[e]) affine_split8(v1[e], ca, cc, p.relu_in, &h4, &l4);
          }
          const uint32_t off = wg::swz<128>(j * kRow + hu * 16);
          *reinterpret_cast<uint4*>(hi + off) = h4;
          *reinterpret_cast<uint4*>(lo + off) = l4;
        }
      }
    }
    __syncthreads();

    if constexpr (C::kOnePass) {
      // one group a tap, the taps unrolled so that tap t gathers into fa
      // or fb by its parity while tap t - 1's products run
      auto one_tap = [&](int tap, uint32_t(&f)[4][4]) {
        int hrow;
        const uint64_t wd = begin_step(tap, &hrow);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm4(f[kk],
                hi + wg::swz<128>(hrow * kRow + (2 * kk + khalf) * 16));
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_rs_n64<1>(acc, f[kk], wd + kk * kStep, 1);
        wg::commit();
        wg::wait<1>();            // tap t - 1's products are done
        ++s;
      };
#pragma unroll
      for (int tap = 0; tap < 9; tap += 2) {
        one_tap(tap, fa);
        if (tap + 1 < 9) one_tap(tap + 1, fb);
      }
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++s) {
        int hrow;
        const uint64_t wd = begin_step(tap, &hrow);
        uint32_t off[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          off[kk] = wg::swz<128>(hrow * kRow + (2 * kk + khalf) * 16);
          ldsm4(fa[kk], hi + off[kk]);
        }
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wg::mma_rs_n64<1>(acc, fa[kk], wd + kk * kStep, 1);
          if (C::kF32)
            wg::mma_rs_n64<1>(acc, fa[kk], wd + kLoPlane + kk * kStep,
                              1);
        }
        wg::commit();
        wg::wait<1>();  // the lo products of step s - 1 are done
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm4(fb[kk], lo + off[kk]);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg::mma_rs_n64<1>(acc, fb[kk], wd + kk * kStep, 1);
        wg::commit();
        wg::wait<1>();  // the hi products of step s are done
      }
    }
    if constexpr (kTot) {
      wg::wait<0>();
      wg::fence_acc<32>(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        tot[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
  wg::wait<0>();
  wg::fence_acc<32>(acc);

  if constexpr (kEpi == conv3x3::kEpiAffineBwd) {
    // both warpgroups' products are done: the ring and the planes are free
    __syncthreads();
    unsigned char* st[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) st[k] = ring + (3 * wgi + k) * C::kSlice;
    float* red = reinterpret_cast<float*>(hi);
    epi_affine_bwd<T>(p, tot, st, red, p0, n0, wgi);
    return;
  }

  // kEpiStore: accumulator rows g and g + 8 of the warp's 16, columns
  // 8j + 2t, + 1.  bf16 goes through a ring slot that no step uses any
  // more (the last two steps hold two of the six), then 16-byte stores
  // of whole rows; fp32 is stored 8 bytes at a time.
  const int g = lane >> 2, t = lane & 3;
  T* out = static_cast<T*>(p.out);
  if constexpr (C::kF32) {
    const long m = p0 + wgi * 64 + wq * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (m < m_total)
        *reinterpret_cast<float2*>(out + m * p.nc + n) =
            make_float2(tot[4 * j], tot[4 * j + 1]);
      if (m + 8 < m_total)
        *reinterpret_cast<float2*>(out + (m + 8) * p.nc + n) =
            make_float2(tot[4 * j + 2], tot[4 * j + 3]);
    }
  } else {
    unsigned char* stage = ring + ((s + 1 + wgi) % C::kStages) * C::kSlice;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int row = wq * 16 + g + 8 * h8;
        *reinterpret_cast<__nv_bfloat162*>(
            stage + wg::swz<128>(row * kRow + j * 16 + t * 4)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h8],
                                  acc[4 * j + 2 * h8 + 1]);
      }
    // the warpgroup's own barrier (an immediate id, so that the kernel
    // holds 3 of the SM's 16 named barriers and 2 CTAs stay resident)
    if (wgi == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else asm volatile("bar.sync 2, 128;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = (tid & 127) + 128 * k, row = i >> 3, u = i & 7;
      const long m = p0 + wgi * 64 + row;
      if (m < m_total)
        *reinterpret_cast<uint4*>(out + m * p.nc + n0 + u * 8) =
            *reinterpret_cast<const uint4*>(
                stage + wg::swz<128>(row * kRow + u * 16));
    }
  }
}

// Launch conv3x3_tc_kernel over (M / 128, NC / 64) tiles (and the
// channel-sum pass for kEpiAffineBwd, into dac); returns the cudaError of
// the launch.  p.wg: bf16 [9 KC, NC], or for fp32 inputs its hi and lo
// bf16 planes [2, 9 KC, NC].
template <typename T, int kLoad, int kEpi>
int launch(const Params& p, float* dac, cudaStream_t stream) {
  const long m_total = (long)p.n * p.h * p.w;
  if (p.kc % kKC || p.nc % kBN || m_total <= 0)
    return (int)cudaErrorInvalidValue;
  const long grid_m = (m_total + kBM - 1) / kBM;
  if (grid_m > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // the weight planes as one tensor map of [64, 64] boxes
  CUtensorMap tmw;
  const uint64_t dims[2] = {(uint64_t)p.nc,
                            9 * (uint64_t)p.kc * Cfg<T, kLoad>::kWPlanes};
  const uint64_t strides[1] = {(uint64_t)p.nc * 2};
  const uint32_t box[2] = {kBN, kKC};
  if (!wg::tma_map(&tmw, p.wg, 2, dims, strides, box, 128))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, kLoad>(p.w);
  auto kern = conv3x3_tc_kernel<T, kLoad, kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)grid_m, p.nc / kBN);
  kern<<<grid, kThreads, smem, stream>>>(p, tmw);
  if constexpr (kEpi == conv3x3::kEpiAffineBwd)
    conv3x3::reduce_parts_kernel<<<2 * p.nc, conv3x3::kReduceThreads, 0,
                                   stream>>>(p.part, (int)grid_m, dac);
  return (int)cudaGetLastError();
}

}  // namespace conv3x3_tc
