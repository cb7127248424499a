// The tensor-core main loop of the 3x3 stride-1 pad-1 NHWC conv kernels
// on Hopper's wgmma (wgmma.cuh).  Kernel 19 (conv3x3_fwd.cu, the forward
// conv of act(A*z + C)) runs on it, fp32 and bf16: the hooks are those of
// conv3x3_common.cuh (a LOAD hook forms the f32 operand, an EPILOGUE hook
// takes the f32 sums), and this loop has kLoadAffine and kEpiStore so
// far.  Kernels 18, 20 and 21 stay on the CUDA-core loop of
// conv3x3_common.cuh.
//
// It replaces the TPU kernel paddle_tpu/ops/pallas_conv.py::_fwd_kernel
// (_fwd_call): per image, x = act(A*z + C) in f32 into a zero-padded
// VMEM scratch, then nine shifted [H*W, Cin] @ [Cin, Cout] dot_generals of
// f32 operands with f32 sums.
//
// Numbers.  The contract multiplies the f32 operand x by the weights and
// sums in f32.  Rounding x once to bf16 (2^-9) would miss the checks'
// 1e-5 of max|out| by two orders, so x is carried as hi = bf16(x) and
// lo = bf16(x - hi) (about 16 significant bits, the flash kernels'
// convention): each product is hi * w + lo * w, two bf16 tensor-core
// passes with f32 accumulators, bf16 weights being exact.  fp32 weights
// come split the same way, and the products are hi*hi + hi*lo + lo*hi.
// The affine rounds each product and sum (__fmul_rn, __fadd_rn), so the
// ReLU mask has the plain version's bits.
//
// Bound on the H100, a ResNet-50 stage at B 128 (56^2 x 64, 28^2 x 128,
// 14^2 x 256, 7^2 x 512, Cin = Cout): 2 * M * 9 * Cin * Cout = 29.6
// GFLOP of the contract; its two bf16 passes at 989 TFLOP/s take 59.8 us,
// the bytes (z, out, w once each: 102.8 MB) 30.7 us, so operations bound
// it.
//
// Design.  A CTA owns 128 consecutive pixels of the flattened N*H*W range
// (starting at p0) and 64 output channels: two warpgroups of 64 pixels,
// each a 64 x 64 wgmma accumulator.  It walks the input channels in
// chunks of 64.  For each chunk it forms x ONCE over the tile's halo --
// the pixels [p0 - W - 1, p0 + 128 + W + 1) that the nine taps reach, or,
// for W > 130, three bands of 130 pixels, one per tap row -- with 16-byte
// loads of z (8 or 4 in flight a thread), the affine and ReLU in f32, and
// the hi / lo split, into two bf16 planes in shared memory (128-byte
// rows, 16-byte chunks XOR-swizzled by row so that ldmatrix is free of
// bank conflicts), plus one all-zero row.  The nine taps are then
// gathered views of the planes: output pixel p = (n, h, w) reads, for
// tap (a, b), the halo row of pixel p + (a - 1) W + (b - 1) when
// (h + a - 1, w + b - 1) lies inside image n, else the zero row
// (ops/conv.halo_gather_map is the same map in plain index arithmetic).
// So the border is 0 in the transformed space (as the Pallas scratch
// makes it), and a tile that spans two images never reads the neighbour
// image.  ldmatrix takes one row address per lane, so the gather costs
// nothing: the A fragments go to wgmma from registers (RS).  The weights
// of each (tap, chunk), [64 Cin, 64 Cout] bf16 planes (8 KB each), stream
// by TMA (one thread, the tensor map built on the host, an mbarrier a
// slot) into a ring kStages - 2 steps ahead, in the MN-major 128-byte
// swizzled layout that the wgmma descriptor reads.  A tap is two product
// groups (hi, lo), and each warpgroup keeps two in flight: the lo
// fragments are gathered while the hi products run, the next tap's hi
// fragments while the lo products run.  bf16 results leave through a free
// ring slot as 16-byte row stores.
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

// Per input type: weight planes a (tap, chunk) slice (bf16 weights are
// exact; fp32 weights come as hi and lo bf16 planes), the ring (slices
// kAhead = kStages - 2 steps ahead), and the z loads in flight a thread.
template <typename T>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWPlanes = kF32 ? 2 : 1;
  static constexpr int kSlice = kWPlanes * kPlane;
  static constexpr int kStages = kF32 ? 4 : 6;
  static constexpr int kAhead = kStages - 2;
  static constexpr int kDepth = kF32 ? 4 : 8;
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

template <typename T>
inline size_t smem_bytes(int w) {
  return 1024 + Cfg<T>::kStages * Cfg<T>::kSlice +
         2 * (size_t)(halo_rows(w) + 1) * kRow +
         Cfg<T>::kStages * sizeof(uint64_t);
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(p)));
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

template <typename T, int kLoad, int kEpi>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
conv3x3_tc_kernel(const Params p, const __grid_constant__ CUtensorMap tmw) {
  static_assert(kLoad == conv3x3::kLoadAffine && kEpi == conv3x3::kEpiStore,
                "only kernel 19's hooks run on the tensor-core loop");
  using C = Cfg<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  const int rows = halo_rows(p.w), step = halo_step(p.w);
  const int band = step == p.w ? rows : kBand;
  unsigned char* hi = ring + C::kStages * C::kSlice;
  unsigned char* lo = hi + (rows + 1) * kRow;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo + (rows + 1) * kRow);

  const T* z = static_cast<const T*>(p.src);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int hw = p.h * p.w;
  const long m_total = (long)p.n * hw;
  const long p0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int n_chunks = p.kc / kKC, steps = 9 * n_chunks;

  // the zero row of both planes
  if (tid < 16)
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

  // fp32: each chunk's sums (9 x 64 x 3 products) leave the tensor cores'
  // accumulators for IEEE f32 adds into tot, which keeps the error of the
  // tensor cores' accumulation to that of one chunk
  float acc[32], tot[C::kF32 ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::kF32 ? 32 : 1); ++i) tot[i] = 0.f;

  // The halo loop gives each thread the same 8 channels (hu) of every
  // row it forms; the taps keep two product groups in flight: hi (x_hi
  // times w, or for fp32 x_hi times w_hi and w_lo) and lo (x_lo times w
  // or w_hi).
  const int hu = tid & 7;
  uint32_t fa[4][4], fb[4][4];
  int s = 0;                        // step (chunk, tap)
  for (int c = 0; c < n_chunks; ++c) {
    float ca[8], cc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ca[e] = __ldg(p.in_aff + c * kKC + hu * 8 + e);
      cc[e] = __ldg(p.in_aff + p.kc + c * kKC + hu * 8 + e);
    }
    __syncthreads();              // the planes of chunk c - 1 are read
    // x over the halo, once: row j is pixel p0 - W - 1 + j (+ the band
    // shift); kDepth loads in flight a thread
    for (int i0 = tid; i0 < rows * 8; i0 += C::kDepth * kThreads) {
      Raw8<T> zv[C::kDepth];
      bool in[C::kDepth];
#pragma unroll
      for (int e = 0; e < C::kDepth; ++e) {
        const int j = (i0 + e * kThreads) >> 3;
        const long q = p0 - p.w - 1 + j + (long)(j / band) * (p.w - band);
        in[e] = j < rows && q >= 0 && q < m_total;
        zv[e] = in[e] ? load8(z + q * p.kc + c * kKC + hu * 8) : Raw8<T>{};
      }
#pragma unroll
      for (int e = 0; e < C::kDepth; ++e) {
        const int j = (i0 + e * kThreads) >> 3;
        if (j >= rows) break;
        uint4 h4 = make_uint4(0, 0, 0, 0), l4 = h4;
        if (in[e]) affine_split8(zv[e], ca, cc, p.relu_in, &h4, &l4);
        const uint32_t off = wg::swz<128>(j * kRow + hu * 16);
        *reinterpret_cast<uint4*>(hi + off) = h4;
        *reinterpret_cast<uint4*>(lo + off) = l4;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap, ++s) {
      __syncthreads();            // slot s - 2 is read (kAhead = kStages - 2)
      if (tid == 0) load_w(s + C::kAhead);
      wg::mbar_wait(full + s % C::kStages, (s / C::kStages) & 1);
      const int a = tap / 3, b = tap - 3 * a;
      const int hrow = (taps >> tap) & 1 ? a * step + r + b : rows;
      // the slice's descriptors (w, or w_hi and w_lo); 16 rows further
      // (a k step) add 2048 bytes
      const uint64_t wd = wg::desc<128>(
          wg::smem_u32(ring + (s % C::kStages) * C::kSlice), kPlane,
          8 * kRow);
      constexpr uint64_t kLoPlane = kPlane >> 4, kStep = 16 * kRow >> 4;
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
          wg::mma_rs_n64<1>(acc, fa[kk], wd + kLoPlane + kk * kStep, 1);
      }
      wg::commit();
      wg::wait<1>();              // the lo products of step s - 1 are done
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm4(fb[kk], lo + off[kk]);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs_n64<1>(acc, fb[kk], wd + kk * kStep, 1);
      wg::commit();
      wg::wait<1>();              // the hi products of step s are done
    }
    if constexpr (C::kF32) {
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

// Launch conv3x3_tc_kernel over (M / 128, NC / 64) tiles; returns the
// cudaError of the launch.  w: bf16 [9 Cin, Cout], or for fp32 inputs its
// hi and lo bf16 planes [2, 9 Cin, Cout].
template <typename T, int kLoad, int kEpi>
int launch(const Params& p, cudaStream_t stream) {
  const long m_total = (long)p.n * p.h * p.w;
  if (p.kc % kKC || p.nc % kBN || m_total <= 0)
    return (int)cudaErrorInvalidValue;
  const long grid_m = (m_total + kBM - 1) / kBM;
  if (grid_m > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // the weight planes as one tensor map of [64, 64] boxes
  CUtensorMap tmw;
  const uint64_t dims[2] = {(uint64_t)p.nc,
                            9 * (uint64_t)p.kc * Cfg<T>::kWPlanes};
  const uint64_t strides[1] = {(uint64_t)p.nc * 2};
  const uint32_t box[2] = {kBN, kKC};
  if (!wg::tma_map(&tmw, p.wg, 2, dims, strides, box, 128))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(p.w);
  auto kern = conv3x3_tc_kernel<T, kLoad, kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)grid_m, p.nc / kBN);
  kern<<<grid, kThreads, smem, stream>>>(p, tmw);
  return (int)cudaGetLastError();
}

}  // namespace conv3x3_tc
