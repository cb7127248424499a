// The 3x3 stride-1 pad-1 NHWC convolution kernels' shared parts (hooks,
// Params, the channel-sum pass) and their main loop on the CUDA cores,
// which serves kernel 20 alone (conv3x3_fwd_bwd.cu).  Kernels 18, 19 and
// 21 (conv3x3_dx.cu, conv3x3_fwd.cu, conv3x3_chain_bwd.cu) run on the
// tensor-core loop of conv3x3_tc.cuh, with the same hooks and Params.
// All replace Pallas kernels of paddle_tpu/ops/pallas_conv.py.
//
// An implicit GEMM: out[p, n] = sum over tap (a, b) and source channel k
// of src'[p + (a-1, b-1), k] * wg[tap, k, n], with M = N*H*W pixels, the
// GEMM's N = NC output channels (C_out forward, C_in backward-data) and
// K = 9 * KC.  src' is the source tile as the LOAD HOOK forms it, in f32:
//
//   kLoadAffine  x = act(A*z + C)              (19, conv3x3_tc.cuh)
//   kLoadPlain   dy as it is                   (20, this loop)
//   kLoadBnBwd   dz = A*dy + B*z + C, and dz written out once
//                                              (18, 21, conv3x3_tc.cuh)
//
// A pixel outside the image reads 0 whatever the hook: the Pallas kernels
// write the transformed tile into a zero-initialised padded scratch, so
// the border is 0 in the TRANSFORMED space (not relu(C), not C).  The
// EPILOGUE HOOK takes the f32 sums:
//
//   kEpiStore      out = t in the output dtype  (18, 19, conv3x3_tc.cuh)
//   kEpiAffineBwd  u = A1*z1 + C1, du = act'(u)*t, dz1 = A1*du,
//                  x1 = act(u), and per-block partial sums of z1*du and
//                  du per channel              (20, this loop; 21,
//                                               conv3x3_tc.cuh)
//
// The affines round each product and sum as the plain versions do
// (__fmul_rn / __fadd_rn, no contraction into an FMA), so a ReLU mask
// and a stored dz have the plain version's bits.
//
// This loop: 128 pixels x 64 channels a CTA of 256 threads, 16 source
// channels of one tap a k-step, each thread 8 pixels x 4 channels of f32
// accumulators (3 float4 shared loads per 32 FMAs), the next k-step's
// operands fetched into registers while the current one is multiplied
// (two shared buffers).  The products and the affine are f32 on CUDA
// cores.  Kernel 20 multiplies its bf16 inputs as they are (dy and the
// weights): bf16 tensor-core products with f32 accumulation would compute
// the same products, so its bound is the larger of its bytes (206 MB at
// the first ResNet-50 stage at B 128, 61 us) and 29.6 GFLOP at 989
// TFLOP/s.
//
// The channel sums dA/dC of kEpiAffineBwd are deterministic on both
// loops: each CTA reduces its tile in a fixed order into
// part[2, NC, gridDim.x], and reduce_parts_kernel sums each row of part
// in a fixed order (no atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int kBM = 128;          // pixels per tile
constexpr int kBN = 64;           // GEMM output channels per tile
constexpr int kBK = 16;           // source channels per k-step
constexpr int kAS = kBM + 4;      // padded shared row of the pixel tile
constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

enum { kLoadAffine = 0, kLoadPlain = 1, kLoadBnBwd = 2 };
enum { kEpiStore = 0, kEpiAffineBwd = 1 };

struct Params {
  const void* src;       // [M, KC] operand source (z or dy), T
  const void* src2;      // [M, KC] z of kLoadBnBwd, T
  const float* in_aff;   // load hook rows over KC: (A, C) or (A, B, C)
  const void* wg;        // [9, KC, NC] GEMM weights, T
  void* out;             // [M, NC] kEpiStore output, T
  void* out_src;         // [M, KC] dz of kLoadBnBwd, T
  const void* ez;        // [M, NC] z1 of kEpiAffineBwd, T
  const float* ep_aff;   // epilogue rows over NC: (A1, C1)
  void* edz;             // [M, NC] dz1, T
  void* ex;              // [M, NC] x1, T
  float* part;           // [2, NC, gridDim.x] partial sums of z1*du, du
  int n, h, w, kc, nc;
  int relu_in, relu_ep;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// Kernel 20's loop: hooks kLoadPlain and kEpiAffineBwd.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const Params p) {
  __shared__ __align__(16) float As[2][kBK][kAS];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const T* src = static_cast<const T*>(p.src);
  const T* wg = static_cast<const T*>(p.wg);
  const int tid = threadIdx.x;
  const int hw = p.h * p.w;
  const long m_total = (long)p.n * hw;
  const long m0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kcs = p.kc / kBK;            // k-steps per tap
  const int ksteps = 9 * kcs;

  // operand loads: pixels ar and ar + 64 of the tile, channels ag..ag+3
  const int ar = tid >> 2, ag = (tid & 3) * 4;
  long pix[2];
  int ph[2], pw[2];
  bool pin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pix[i] = m0 + ar + 64 * i;
    pin[i] = pix[i] < m_total;
    const int r = pin[i] ? (int)(pix[i] % hw) : 0;
    ph[i] = r / p.w;
    pw[i] = r % p.w;
  }
  // weight loads: row bk of the k-step, channels bc..bc+3 of the tile
  const int bk = tid >> 4, bc = (tid & 15) * 4;
  // products: pixels ty*4 + {0..3} and 64 + ty*4 + {0..3}, channels tx*4..
  const int ty = tid >> 4, tx = tid & 15;

  float ra[2][4], rb[4];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto fetch = [&](int s) {
    const int tap = s / kcs;
    const int kc0 = (s - tap * kcs) * kBK;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const int k = kc0 + ag;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hh = ph[i] + dh, ww = pw[i] + dw;
      if (pin[i] && hh >= 0 && hh < p.h && ww >= 0 && ww < p.w) {
        load4(src + (pix[i] + (long)dh * p.w + dw) * p.kc + k, ra[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) ra[i][j] = 0.f;
      }
    }
    load4(wg + ((long)tap * p.kc + kc0 + bk) * p.nc + n0 + bc, rb);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) As[buf][ag + j][ar + 64 * i] = ra[i][j];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < ksteps; ++s) {
    const int buf = s & 1;
    if (s + 1 < ksteps) fetch(s + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < ksteps) stash(buf ^ 1);
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  float a1[4], c1[4], sz[4] = {0.f, 0.f, 0.f, 0.f},
                      sd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a1[j] = p.ep_aff[n + j];
    c1[j] = p.ep_aff[p.nc + n + j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= m_total) continue;
    float z[4], dz[4], x[4];
    load4(static_cast<const T*>(p.ez) + m * p.nc + n, z);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = __fadd_rn(__fmul_rn(a1[j], z[j]), c1[j]);
      const float du = (!p.relu_ep || u > 0.f) ? acc[i][j] : 0.f;
      dz[j] = __fmul_rn(a1[j], du);
      x[j] = p.relu_ep ? fmaxf(u, 0.f) : u;
      sz[j] += z[j] * du;
      sd[j] += du;
    }
    store4(static_cast<T*>(p.edz) + m * p.nc + n, dz);
    store4(static_cast<T*>(p.ex) + m * p.nc + n, x);
  }
  // the tile's channel sums, in a fixed order: rows ty, then the CTA
  float* red = &As[0][0][0];            // [2][16][kBN] after the loop
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty * kBN + tx * 4 + j] = sz[j];
    red[16 * kBN + ty * kBN + tx * 4 + j] = sd[j];
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int q = tid / kBN, c = tid % kBN;
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[q * 16 * kBN + r * kBN + c];
    p.part[((long)q * p.nc + n0 + c) * gridDim.x + blockIdx.x] = s;
  }
}

// dac[r] = sum over b of part[r, b] for the 2*NC rows of part, each by one
// CTA: strided partial sums per thread, then a fixed-shape tree.
__global__ void __launch_bounds__(kReduceThreads)
reduce_parts_kernel(const float* part, int n_parts, float* dac) {
  __shared__ float s[kReduceThreads];
  const float* row = part + (long)blockIdx.x * n_parts;
  float acc = 0.f;
  for (int b = threadIdx.x; b < n_parts; b += kReduceThreads) acc += row[b];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dac[blockIdx.x] = s[0];
}

// Launch one conv3x3_kernel over (M, NC) tiles and the channel-sum pass
// into dac; returns the cudaError of the launch.
template <typename T>
int launch(const Params& p, float* dac, cudaStream_t stream) {
  const long m_total = (long)p.n * p.h * p.w;
  if (p.kc % kBK || p.nc % kBN || m_total <= 0)
    return (int)cudaErrorInvalidValue;
  const long grid_m = (m_total + kBM - 1) / kBM;
  if (grid_m > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_m, p.nc / kBN);
  conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  reduce_parts_kernel<<<2 * p.nc, kReduceThreads, 0, stream>>>(
      p.part, (int)grid_m, dac);
  return (int)cudaGetLastError();
}

}  // namespace conv3x3
