// The 3x3 stride-1 pad-1 NHWC convolution kernels' shared parts: the hook
// names, Params and the channel-sum pass.  All four kernels (18-21:
// conv3x3_dx.cu, conv3x3_fwd.cu, conv3x3_fwd_bwd.cu, conv3x3_chain_bwd.cu)
// run on the tensor-core main loop of conv3x3_tc.cuh.  All replace Pallas
// kernels of paddle_tpu/ops/pallas_conv.py.
//
// An implicit GEMM: out[p, n] = sum over tap (a, b) and source channel k
// of src'[p + (a-1, b-1), k] * wg[tap, k, n], with M = N*H*W pixels, the
// GEMM's N = NC output channels (C_out forward, C_in backward-data) and
// K = 9 * KC.  src' is the source tile as the LOAD HOOK forms it, in f32:
//
//   kLoadAffine  x = act(A*z + C)              (19)
//   kLoadPlain   dy as it is                   (20)
//   kLoadBnBwd   dz = A*dy + B*z + C, and dz written out once (18, 21)
//
// A pixel outside the image reads 0 whatever the hook: the Pallas kernels
// write the transformed tile into a zero-initialised padded scratch, so
// the border is 0 in the TRANSFORMED space (not relu(C), not C).  The
// EPILOGUE HOOK takes the f32 sums:
//
//   kEpiStore      out = t in the output dtype  (18, 19)
//   kEpiAffineBwd  u = A1*z1 + C1, du = act'(u)*t, dz1 = A1*du,
//                  x1 = act(u), and per-block partial sums of z1*du and
//                  du per channel              (20, 21)
//
// The affines round each product and sum as the plain versions do
// (__fmul_rn / __fadd_rn, no contraction into an FMA), so a ReLU mask
// and a stored dz have the plain version's bits.
//
// The channel sums dA/dC of kEpiAffineBwd are deterministic: each CTA
// reduces its tile in a fixed order into part[2, NC, gridDim.x], and
// reduce_parts_kernel sums each row of part in a fixed order (no
// atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int kReduceThreads = 256;

enum { kLoadAffine = 0, kLoadPlain = 1, kLoadBnBwd = 2 };
enum { kEpiStore = 0, kEpiAffineBwd = 1 };

struct Params {
  const void* src;       // [M, KC] operand source (z or dy), T
  const void* src2;      // [M, KC] z of kLoadBnBwd, T
  const float* in_aff;   // load hook rows over KC: (A, C) or (A, B, C)
  const void* wg;        // GEMM weights (see conv3x3_tc::launch)
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

}  // namespace conv3x3
