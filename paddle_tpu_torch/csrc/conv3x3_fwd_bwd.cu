// Kernel 20: the backward of kernel 19.  The 3x3 backward-data product of
// the output cotangent dy with the flipped, I/O-transposed weights gives
// t = d/dx; the epilogue recomputes u = A*z + C from the raw residual z,
// writes dz = A*du with du = act'(u)*t, and x = act(u) (for the library
// filter-gradient conv), and sums dA = sum z*du and dC = sum du per
// channel.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_fwd_bwd_kernel (_fwd_bwd_call),
// whose dA/dC accumulate across its sequential grid; here each CTA writes
// its tile's sums and a second pass adds them in a fixed order.
// dy [N, H, W, Cout], z [N, H, W, Cin] in T; wt the flipped weights
// [3, 3, Cout, Cin] (wt[a, b] = w[2-a, 2-b]^T) as bf16, or for fp32 as hi
// and lo bf16 planes [2, 3, 3, Cout, Cin]; aff [2, Cin] f32; part
// [2, Cin, ceil(N*H*W/128)] f32 scratch; outputs dz, x [N, H, W, Cin] in
// T and dac [2, Cin] f32.
//
// It runs on the tensor cores (conv3x3_tc.cuh, hooks kLoadPlain and
// kEpiAffineBwd).  bf16 dy is the operand as it is: copied into one plane
// by cp.async and multiplied in one bf16 pass.  fp32 dy is split into hi
// + lo on load, and the products are hi*hi + hi*lo + lo*hi.  Bound on the
// H100 at each ResNet-50 stage at B 128 (bf16): its bytes, 205.6 MB in
// and out, 61.4 us (its one pass of 29.6 GFLOP takes 29.9 us).
#include "conv3x3_tc.cuh"

using namespace conv3x3;

extern "C" int conv3x3_fwd_bwd(const void* dy, const void* z,
                               const float* aff, const void* wt, void* dz,
                               void* x, float* part, float* dac, int N,
                               int H, int W, int Cin, int Cout, int relu,
                               int bf16, cudaStream_t stream) {
  Params p = {};
  p.src = dy;
  p.wg = wt;
  p.ez = z;
  p.ep_aff = aff;
  p.edz = dz;
  p.ex = x;
  p.part = part;
  p.n = N; p.h = H; p.w = W; p.kc = Cout; p.nc = Cin;
  p.relu_ep = relu;
  return bf16
             ? conv3x3_tc::launch<__nv_bfloat16, kLoadPlain, kEpiAffineBwd>(
                   p, dac, stream)
             : conv3x3_tc::launch<float, kLoadPlain, kEpiAffineBwd>(p, dac,
                                                                   stream);
}
