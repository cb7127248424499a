// Kernel 21: both affines of a BN -> 3x3 conv -> BN chain in one
// backward-data pass.  The operand is the second batch norm's backward,
// dz2 = A2*dy + B2*z2 + C2 (kernel 18's load hook, dz2 written out once);
// the epilogue is the backward of the forward prologue act(A1*z1 + C1):
// dz1 = A1*du, x1 = act(u) recomputed, and the channel sums
// dA1 = sum z1*du and dC1 = sum du.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_chain_bwd_kernel
// (_chain_bwd_call), whose dA1/dC1 accumulate across its sequential grid;
// here each CTA writes its tile's sums and a second pass adds them in a
// fixed order.  dy, z2 [N, H, W, Cout], z1 [N, H, W, Cin],
// wt [3, 3, Cout, Cin] in T; co [3, Cout] and ci [2, Cin] f32; part
// [2, Cin, ceil(N*H*W/128)] f32 scratch; outputs dz2 [N, H, W, Cout],
// dz1 and x1 [N, H, W, Cin] in T, dac [2, Cin] f32.
//
// It runs on the tensor cores (conv3x3_tc.cuh, hooks kLoadBnBwd and
// kEpiAffineBwd; fp32 weights as hi and lo bf16 planes, as kernel 18's).
// Bound on the H100 at each ResNet-50 stage at B 128 (bf16): its bytes,
// 308.4 MB in and out, 92.1 us (the two passes of its 29.6 GFLOP take
// 59.8 us).
#include "conv3x3_tc.cuh"

using namespace conv3x3;

extern "C" int conv3x3_chain_bwd(const void* dy, const void* z2,
                                 const float* co, const void* z1,
                                 const float* ci, const void* wt, void* dz2,
                                 void* dz1, void* x1, float* part, float* dac,
                                 int N, int H, int W, int Cin, int Cout,
                                 int relu, int bf16, cudaStream_t stream) {
  Params p = {};
  p.src = dy;
  p.src2 = z2;
  p.in_aff = co;
  p.wg = wt;
  p.out_src = dz2;
  p.ez = z1;
  p.ep_aff = ci;
  p.edz = dz1;
  p.ex = x1;
  p.part = part;
  p.n = N; p.h = H; p.w = W; p.kc = Cout; p.nc = Cin;
  p.relu_ep = relu;
  return bf16
             ? conv3x3_tc::launch<__nv_bfloat16, kLoadBnBwd, kEpiAffineBwd>(
                   p, dac, stream)
             : conv3x3_tc::launch<float, kLoadBnBwd, kEpiAffineBwd>(p, dac,
                                                                    stream);
}
