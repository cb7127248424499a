// Kernel 18: the batch-norm backward's per-channel affine fused into the
// 3x3 backward-data conv.  The operand is formed as dz = A*dy + B*z + C
// (f32) while it is loaded, dz is written out once (for the library
// filter-gradient conv), and the product with the flipped, I/O-transposed
// weights gives dx.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_dx_kernel (_dx_call).
// dy, z [N, H, W, Cout] and wt [3, 3, Cout, Cin] (wt[a, b] = w[2-a, 2-b]^T)
// in T; coeffs [3, Cout] f32 (rows A, B, C); outputs dx [N, H, W, Cin] and
// dz [N, H, W, Cout] in T.  The product reads the f32 dz, not the stored
// one, as the Pallas kernel does.
//
// It runs on the tensor cores (conv3x3_tc.cuh, hooks kLoadBnBwd and
// kEpiStore): dz is formed once per CTA over its halo, split into hi + lo
// bf16 and multiplied with wgmma -- two bf16 passes for bf16 weights, three
// for fp32 weights, which the wrapper hands over as hi and lo bf16 planes
// [2, 3, 3, Cout, Cin].  Bound on the H100 at each ResNet-50 stage at B 128
// (bf16): its bytes, 205.6 MB in and out, 61.4 us (the two passes of its
// 29.6 GFLOP take 59.8 us).
#include "conv3x3_tc.cuh"

using namespace conv3x3;

extern "C" int conv3x3_dx(const void* dy, const void* z, const float* coeffs,
                          const void* wt, void* dx, void* dz, int N, int H,
                          int W, int Cin, int Cout, int bf16,
                          cudaStream_t stream) {
  Params p = {};
  p.src = dy;
  p.src2 = z;
  p.in_aff = coeffs;
  p.wg = wt;
  p.out = dx;
  p.out_src = dz;
  p.n = N; p.h = H; p.w = W; p.kc = Cout; p.nc = Cin;
  return bf16 ? conv3x3_tc::launch<__nv_bfloat16, kLoadBnBwd, kEpiStore>(
                    p, nullptr, stream)
              : conv3x3_tc::launch<float, kLoadBnBwd, kEpiStore>(p, nullptr,
                                                                 stream);
}
