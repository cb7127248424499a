// Kernel 18: the batch-norm backward's per-channel affine fused into the
// 3x3 backward-data conv.  Each operand tile is formed as
// dz = A*dy + B*z + C (f32) while it is loaded, dz is written out once
// (for the library filter-gradient conv), and the product with the
// flipped, I/O-transposed weights gives dx.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_dx_kernel (_dx_call).
// dy, z [N, H, W, Cout] and wt [3, 3, Cout, Cin] (wt[a, b] = w[2-a, 2-b]^T)
// in T; coeffs [3, Cout] f32 (rows A, B, C); outputs dx [N, H, W, Cin] and
// dz [N, H, W, Cout] in T.  The product reads the f32 dz, not the stored
// one, as the Pallas kernel does.
#include "conv3x3_common.cuh"

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
  return bf16 ? launch<__nv_bfloat16, kLoadBnBwd, kEpiStore>(p, nullptr,
                                                             stream)
              : launch<float, kLoadBnBwd, kEpiStore>(p, nullptr, stream);
}
