// Kernel 19: the 3x3 forward conv of act(A*z + C) -- the affine (+ReLU)
// of the upstream batch norm formed as each operand tile is loaded, so the
// normalised activation never exists in device memory.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_fwd_kernel (_fwd_call).
// z [N, H, W, Cin] and w [3, 3, Cin, Cout] (HWIO) in T (fp32 or bf16),
// aff [2, Cin] f32 (rows A, C); out [N, H, W, Cout] in T.  The main loop
// and its bound are in conv3x3_common.cuh.
#include "conv3x3_common.cuh"

using namespace conv3x3;

extern "C" int conv3x3_fwd(const void* z, const float* aff, const void* w,
                           void* out, int N, int H, int W, int Cin, int Cout,
                           int relu, int bf16, cudaStream_t stream) {
  Params p = {};
  p.src = z;
  p.in_aff = aff;
  p.wg = w;
  p.out = out;
  p.n = N; p.h = H; p.w = W; p.kc = Cin; p.nc = Cout;
  p.relu_in = relu;
  return bf16 ? launch<__nv_bfloat16, kLoadAffine, kEpiStore>(p, nullptr,
                                                              stream)
              : launch<float, kLoadAffine, kEpiStore>(p, nullptr, stream);
}
