// Kernel 19: the 3x3 forward conv of act(A*z + C) -- the affine (+ReLU)
// of the upstream batch norm formed as the operand is loaded, so the
// normalised activation never exists in device memory.
//
// Replaces paddle_tpu/ops/pallas_conv.py::_fwd_kernel (_fwd_call).
// z [N, H, W, Cin] in T (fp32 or bf16), w [3, 3, Cin, Cout] (HWIO),
// aff [2, Cin] f32 (rows A, C); out [N, H, W, Cout] in T.
//
// It runs on the tensor cores (conv3x3_tc.cuh): x is formed once per CTA
// over its halo, split into hi + lo bf16, and multiplied with wgmma --
// two bf16 passes for bf16 weights (the ResNet-50 path under bench.py's
// flags; bound on the H100 59.8 us by operations at each ResNet-50 stage
// at B 128), three for fp32 weights, which the wrapper hands over as hi
// and lo bf16 planes [2, 3, 3, Cin, Cout] (hi*hi + hi*lo + lo*hi).
#include "conv3x3_tc.cuh"

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
  return bf16 ? conv3x3_tc::launch<__nv_bfloat16, kLoadAffine, kEpiStore>(
                    p, nullptr, stream)
              : conv3x3_tc::launch<float, kLoadAffine, kEpiStore>(p, nullptr,
                                                                  stream);
}
