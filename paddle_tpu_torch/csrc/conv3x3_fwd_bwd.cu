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
// dy [N, H, W, Cout], z [N, H, W, Cin], wt [3, 3, Cout, Cin] (wt[a, b] =
// w[2-a, 2-b]^T) in T; aff [2, Cin] f32; part [2, Cin, ceil(N*H*W/128)]
// f32 scratch; outputs dz, x [N, H, W, Cin] in T and dac [2, Cin] f32.
// It runs on the CUDA-core loop of conv3x3_common.cuh (hooks kLoadPlain
// and kEpiAffineBwd), f32 FMAs.
#include "conv3x3_common.cuh"

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
  return bf16 ? launch<__nv_bfloat16>(p, dac, stream)
              : launch<float>(p, dac, stream);
}
