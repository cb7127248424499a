// Shared pieces of the serving attention kernels (kernel 1's serving
// form, csrc/flash_packed_fwd.cu, and kernel 7, csrc/paged_decode.cu):
// the masked-score constant, the full-warp mask, the warp max and
// butterfly sum, and the dispatch on head dims a lane.
//
// Every reduction here has a fixed shape, so a query's result does not
// depend on the batch or padding around it.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ptt {

constexpr float kNegInf = -1e30f;   // masked score
constexpr unsigned kFull = 0xffffffffu;

// Call f(std::integral_constant<int, R>{}) with the smallest R in
// {1, 2, 4, 8} such that D <= 32 * R (callers check D <= 256).
template <typename F>
inline cudaError_t with_dims_per_lane(int D, F&& f) {
  if (D <= 32) return f(std::integral_constant<int, 1>{});
  if (D <= 64) return f(std::integral_constant<int, 2>{});
  if (D <= 128) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Butterfly sum: every lane ends with the same value (each step adds
// the same two operands on both partners, and + is commutative).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

}  // namespace ptt
