// Shared pieces of the two attention kernels: warp reductions, the
// q.k dot product and the online-softmax update over one chunk of 32
// keys (one key per lane).
//
// One warp owns one query.  Its (pre-scaled) query vector sits in
// shared memory (D floats per warp); lane `l` keeps the output
// accumulator for head dims l, l+32, ..., R of them, where R is a
// compile-time constant (D <= 32 * R; the launchers instantiate R in
// {1, 2, 4, 8}).  Keys are visited in chunks of 32 whose placement
// depends only on the query's own key window, and every reduction below
// has a fixed shape, so a query's result does not depend on the batch
// or padding around it.
//
// Loads are issued in groups before their values are used: in-order
// issue stalls at the first use of a loaded register, so a load
// followed by its use inside a loop serializes one memory round trip
// per iteration.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ptt {

constexpr float kNegInf = -1e30f;   // masked score
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;           // loads in flight per lane

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

__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_max_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// q_s (shared, D floats, already scaled) . krow (global, D floats,
// 16-byte aligned): up to kBatch float4 loads in flight, then the FMAs
// in order over d, so the summation order is fixed.
__device__ __forceinline__ float dot_row(const float* q_s,
                                         const float* __restrict__ krow,
                                         int D) {
  const float4* k4 = reinterpret_cast<const float4*>(krow);
  const int n4 = D / 4;
  float s = 0.f;
  for (int i0 = 0; i0 < n4; i0 += kBatch) {
    float4 kk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u < n4) kk[u] = __ldg(k4 + i0 + u);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u >= n4) break;
      const float* q4 = q_s + 4 * (i0 + u);
      s = fmaf(q4[0], kk[u].x, s);
      s = fmaf(q4[1], kk[u].y, s);
      s = fmaf(q4[2], kk[u].z, s);
      s = fmaf(q4[3], kk[u].w, s);
    }
  }
  return s;
}

// First and last index j < T with seg[j] == sid, over the whole warp
// (lo = T, hi = -1 when absent); kBatch loads in flight per lane.
__device__ __forceinline__ void segment_window(const int* __restrict__ seg,
                                               int T, int sid, int lane,
                                               int* lo_out, int* hi_out) {
  int lo = T, hi = -1;
  for (int j0 = lane; j0 < T; j0 += 32 * kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + 32 * u;
      v[u] = j < T ? __ldg(seg + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (v[u] == sid) {
        lo = min(lo, j0 + 32 * u);
        hi = max(hi, j0 + 32 * u);
      }
    }
  }
  *lo_out = warp_min_int(lo);
  *hi_out = warp_max_int(hi);
}

template <int R>
struct OnlineSoftmax {
  // value rows fetched per group: R * kRows floats live in registers
  static constexpr int kRows = 16 / R > 2 ? 16 / R : 2;

  float m;             // running max (kNegInf until a valid key)
  float l;             // running normaliser
  float acc[R];        // running sum of p * v for this lane's dims

  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
  }

  // Fold one chunk in.  `s` is this lane's score (kNegInf if its key is
  // masked), `valid` whether its key may be read, `vrow` the address of
  // its key's value row (unused when !valid).  The exponent base is
  // clamped at kNegInf/2 so a row with no valid key so far keeps p = 0
  // instead of exp(-inf - -inf) = 1.  Value rows are then read kRows at
  // a time (row j by all lanes, coalesced; the row's address comes from
  // lane j), and folded in key order j = 0..31.  A masked key's row is
  // read as zeros and its p is 0, so it adds nothing.
  __device__ __forceinline__ void update(float s, bool valid,
                                         const float* __restrict__ vrow,
                                         int lane, int D) {
    const float m_new = fmaxf(m, warp_max(s));
    const float m_base = fmaxf(m_new, 0.5f * kNegInf);
    const float p = valid ? expf(s - m_base) : 0.f;
    const float alpha = expf(m - m_base);
    m = m_new;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] *= alpha;

    const unsigned live = __ballot_sync(kFull, valid);
    const unsigned long long vaddr = reinterpret_cast<unsigned long long>(vrow);
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kRows) {
      if (!((live >> j0) & ((1u << kRows) - 1u))) continue;   // uniform
      float vv[kRows][R];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float* vj = reinterpret_cast<const float*>(
            __shfl_sync(kFull, vaddr, j0 + u));
        const bool lv = (live >> (j0 + u)) & 1u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int d = lane + 32 * r;
          vv[u][r] = (lv && d < D) ? __ldg(vj + d) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float pj = __shfl_sync(kFull, p, j0 + u);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(pj, vv[u][r], acc[r]);
      }
    }
  }

  // out = acc / l (exact zeros for a row with no valid key); returns lse.
  __device__ __forceinline__ float flush(float* __restrict__ orow, int lane,
                                         int D) const {
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = lane + 32 * r;
      if (d < D) orow[d] = acc[r] / l_safe;
    }
    return fmaxf(m, 0.5f * kNegInf) + logf(l_safe);
  }
};

}  // namespace ptt
