// Paged-KV decode attention, fp32, for sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `paged_decode_attention`: each row's
// newest Tq query tokens attend that row's KV cache, which lives in
// fixed-size physical pages of a shared pool reached through the row's
// page table.  Query r of row b sits at position len[b] - Tq + r and
// sees keys 0..that position (the ragged causal tail); a query with no
// key (0 <= len < Tq leading rows) emits exact zeros.
//
// Design.  One block of kWarps warps per (head, row); the warps take the
// row's queries one after another, and each query's keys are split
// across them: warp w walks the fixed spans of 32 key positions w, w +
// kWarps, w + 2 kWarps, ... (one key per lane), keeping its own
// online-softmax state (running max, normaliser, output accumulator).
// A lane maps its position to (page table slot, offset) and reads only
// pages the row uses: slots past the row's length, and page ids outside
// the pool, are never read.  A span's table slot, its K row and its V
// rows are all asked for before the span's first reduction, so the loads
// of a span are one round trip.  The warps' states then meet in shared
// memory and are combined in warp order (each rescaled to the largest
// max), and the output is normalised once.  The spans, their number a
// warp and the combine's order depend only on the row's own length,
// never on the batch width or the grid, which keeps continuous batching
// token-for-token equal to sequential serving.
//
// Bound on the H100: decode reads each used K/V row once per (row, head)
// and does ~4*D flops per key, so it is bound by bytes moved (HBM at
// 3.35 TB/s); at the serving shapes (8 rows x 8 heads, <= 128 keys) a
// block's time is its chain of dependent steps: the length, the table
// slot, one round trip of K and V rows, the reductions, the combine.

#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;   // warps a block, each a share of every query
constexpr int kSpan = 32;   // key positions a span (one a lane)

// One warp's share of one query: the online softmax over its spans.
template <int R>
struct Part {
  // V rows held at once: all 32 of a span where they fit in registers
  static constexpr int kRows = R <= 2 ? 32 : 16 / R;
  // float4s of a K row held at once
  static constexpr int kK4 = R <= 2 ? 8 * R : 8;

  float m;        // running max (kNegInf until a valid key)
  float l;        // running normaliser
  float acc[R];   // running sum of p * v for this lane's dims

  __device__ __forceinline__ void init() {
    m = ptt::kNegInf;
    l = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
  }

  // V rows j0 .. j0 + kRows - 1 of the span: row j by all lanes, its
  // address from lane j; a masked key's row reads as zeros.
  __device__ __forceinline__ void load_v(float (&vv)[kRows][R], int j0,
                                         unsigned live,
                                         unsigned long long vaddr, int lane,
                                         int D) const {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float* vj = reinterpret_cast<const float*>(
          __shfl_sync(ptt::kFull, vaddr, j0 + u));
      const bool lv = (live >> (j0 + u)) & 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = lane + 32 * r;
        vv[u][r] = (lv && d < D) ? __ldg(vj + d) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void fold_v(const float (&vv)[kRows][R],
                                         int j0, float p) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float pj = __shfl_sync(ptt::kFull, p, j0 + u);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(pj, vv[u][r], acc[r]);
    }
  }

  // Fold in the span of key positions c .. c + 31 (this lane's: c +
  // lane) of a query with n_keys keys.  The scores are q_s . k in d
  // order; the V rows are folded in key order.
  __device__ __forceinline__ void span(const float* q_s,
                                       const float* __restrict__ k_pages,
                                       const float* __restrict__ v_pages,
                                       const int* __restrict__ tab, int c,
                                       int n_keys, int page, int max_pages,
                                       int n_pages, size_t tok, size_t hd,
                                       int lane, int D) {
    const int key = c + lane;
    int phys = -1;
    if (key < n_keys && key / page < max_pages) phys = __ldg(tab + key / page);
    const bool valid = phys >= 0 && phys < n_pages;
    const size_t row =
        valid ? ((size_t)phys * page + key % page) * tok + hd : 0;
    const float4* k4 = reinterpret_cast<const float4*>(k_pages + row);
    const int n4 = D / 4;
    // every load of the span before the first reduction: K's first kK4
    // float4s, V's first kRows rows
    float4 kk[kK4];
#pragma unroll
    for (int i = 0; i < kK4; ++i)
      kk[i] = valid && i < n4 ? __ldg(k4 + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned live = __ballot_sync(ptt::kFull, valid);
    const unsigned long long vaddr =
        reinterpret_cast<unsigned long long>(v_pages + row);
    float vv[kRows][R];
    load_v(vv, 0, live, vaddr, lane, D);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kK4; ++i) {
      if (i >= n4) break;
      const float* q4 = q_s + 4 * i;
      s = fmaf(q4[0], kk[i].x, s);
      s = fmaf(q4[1], kk[i].y, s);
      s = fmaf(q4[2], kk[i].z, s);
      s = fmaf(q4[3], kk[i].w, s);
    }
    for (int i0 = kK4; i0 < n4; i0 += kK4) {   // R > 2: K in batches
#pragma unroll
      for (int i = 0; i < kK4; ++i)
        kk[i] = valid && i0 + i < n4 ? __ldg(k4 + i0 + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kK4; ++i) {
        if (i0 + i >= n4) break;
        const float* q4 = q_s + 4 * (i0 + i);
        s = fmaf(q4[0], kk[i].x, s);
        s = fmaf(q4[1], kk[i].y, s);
        s = fmaf(q4[2], kk[i].z, s);
        s = fmaf(q4[3], kk[i].w, s);
      }
    }
    if (!valid) s = ptt::kNegInf;
    // the online softmax: the exponent base clamped at kNegInf / 2, so a
    // state with no valid key so far keeps p = 0
    const float m_new = fmaxf(m, ptt::warp_max(s));
    const float m_base = fmaxf(m_new, 0.5f * ptt::kNegInf);
    const float p = valid ? expf(s - m_base) : 0.f;
    const float alpha = expf(m - m_base);
    m = m_new;
    l = l * alpha + ptt::warp_sum(p);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] *= alpha;
    fold_v(vv, 0, p);
#pragma unroll
    for (int j0 = kRows; j0 < 32; j0 += kRows) {   // R > 2: V in groups
      constexpr unsigned kGroup = kRows < 32 ? (1u << kRows % 32) - 1u : ~0u;
      if (!((live >> j0) & kGroup)) continue;   // uniform
      load_v(vv, j0, live, vaddr, lane, D);
      fold_v(vv, j0, p);
    }
  }

  // The state's base (the max, clamped as the exponent base is), its
  // normaliser and this lane's dims of the accumulator into st.
  __device__ __forceinline__ void store(float* st, int lane, int D) const {
    if (lane == 0) {
      st[0] = fmaxf(m, 0.5f * ptt::kNegInf);
      st[1] = l;
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (lane + 32 * k < D) st[2 + lane + 32 * k] = acc[k];
  }
};

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    float* __restrict__ out, int Tq, int H, int D,
                    int n_pages, int page, int max_pages, float scale) {
  extern __shared__ float smem[];   // q_s [D]; per warp (m, l, acc [D])
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int* tab = table + (size_t)b * max_pages;
  const size_t tok = (size_t)H * D;          // stride between pool tokens
  float* q_s = smem;
  float* st = smem + D + warp * (D + 2);

  for (int r = 0; r < Tq; ++r) {
    const size_t qoff = ((size_t)b * Tq + r) * tok + (size_t)h * D;
    const int n_keys = max(len - Tq + r + 1, 0);
    for (int d = tid; d < D; d += kWarps * 32) q_s[d] = q[qoff + d] * scale;
    __syncthreads();
    Part<R> part;
    part.init();
    for (int c = warp * kSpan; c < n_keys; c += kWarps * kSpan)
      part.span(q_s, k_pages, v_pages, tab, c, n_keys, page, max_pages,
                n_pages, tok, (size_t)h * D, lane, D);
    part.store(st, lane, D);
    __syncthreads();
    // the warps' states in warp order, rescaled to the largest base;
    // exact zeros for a query with no valid key
    for (int d = tid; d < D; d += kWarps * 32) {
      float mb = ptt::kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, smem[D + w * (D + 2)]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* sw = smem + D + w * (D + 2);
        const float f = expf(sw[0] - mb);
        l = fmaf(sw[1], f, l);
        a = fmaf(sw[2 + d], f, a);
      }
      out[qoff + d] = a / (l == 0.f ? 1.f : l);
    }
    __syncthreads();   // q_s and the states are the next query's
  }
}

}  // namespace

// q, out: [B, Tq, H, D] fp32; k_pages, v_pages: [P, page, H, D] fp32;
// table: [B, max_pages] int32; lengths: [B] int32; all contiguous.
// Requires D % 4 == 0 and D <= 256.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int paged_decode_fwd(const void* q, const void* k_pages,
                                const void* v_pages, const void* table,
                                const void* lengths, void* out, int B,
                                int Tq, int H, int D, int n_pages, int page,
                                int max_pages, float scale, void* stream) {
  const dim3 grid(H, B);
  const size_t smem = (size_t)(D + kWarps * (D + 2)) * sizeof(float);
  return static_cast<int>(ptt::with_dims_per_lane(D, [&](auto r) {
    paged_decode_kernel<decltype(r)::value>
        <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(q), static_cast<const float*>(k_pages),
            static_cast<const float*>(v_pages),
            static_cast<const int*>(table), static_cast<const int*>(lengths),
            static_cast<float*>(out), Tq, H, D, n_pages, page, max_pages,
            scale);
    return cudaGetLastError();
  }));
}
