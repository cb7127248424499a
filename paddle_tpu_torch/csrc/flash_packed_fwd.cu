// Packed (ragged-batch) flash attention forward, fp32, for sm_90a.
//
// Replaces the TPU kernel `_fa_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_forward_sparse` for
// `flash_attention_packed`: tokens attend only to keys of their own
// segment id (-1 = padding, which emits zeros), optionally causally
// along the packed axis.  Outputs `out [B,T,H,D]` and the per-query
// log-sum-exp `lse [B,H,T]` (kept for the backward slice).
//
// Design.  One warp per (batch row, head, query).  The warp first finds
// its segment's window [lo, hi) (first and last token with its id; the
// causal diagonal caps hi at the query), then walks the window in
// chunks of 32 keys anchored at `lo`, one key per lane, with an online
// softmax (attn_common.cuh).  Keys inside the window with another id
// are masked, so any segment layout is handled: the result is defined
// by segment equality plus the causal diagonal, and the TPU path's
// `slot` width is only a hint that this kernel does not need.
//
// Batch invariance: chunk placement is relative to the segment's first
// token and every reduction has a fixed shape, so a prompt gives the
// same bits whether it is packed with others or alone, at any padding.
//
// Bound on the H100: at the serving shapes (D = 32, prompts of 16-96
// tokens) the work is ~4*D flops per (query, key) pair in the window
// against reading q, k, v once; it is latency- and issue-bound far from
// either roofline: one warp per query spends ~400 warp-instructions per
// 32-key chunk, so the kernel is bound by instruction issue.  It reads
// K/V rows through L1/L2 (each row is read by every query of its
// segment) with loads grouped so several are in flight, and uses no
// tensor cores; a tiled wgmma/TMA version that shares K/V tiles across
// a segment's queries is later work.

#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;   // queries per block

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
flash_packed_fwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ seg,
                        float* __restrict__ out, float* __restrict__ lse,
                        int T, int H, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (qi >= T) return;                       // whole warp: qi is uniform

  const size_t tok = (size_t)H * D;          // stride between tokens
  const size_t base = (size_t)b * T * tok + (size_t)h * D;
  const int* segb = seg + (size_t)b * T;
  float* orow = out + base + (size_t)qi * tok;
  float* lse_q = lse + ((size_t)b * H + h) * T + qi;
  const int sid = segb[qi];

  ptt::OnlineSoftmax<R> st;
  st.init();
  if (sid >= 0) {
    int lo, hi;
    ptt::segment_window(segb, T, sid, lane, &lo, &hi);
    hi = causal ? min(hi, qi) + 1 : hi + 1;

    float* q_s = smem + warp * D;
    const float* qrow = q + base + (size_t)qi * tok;
    for (int d = lane; d < D; d += 32) q_s[d] = qrow[d] * scale;
    __syncwarp();

    const float* kb = k + base;
    const float* vb = v + base;
    for (int c = lo; c < hi; c += 32) {
      const int key = c + lane;
      const bool valid = key < hi && segb[key] == sid;
      float s = ptt::kNegInf;
      if (valid) s = ptt::dot_row(q_s, kb + (size_t)key * tok, D);
      st.update(s, valid, vb + (size_t)(valid ? key : lo) * tok, lane, D);
    }
  }
  const float l = st.flush(orow, lane, D);
  if (lane == 0) *lse_q = l;
}

}  // namespace

// q, k, v, out: [B, T, H, D] fp32 contiguous; seg: [B, T] int32;
// lse: [B, H, T] fp32.  Requires D % 4 == 0 and D <= 256.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int flash_packed_fwd(const void* q, const void* k, const void* v,
                                const void* seg, void* out, void* lse,
                                int B, int T, int H, int D, int causal,
                                float scale, void* stream) {
  const dim3 grid((T + kWarps - 1) / kWarps, H, B);
  const size_t smem = (size_t)kWarps * D * sizeof(float);
  return static_cast<int>(ptt::with_dims_per_lane(D, [&](auto r) {
    flash_packed_fwd_kernel<decltype(r)::value>
        <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const int*>(seg),
            static_cast<float*>(out), static_cast<float*>(lse), T, H, D,
            causal, scale);
    return cudaGetLastError();
  }));
}
