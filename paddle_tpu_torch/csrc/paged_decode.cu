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
// Design.  One block per (head, row), one warp per query (up to 4 warps,
// looping when Tq > 4).  Keys are walked in table order in chunks of 32
// logical positions, one key per lane; a lane maps its position to
// (page table slot, offset) and reads only pages the row uses — slots
// past the row's length, and page ids outside the pool, are never read.
// The online softmax is shared with the prefill kernel
// (attn_common.cuh).  Summation order depends only on the row's own
// length, never on the batch width, which keeps continuous batching
// token-for-token equal to sequential serving.
//
// Bound on the H100: decode reads each used K/V row once per (row, head)
// and does ~4*D flops per key, so it is bound by bytes moved (HBM at
// 3.35 TB/s); at the serving shapes (8 rows x 8 heads, <= 128 keys)
// only 64 warps run, one per SM, so each warp's chain of dependent
// loads and instructions sets the time.  Splitting a row's keys across
// warps (with a fixed-order combine) is later work.

#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace {

constexpr int kMaxWarps = 4;

template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    float* __restrict__ out, int Tq, int H, int D,
                    int n_pages, int page, int max_pages, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const int* tab = table + (size_t)b * max_pages;
  const size_t tok = (size_t)H * D;          // stride between pool tokens
  float* q_s = smem + warp * D;

  for (int r = warp; r < Tq; r += nwarps) {
    const size_t qoff = ((size_t)b * Tq + r) * tok + (size_t)h * D;
    const int n_keys = max(len - Tq + r + 1, 0);
    __syncwarp();
    for (int d = lane; d < D; d += 32) q_s[d] = q[qoff + d] * scale;
    __syncwarp();

    ptt::OnlineSoftmax<R> st;
    st.init();
    for (int c = 0; c < n_keys; c += 32) {
      const int key = c + lane;
      const int slot = key / page;
      int phys = -1;
      if (key < n_keys && slot < max_pages) phys = tab[slot];
      const bool valid = phys >= 0 && phys < n_pages;
      const size_t row =
          valid ? ((size_t)phys * page + key % page) * tok + (size_t)h * D : 0;
      float s = ptt::kNegInf;
      if (valid) s = ptt::dot_row(q_s, k_pages + row, D);
      st.update(s, valid, v_pages + row, lane, D);
    }
    st.flush(out + qoff, lane, D);
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
  const int warps = Tq < kMaxWarps ? Tq : kMaxWarps;
  const dim3 grid(H, B);
  const size_t smem = (size_t)warps * D * sizeof(float);
  return static_cast<int>(ptt::with_dims_per_lane(D, [&](auto r) {
    paged_decode_kernel<decltype(r)::value>
        <<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(q), static_cast<const float*>(k_pages),
            static_cast<const float*>(v_pages),
            static_cast<const int*>(table), static_cast<const int*>(lengths),
            static_cast<float*>(out), Tq, H, D, n_pages, page, max_pages,
            scale);
    return cudaGetLastError();
  }));
}
