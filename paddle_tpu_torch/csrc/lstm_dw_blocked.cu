// Hidden-blocked LSTM weight gradient: dW_hh = sum over the valid (b, t)
// of h_{t-1}[b]^T dgates_t[b], an [H x BT] x [BT x 4H] product.
//
// Replaces paddle_tpu/ops/pallas_lstm.py::_dw_kernel_blocked
// (_dw_call_blocked), which keeps one [H, 4*128] dW block resident over
// a sequential T loop.  Here:
//
// - compact_rows_kernel (one CTA) lists the valid rows (mask != 0) in row
//   order.  A padded step's dgates are exact zeros (the backward's
//   masked split), so leaving those rows out changes no sum; at the
//   bench feed it drops 27 % of the rows.
// - lstm_dw_blocked_kernel: a CTA per (128 x 128 output tile, split of
//   the row list), the listed rows streamed in chunks of 32 through a
//   kStages-deep cp.async pipeline; h_{t-1} is read from the kept
//   sequence H (h0 at t = 0), dgates from the dxw that
//   lstm_bwd_blocked.cu wrote.  Each thread sums 8 x 8 outputs (4 float4
//   shared loads per 64 FMAs) over its split's rows in row order.
// - With n_split > 1 (the launcher splits the rows when 400 tiles would
//   leave the last round of co-resident CTAs mostly idle, as at H 1280),
//   each split writes its sums to scratch and reduce_splits_kernel adds
//   them in split order.
//
// No atomics: the same bits on every run.  fp32 on CUDA cores (TF32
// would change the numbers).
//
// Bound on this card: operations, 2 * (valid row-steps) * H * 4H FMAs,
// 1.84 ms at the bench feed and H = 1280.
#include "lstm_common.cuh"

using namespace lstm;

constexpr int kGR = 32;                  // rows per streamed chunk
constexpr int kGK = 128, kGC = 128;      // output tile: kGK x kGC
constexpr int kGAS = kGK + 4, kGBS = kGC + 4;      // padded chunk rows
constexpr int kGStage = kGR * (kGAS + kGBS);  // one A chunk + one B chunk
constexpr int kMaxSplit = 4;             // splits of the row list
constexpr int kCompactThreads = 1024;

// rows[0, n) = the indices r < R with mask[r] != 0, ascending; n into
// rows[R].
__global__ void __launch_bounds__(kCompactThreads)
    compact_rows_kernel(const float* __restrict__ mask, int R, int* rows) {
  __shared__ int counts[kCompactThreads];
  const int tid = threadIdx.x;
  const int per = (R + kCompactThreads - 1) / kCompactThreads;
  const int lo = min(R, tid * per), hi = min(R, lo + per);
  int c = 0;
  for (int r = lo; r < hi; ++r) c += mask[r] != 0.f;
  counts[tid] = c;
  __syncthreads();
  for (int off = 1; off < kCompactThreads; off <<= 1) {  // inclusive scan
    const int v = tid >= off ? counts[tid - off] : 0;
    __syncthreads();
    counts[tid] += v;
    __syncthreads();
  }
  int pos = counts[tid] - c;
  for (int r = lo; r < hi; ++r)
    if (mask[r] != 0.f) rows[pos++] = r;
  if (tid == kCompactThreads - 1) rows[R] = counts[tid];
}

__global__ void __launch_bounds__(kThreads)
    lstm_dw_blocked_kernel(const float* __restrict__ hseq,
                           const float* __restrict__ h0,
                           const float* __restrict__ dxw,
                           const int* __restrict__ rows, float* out, int B,
                           int T, int H, int n_split) {
  extern __shared__ float4 smem4[];
  float* gst = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const bool vec = H % 4 == 0;
  const int nkt = (H + kGK - 1) / kGK;
  const int n_tiles = nkt * ((4 * H + kGC - 1) / kGC);
  const int tile = blockIdx.x % n_tiles, split = blockIdx.x / n_tiles;
  const int k0 = (tile % nkt) * kGK, col0 = (tile / nkt) * kGC;
  const int n = rows[B * T];  // valid rows
  const int nch = (n + kGR - 1) / kGR;
  const int ch0 = (int)((long)nch * split / n_split);
  const int ch1 = (int)((long)nch * (split + 1) / n_split);
  const int kb = tid % 16, cb = tid / 16;
  auto fetch_chunk = [&](int ch) {
    float* st = gst + ((ch - ch0) % kStages) * kGStage;
    const int j0 = ch * kGR;
    auto hrow = [&](int r) -> const float* {   // h_{t-1} of listed row j
      if (j0 + r >= n) return nullptr;
      const int row = __ldg(rows + j0 + r);
      return row % T ? hseq + (long)(row - 1) * H : h0 + (long)(row / T) * H;
    };
    auto grow = [&](int r) -> const float* {   // dgates_t of listed row j
      return j0 + r < n ? dxw + (long)__ldg(rows + j0 + r) * 4 * H : nullptr;
    };
    stage(st, kGAS, hrow, kGR, kGK, k0, H, vec, h0);
    stage(st + kGR * kGAS, kGBS, grow, kGR, kGC, col0, 4 * H, vec, h0);
  };
  float acc[8][8] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ch0 + s < ch1) fetch_chunk(ch0 + s);
    cp_commit();
  }
  for (int ch = ch0; ch < ch1; ++ch) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (ch + kStages - 1 < ch1) fetch_chunk(ch + kStages - 1);
    cp_commit();
    const float* ga = gst + ((ch - ch0) % kStages) * kGStage;
    const float* gb = ga + kGR * kGAS;
#pragma unroll 2
    for (int r = 0; r < kGR; ++r) {
      const float* ar = ga + r * kGAS;
      const float* br = gb + r * kGBS;
      const float4 a0 = *reinterpret_cast<const float4*>(ar + 4 * kb);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 64 + 4 * kb);
      const float4 v0 = *reinterpret_cast<const float4*>(br + 4 * cb);
      const float4 v1 = *reinterpret_cast<const float4*>(br + 64 + 4 * cb);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] += av[i] * bv[c];
    }
  }
  float* dst = out + (long)split * H * 4 * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * kb + i : 64 + 4 * kb + i - 4);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = col0 + (c < 4 ? 4 * cb + c : 64 + 4 * cb + c - 4);
      if (k < H && col < 4 * H) dst[(long)k * 4 * H + col] = acc[i][c];
    }
  }
}

// dw[i] = part[0][i] + part[1][i] + ... (split order).
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int n_split, long n, float* dw) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < n_split; ++k) s += part[k * n + i];
    dw[i] = s;
  }
}

// Splits of the row list for (B, T, H) on the current card: the fewest
// that minimise rounds of the co-resident CTAs per unit of work; 0 on a
// CUDA error.
extern "C" int lstm_dw_blocked_splits(int B, int T, int H) {
  const size_t smem = (size_t)kStages * kGStage * sizeof(float);
  if (cudaFuncSetAttribute(lstm_dw_blocked_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lstm_dw_blocked_kernel, kThreads, smem) != cudaSuccess)
    return 0;
  const long slots = (long)per_sm * sms;
  if (slots < 1) return 1;
  const long n_tiles =
      (long)((H + kGK - 1) / kGK) * ((4 * H + kGC - 1) / kGC);
  int best = 1;
  for (int s = 2; s <= kMaxSplit; ++s)  // rounds / s < rounds_best / best
    if ((n_tiles * s + slots - 1) / slots * best <
        (n_tiles * best + slots - 1) / slots * s)
      best = s;
  return best;
}

// part: n_split x [H, 4H] scratch (unused when n_split == 1); rows: B*T + 1
// ints of scratch.
extern "C" int lstm_dw_blocked(const float* hseq, const float* h0,
                               const float* dxw, const float* mask, int* rows,
                               float* part, float* dw, int B, int T, int H,
                               int n_split, cudaStream_t stream) {
  if (n_split < 1 || n_split > kMaxSplit) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kStages * kGStage * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_dw_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  compact_rows_kernel<<<1, kCompactThreads, 0, stream>>>(mask, B * T, rows);
  const int n_tiles = ((H + kGK - 1) / kGK) * ((4 * H + kGC - 1) / kGC);
  lstm_dw_blocked_kernel<<<n_tiles * n_split, kThreads, smem, stream>>>(
      hseq, h0, dxw, rows, n_split == 1 ? dw : part, B, T, H, n_split);
  if (n_split > 1)
    reduce_splits_kernel<<<1024, 256, 0, stream>>>(part, n_split,
                                                   (long)H * 4 * H, dw);
  return (int)cudaGetLastError();
}
