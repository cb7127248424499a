// Packed (ragged-batch) flash attention forward, fp32, for sm_90a.
//
// Replaces the TPU kernel `_fa_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_forward_sparse` for
// `flash_attention_packed`: tokens attend only to keys of their own
// segment id (-1 = padding, which emits zeros), optionally causally
// along the packed axis.  Outputs `out [B,T,H,D]` and the per-query
// log-sum-exp `lse [B,H,T]` (kept for the backward slice).
//
// Design.  One CTA of kW = 8 warps per (tile of kQT queries, head,
// batch row).  Every warp holds all the tile's queries; warp w takes the
// keys lo + w, lo + w + kW, ... of each query's window (lo its first
// key).
//  1. One round trip: the tile's q rows (cp.async into shared memory),
//     its ids, and the row's ids (causal: up to the tile's end, since a
//     run's first key is at or before its first query), coalesced.  Each
//     warp finds the tile's runs of equal ids from one ballot; a run's
//     window (its id's first token in the row, and unless causal its
//     last) comes from warp min/max reductions and one shared atomic a
//     warp.  A query's keys are its window, capped at the query when
//     causal; keys in it with another id are masked, so any segment
//     layout is handled.
//  2. The union of the windows' K and V rows of the head (and their
//     ids) is staged in shared memory by cp.async, in chunks of `cap`
//     rows where it does not fit, so a row leaves L2 once a CTA, not
//     once a query.  Rows are padded to D + 4 floats.
//  3. A group of L lanes holds kR = 2 queries, kDpl = 8 dims a lane (D
//     <= 32: 4 lanes x 8 dims x 2 queries): their q, in log2 units, and
//     their accumulators in registers, so a staged value read from
//     shared memory serves both queries.  A score is each lane's kDpl
//     products in order, then a butterfly over the L lanes (both sides
//     of a step add the same two values); kU keys an iteration.  fp32
//     FMAs on the CUDA cores: ~4*D flops a visible (query, key) pair.
//  4. A query's kW warp states meet in warp order through shared
//     memory: each weighted by 2^(m_w - max m), summed from warp 0 on,
//     times one reciprocal of the normaliser.
//
// The softmax is online a key at a time: a key's p = 2^(s - m) with m a
// running reference that moves only when a score passes it by more than
// kSlack (then l and the accumulator are rescaled), so p <= 2^kSlack and
// rescales are rare.
//
// Batch invariance: a query's arithmetic is a fixed sequence over its
// visible keys in order (its kW parts anchored at its own first key,
// combined in a fixed order), the same for every place in the CTA,
// tile, chunk or pack, so a prompt gives the same bits (out and lse)
// alone at its own bucket as packed with others at any slot or padding.
//
// Bound on the H100: at the serving shapes (D = 32, prompts of 16-96
// tokens) the bytes that must move (q, k, v, ids read once; out, lse
// written once) take ~1 us and the arithmetic less.  The time is the
// launch, a chain of dependent setup steps a CTA (the ids' round trip,
// the scan, the staged rows, the combine), and the key loops of the
// busiest SMs: a tile late in a long prompt holds many times the pairs
// of an early one, and its warps' chains of shuffles and exponentials
// run far below the issue rate.  The CTA-wide scan, the shared rows and
// the register reuse replace a scan of the row a warp and a fetch of
// every key row by every query of its segment.

#include <cuda_runtime.h>

#include <climits>

#include "attn_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSlack = 8.f;             // log2 units the reference may lag
constexpr int kIds = 4;                   // row ids a thread reads a pass
constexpr int kStageBytes = 72 * 1024;    // K, V and id rows of one chunk
constexpr int kDpl = 8;                   // dims a lane holds
constexpr int kR = 2;                     // queries a lane group holds
constexpr int kW = 8;                     // warps: kW parts of the keys
constexpr int kThreads = 32 * kW;
constexpr int kU = 2;                     // a group's keys in flight

// queries of a CTA (one warp's) at L lanes a query
template <int L>
constexpr int kTileQueries = 32 / L * kR;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows c0 .. c0 + n - 1 of K and V (one head; token stride `tok`) into
// k_s / v_s at row stride sk floats, 16 bytes a copy; thread `tid`
// takes pieces tid, tid + kThreads, ... (row and column kept by
// additions, not a division a piece).
__device__ __forceinline__ void stage_kv(const float* kg, const float* vg,
                                         float* k_s, float* v_s, int c0,
                                         int n, int D, int sk, size_t tok,
                                         int tid) {
  const int per_row = D / 4;
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = tid / per_row, c = tid - r * per_row;
  for (; r < n; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      ++r;
      if (r >= n) break;
    }
    const size_t g = (size_t)(c0 + r) * tok + 4 * c;
    cp_async16(k_s + r * sk + 4 * c, kg + g);
    cp_async16(v_s + r * sk + 4 * c, vg + g);
  }
}

__device__ __forceinline__ void stage_ids(const int* segb, int* ids_s, int c0,
                                          int n, int tid) {
  for (int i = tid; i < n; i += kThreads) cp_async4(ids_s + i, segb + c0 + i);
}

// Lower each run's first and (unless causal) raise its last occurrence
// over the row's ids (`idv` holds this thread's first kIds of them).
// The tile's runs of equal ids start at the set bits of `heads` (lane i
// of a warp holds the tile's query i and its id `sid`); a run's window
// is kept at its head query's place: warp min/max, then one shared
// atomic a warp and run.
__device__ __forceinline__ void scan_row(const int* __restrict__ segb, int T,
                                         int (&idv)[kIds], unsigned heads,
                                         int sid, int* run_lo, int* run_hi,
                                         bool causal, int tid, int lane) {
  for (int j0 = 0; j0 < T; j0 += kIds * kThreads) {
    if (j0 > 0) {
#pragma unroll
      for (int u = 0; u < kIds; ++u) {
        const int j = j0 + tid + u * kThreads;
        idv[u] = j < T ? segb[j] : -1;
      }
    }
    for (unsigned rest = heads; rest; rest &= rest - 1) {
      const int head = __ffs(rest) - 1;
      const int x = __shfl_sync(ptt::kFull, sid, head);
      if (x < 0) continue;                       // uniform: padding run
      int lo = INT_MAX, hi = -1;
#pragma unroll
      for (int u = 0; u < kIds; ++u) {
        if (idv[u] == x) {
          const int j = j0 + tid + u * kThreads;
          lo = min(lo, j);
          hi = max(hi, j);
        }
      }
      lo = __reduce_min_sync(ptt::kFull, lo);
      if (!causal) hi = __reduce_max_sync(ptt::kFull, hi);
      if (lane == 0 && lo != INT_MAX) {
        atomicMin(run_lo + head, lo);
        if (!causal) atomicMax(run_hi + head, hi);
      }
    }
  }
}

// This lane's kDpl dims of a staged row (zeros past D).
__device__ __forceinline__ void load_row(const float* row, int d0, int D,
                                         float (&x)[kDpl]) {
  const float4* r4 = reinterpret_cast<const float4*>(row + d0);
#pragma unroll
  for (int f = 0; f < kDpl / 4; ++f) {
    const float4 a = d0 + 4 * f < D ? r4[f] : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * f] = a.x;
    x[4 * f + 1] = a.y;
    x[4 * f + 2] = a.z;
    x[4 * f + 3] = a.w;
  }
}

// q . k: this lane's kDpl products in order, then a butterfly over the
// L lanes of the query (both sides of each step add the same two values).
template <int L>
__device__ __forceinline__ float score(const float (&q)[kDpl],
                                       const float (&k)[kDpl]) {
  float x = q[0] * k[0];
#pragma unroll
  for (int d = 1; d < kDpl; ++d) x = fmaf(q[d], k[d], x);
#pragma unroll
  for (int o = 1; o < L; o <<= 1) x += __shfl_xor_sync(ptt::kFull, x, o);
  return x;
}

// One visible key into a query's state: the reference max moves (and l
// and acc are rescaled) only when s passes it by more than kSlack.
__device__ __forceinline__ void fold(float s, const float (&v)[kDpl],
                                     float& m, float& l,
                                     float (&acc)[kDpl]) {
  if (s > m + kSlack) {
    const float alpha = ex2(m - s);
    l = __fmul_rn(l, alpha);
#pragma unroll
    for (int d = 0; d < kDpl; ++d) acc[d] = __fmul_rn(acc[d], alpha);
    m = s;
  }
  const float p = ex2(s - m);
  l = __fadd_rn(l, p);
#pragma unroll
  for (int d = 0; d < kDpl; ++d) acc[d] = fmaf(p, v[d], acc[d]);
}

// First key of part w (keys lo + w + kW i) at or after `from`.
__device__ __forceinline__ int part_start(int lo, int w, int from) {
  return from + ((lo + w - from) & (kW - 1));
}

// L lanes a query; kExact: D == L * kDpl.  Three CTAs an SM (768
// threads: <= 85 registers a thread), so the serving tiles run in one
// wave.
template <int L, bool kExact>
__global__ void __launch_bounds__(kThreads, 3)
flash_packed_fwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ seg,
                        float* __restrict__ out, float* __restrict__ lse,
                        int T, int H, int D, int causal, float scale,
                        int cap) {
  constexpr int kQT = kTileQueries<L>;
  constexpr int kDp = L * kDpl;                // dims a query's lanes hold
  constexpr int kSt = kDp + 4;                 // a part's state in smem
  // kExact: D fills the query's lanes, so no dim of a row needs a test
  const int Dl = kExact ? kDp : D;
  static_assert(kQT <= 32, "a warp's lanes hold the tile's ids");
  extern __shared__ __align__(16) unsigned char smem[];
  int* sid_s = reinterpret_cast<int*>(smem);   // the tile's ids
  int* run_lo = sid_s + kQT;                   // each run's window, at its
  int* run_hi = run_lo + kQT;                  // head query's place
  int* ids_s = run_hi + kQT;                   // a chunk's ids
  const int sk = D + 4;
  float* k_s = reinterpret_cast<float*>(
      smem + ((3 * kQT + cap) * 4 + 15) / 16 * 16);
  float* v_s = k_s + (size_t)cap * sk;
  float* q_s = v_s + (size_t)cap * sk;         // the tile's q

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int l = lane % L;                      // lane in the query's group
  const int g = lane / L;                      // the group: queries g kR + r
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t tok = (size_t)H * D;
  const size_t base = (size_t)b * T * tok + (size_t)h * D;
  const int* segb = seg + (size_t)b * T;
  const float* kg = k + base;
  const float* vg = v + base;
  const int d0 = l * kDpl;

  // one round trip: the tile's q rows (into shared memory), its ids and
  // the first kIds of the row's ids a thread
  const int nq = min(kQT, T - q0);
  for (int i = tid; i < nq * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    cp_async16(q_s + r * sk + c, q + base + (size_t)(q0 + r) * tok + c);
  }
  if (tid < kQT) {
    sid_s[tid] = tid < nq ? segb[q0 + tid] : -1;
    run_lo[tid] = INT_MAX;
    run_hi[tid] = -1;
  }
  // a run's first key is at or before its first query, so causal needs
  // the ids up to the tile's end only
  const int scan_end = causal ? q0 + nq : T;
  int idv[kIds];
#pragma unroll
  for (int u = 0; u < kIds; ++u) {
    const int j = tid + u * kThreads;
    idv[u] = j < scan_end ? segb[j] : -1;
  }
  cp_async_wait_all();
  __syncthreads();

  // this lane's dims of its kR queries' q, in log2 units
  float qr[kR][kDpl];
  {
    const float qs = scale * kLog2e;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int iq = g * kR + r;
      float x[kDpl];
      load_row(q_s + iq * sk, d0, iq < nq ? Dl : 0, x);
#pragma unroll
      for (int d = 0; d < kDpl; ++d) qr[r][d] = x[d] * qs;
    }
  }
  // the tile's runs of equal ids (every warp the same ballot), each
  // query's run head and the row's windows of the runs
  const int my_sid = lane < kQT ? sid_s[lane] : -1;
  const bool head =
      lane < kQT && (lane == 0 || my_sid != sid_s[lane - 1]);
  const unsigned heads = __ballot_sync(ptt::kFull, head);
  scan_row(segb, scan_end, idv, heads, my_sid, run_lo, run_hi, causal, tid,
           lane);
  __syncthreads();

  // this lane's queries' windows (padding: lo 0, hi -1) and the CTA's
  // key range (every warp holds every query); a group whose valid
  // queries share lo reads each key once
  int sid[kR], lo[kR], hi[kR];
  int glo = INT_MAX, ghi = -1;
  bool same = true;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int iq = g * kR + r;
    sid[r] = sid_s[iq];
    lo[r] = 0;
    hi[r] = -1;
    if (sid[r] >= 0) {
      const int run = 31 - __clz(heads & (ptt::kFull >> (31 - iq)));
      lo[r] = run_lo[run];
      hi[r] = causal ? q0 + iq : run_hi[run];
      same &= glo == INT_MAX || glo == lo[r];
      glo = min(glo, lo[r]);
      ghi = max(ghi, hi[r]);
    }
  }
  const int klo = __reduce_min_sync(ptt::kFull, glo);
  const int khi = __reduce_max_sync(ptt::kFull, ghi);
  const bool shared_rows = __all_sync(ptt::kFull, same);

  float m[kR], ls[kR], acc[kR][kDpl];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = ptt::kNegInf;
    ls[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kDpl; ++d) acc[r][d] = 0.f;
  }
  for (int c0 = klo; c0 <= khi; c0 += cap) {
    const int n = min(cap, khi - c0 + 1);
    if (c0 != klo) __syncthreads();            // the last chunk is read
    stage_kv(kg, vg, k_s, v_s, c0, n, D, sk, tok, tid);
    stage_ids(segb, ids_s, c0, n, tid);
    cp_async_wait_all();
    __syncthreads();
    const int last = c0 + n - 1;
    if (shared_rows) {
      // the group's keys glo + w + kW i in the chunk, kU at a time (a
      // group without a valid query has ghi -1: no key)
      const int a = ghi >= 0 ? glo : 0;
      const int jb = part_start(a, w, max(a, c0));
      const int je = min(ghi, last);
      const int cnt = jb <= je ? (je - jb) / kW + 1 : 0;
      const int wcnt = __reduce_max_sync(ptt::kFull, cnt);
      for (int i = 0; i < wcnt; i += kU) {
        float kk[kU][kDpl], vv[kU][kDpl];
        int j[kU], id[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bool in = i + u < cnt;
          j[u] = jb + (i + u) * kW;
          const int rr = in ? j[u] - c0 : 0;
          load_row(k_s + rr * sk, d0, Dl, kk[u]);
          load_row(v_s + rr * sk, d0, Dl, vv[u]);
          id[u] = in ? ids_s[rr] : -2;
        }
        // every score of the iteration first, so their butterflies
        // overlap (interleaved with the folds, the loop spilled and ran
        // 1.5 us slower at the serving pack's shape on an H100), then a
        // fold for each visible (key, query) in order
        float s[kU][kR];
        bool ok[kU][kR];
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            s[u][r] = score<L>(qr[r], kk[u]);
            ok[u][r] = j[u] <= hi[r] && id[u] == sid[r];
          }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int r = 0; r < kR; ++r)
            if (ok[u][r]) fold(s[u][r], vv[u], m[r], ls[r], acc[r]);
      }
    } else {
      // a group whose queries start at different keys: each its own rows
      int jb[kR], cnt[kR], most = 0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        jb[r] = part_start(lo[r], w, max(lo[r], c0));
        const int je = min(hi[r], last);
        cnt[r] = jb[r] <= je ? (je - jb[r]) / kW + 1 : 0;
        most = max(most, cnt[r]);
      }
      const int wcnt = __reduce_max_sync(ptt::kFull, most);
      for (int i = 0; i < wcnt; ++i) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const bool in = i < cnt[r];
          const int rr = in ? jb[r] + i * kW - c0 : 0;
          float kk[kDpl], vv[kDpl];
          load_row(k_s + rr * sk, d0, Dl, kk);
          load_row(v_s + rr * sk, d0, Dl, vv);
          const float s = score<L>(qr[r], kk);
          if (in && ids_s[rr] == sid[r]) fold(s, vv, m[r], ls[r], acc[r]);
        }
      }
    }
  }

  // the kW parts of each query meet in warp order, through shared memory
  __syncthreads();                             // the staged rows are read
  float* part = k_s;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float* row = part + ((size_t)w * kQT + g * kR + r) * kSt;
#pragma unroll
    for (int f = 0; f < kDpl / 4; ++f)
      *reinterpret_cast<float4*>(row + d0 + 4 * f) =
          make_float4(acc[r][4 * f], acc[r][4 * f + 1], acc[r][4 * f + 2],
                      acc[r][4 * f + 3]);
    if (l == 0) {
      row[kDp] = m[r];
      row[kDp + 1] = ls[r];
    }
  }
  __syncthreads();
  const int nf = D / 4;
  for (int it = tid; it < kQT * nf; it += kThreads) {
    const int iq = it / nf, f = it - iq * nf, qi = q0 + iq;
    if (qi >= T) continue;
    float mx = ptt::kNegInf;
#pragma unroll
    for (int p = 0; p < kW; ++p)
      mx = fmaxf(mx, part[(p * kQT + iq) * kSt + kDp]);
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < kW; ++p) {
      const float* row = part + (p * kQT + iq) * kSt;
      const float fw = ex2(row[kDp] - mx);
      const float4 x = *reinterpret_cast<const float4*>(row + 4 * f);
      lsum = __fadd_rn(lsum, __fmul_rn(row[kDp + 1], fw));
      a.x = __fadd_rn(a.x, __fmul_rn(x.x, fw));
      a.y = __fadd_rn(a.y, __fmul_rn(x.y, fw));
      a.z = __fadd_rn(a.z, __fmul_rn(x.z, fw));
      a.w = __fadd_rn(a.w, __fmul_rn(x.w, fw));
    }
    const float inv = __frcp_rn(lsum == 0.f ? 1.f : lsum);
    *reinterpret_cast<float4*>(out + base + (size_t)qi * tok + 4 * f) =
        make_float4(__fmul_rn(a.x, inv), __fmul_rn(a.y, inv),
                    __fmul_rn(a.z, inv), __fmul_rn(a.w, inv));
    if (f == 0)
      lse[((size_t)b * H + h) * T + qi] =
          lsum == 0.f ? 0.5f * ptt::kNegInf : (mx + log2f(lsum)) * kLn2;
  }
}

template <int L, bool kExact>
cudaError_t launch_as(const void* q, const void* k, const void* v,
                      const void* seg, void* out, void* lse, int B, int T,
                      int H, int D, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int kQT = kTileQueries<L>;
  const int cap = kStageBytes / ((2 * (D + 4) + 1) * 4);
  const size_t floats = max((2 * (size_t)cap + kQT) * (D + 4),
                            (size_t)kW * kQT * (L * kDpl + 4));
  const size_t smem = ((3 * kQT + cap) * 4 + 15) / 16 * 16 +
                      floats * sizeof(float);
  auto kernel = flash_packed_fwd_kernel<L, kExact>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kQT - 1) / kQT, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg),
      static_cast<float*>(out), static_cast<float*>(lse), T, H, D, causal,
      scale, cap);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* out, void* lse, int B, int T,
                   int H, int D, int causal, float scale,
                   cudaStream_t stream) {
  return D == L * kDpl
             ? launch_as<L, true>(q, k, v, seg, out, lse, B, T, H, D, causal,
                                  scale, stream)
             : launch_as<L, false>(q, k, v, seg, out, lse, B, T, H, D,
                                   causal, scale, stream);
}

__global__ void empty_kernel() {}

}  // namespace

// q, k, v, out: [B, T, H, D] fp32 contiguous; seg: [B, T] int32;
// lse: [B, H, T] fp32.  Requires D % 4 == 0 and D <= 256.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).  A query's
// lanes: 4 of 8 dims at D <= 32, 8, 16 or 32 of 8 dims above; 8 warps
// a CTA, 2 queries a lane group.
extern "C" int flash_packed_fwd(const void* q, const void* k, const void* v,
                                const void* seg, void* out, void* lse,
                                int B, int T, int H, int D, int causal,
                                float scale, void* stream) {
  if (D <= 0 || D % 4 != 0 || D > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return (int)launch<4>(q, k, v, seg, out, lse, B, T, H, D, causal, scale,
                          s);
  if (D <= 64)
    return (int)launch<8>(q, k, v, seg, out, lse, B, T, H, D, causal, scale,
                          s);
  if (D <= 128)
    return (int)launch<16>(q, k, v, seg, out, lse, B, T, H, D, causal, scale,
                           s);
  return (int)launch<32>(q, k, v, seg, out, lse, B, T, H, D, causal, scale,
                         s);
}

// An empty kernel on `stream`: the launch floor the serving kernels'
// times sit on (timed by chip_smoke.py's phase 5).
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
