// Block-sparse flash attention forward, training form, for sm_90a.
//
// Replaces the TPU kernel `_fa_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_forward_sparse` for
// `flash_attention` (padded rows with key lengths) and
// `flash_attention_packed` (segment ids): out = softmax(q k^T * scale) v
// with the reference's masks (key past its row's length; above the
// diagonal when causal; packed, another segment or padding), and the
// per-query log-sum-exp lse [B, H, Tq] the backward kernels rebuild p
// from.  A row with no visible key emits zeros and lse = NEG_INF / 2.
//
// Design.  The TPU walks a (B*H, pairs) grid in order and carries the
// online softmax in VMEM across one q block's pairs.  Here a CTA owns 64
// query rows of one (batch row, head) (4 warps x 16 rows) and walks its
// own live key tiles in a loop: the window [lo, hi) of 64-key tiles
// computed outside the kernel (`ops/attention.py`: from the key lengths,
// or from the segment ids' ranges), capped by the causal diagonal.  Dead
// tiles are neither loaded nor visited.  K/V tiles of BN keys are
// double-buffered with cp.async; S = Q K^T runs on mma.sync (bf16, f32
// accumulators); the online softmax stays in registers (quad shuffles for
// row max and sum), in log2 units (the scale times log2 e, exponentials
// by ex2.approx), with the reference's max(m, NEG_INF / 2) clamp of the
// exponent base; P is fed to P V straight from the S accumulators, split
// into hi + lo bf16 in registers (V read with ldmatrix.trans).
//
// Bound on the H100 (the transformer step's shape: B 16, H 8, T 2048,
// D 64, bf16, non-causal, all keys valid): 4 B H T^2 D = 137.4 GFLOP,
// 139.0 us at 989 TFLOP/s bf16; its bytes (q, k, v read once, out and
// lse written once, ~135 MB) take ~40 us, so operations bound it.  The
// hi/lo split of P makes the kernel's own mma work 1.5x the contract's.
// Registers are capped for 4 CTAs an SM (the bf16 D = 64 kernel needs
// 142 uncapped; the cap measured ~1 % faster, tools/flash_probe.py).
//
// Legacy full grid (`flash_fwd_legacy`).  Also replaces the TPU kernel
// `_fa_kernel` (`_fa_forward_grid`), the (B*H, q blocks, k blocks) grid
// behind --flash_block_sparse=false that DMAs every K/V block and skips
// only the compute of a dead one (past the row's key length, or wholly
// above the causal diagonal).  It is this main loop instantiated with
// FULL: no windows; each CTA walks every key tile of the row and issues
// its loads, and runs the products and the softmax only on live tiles.
// The dead tiles form a suffix, so the result is the block-sparse one.
// Its bound is the same work plus the dead tiles' loads (K and V of
// every tile, once per q tile: at the causal T 2048 shape 2.1 GB of L2
// traffic, not device-memory bytes).
#include "flash_common.cuh"

using namespace fa;

namespace {

template <int D, typename T, bool FULL>
__global__ void __launch_bounds__(kThreads, 4)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ kv_lens,
                     const int* __restrict__ seg,
                     const int* __restrict__ win_lo,
                     const int* __restrict__ win_hi, int Tq, int Tk, int H,
                     long long sqb, long long sqt, long long skb,
                     long long skt, long long svb, long long svt, int causal,
                     float scale) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NP = SPLIT ? 2 : 1;                  // planes per operand
  constexpr int LDS = Tile<D>::LDS, BN = Tile<D>::BN;
  constexpr int QP = kRows * LDS, KP = BN * LDS;     // plane elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + NP * QP;                          // [stage][K, V]
  int* sSeg = reinterpret_cast<int*>(sKV + 4 * NP * KP);   // [stage][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kRows, nq = gridDim.x;
  const bool packed = seg != nullptr;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Tk) : Tk;
  // live keys [k_begin, k_end); the sparse walk visits only their
  // tiles, the full grid every tile of the row (computing the live ones)
  const int k_begin = FULL ? 0 : win_lo[b * nq + qt] * kRows;
  int k_end = FULL ? kv_len : min(win_hi[b * nq + qt] * kRows, kv_len);
  if (causal) k_end = min(k_end, q0 + kRows);
  const int n_tiles =
      FULL ? (Tk + BN - 1) / BN
           : (k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0);
  const float scale_log2 = scale * kLog2e;   // scores in log2 units

  const T* qb = q + b * sqb + h * D;
  const T* kb = k + b * skb + h * D;
  const T* vb = v + b * svb + h * D;
  const int* segb = packed ? seg + (long long)b * Tk : nullptr;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;    // this thread's rows
  const int sq0 = packed && r0 < Tq ? segb[r0] : -1;
  const int sq1 = packed && r1 < Tq ? segb[r1] : -1;

  auto kv_plane = [&](int s, int which) {
    return sKV + (2 * s + which) * NP * KP;
  };
  auto load_kv = [&](int i, int s) {
    const int k0 = k_begin + i * BN;
    load_rows<D, BN>(kv_plane(s, 0), KP, kb, skt, k0, Tk);
    load_rows<D, BN>(kv_plane(s, 1), KP, vb, svt, k0, Tk);
    if (packed) load_vec(sSeg + s * BN, segb, k0, BN, Tk);
  };

  float o[D / 8][4];
  zero<D>(o);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  if (n_tiles > 0) {
    load_rows<D, kRows>(sQ, QP, qb, sqt, q0, Tq);
    load_kv(0, 0);
  }
  cp_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    if (i + 1 < n_tiles) load_kv(i + 1, s ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = k_begin + i * BN;
    if (FULL && k0 >= k_end) {         // dead tile: loaded, not computed
      __syncthreads();
      continue;
    }
    float sc[BN / 8][4];
    zero<BN>(sc);
    gemm_nt<D, BN, SPLIT>(sc, sQ + warp * 16 * LDS, QP, kv_plane(s, 0), KP);

    // scale, mask, and the tile's row maxima
    const bool need = k0 + BN > kv_len || (causal && k0 + BN - 1 > q0) ||
                      packed;
    const int* sk = sSeg + s * BN;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (need) {
          const int col = j * 8 + 2 * t + (e & 1);
          if (!valid(e < 2 ? r0 : r1, k0 + col, kv_len, causal, packed,
                     e < 2 ? sq0 : sq1, packed ? sk[col] : 0))
            x = kNegInf;
        }
        sc[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no valid key so far keeps p = 0: exp(NEG_INF - NEG_INF/2)
    const float base0 = fmaxf(mn0, 0.5f * kNegInf);
    const float base1 = fmaxf(mn1, 0.5f * kNegInf);
    const float al0 = exp2_approx(m0 - base0);
    const float al1 = exp2_approx(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[j][0] = exp2_approx(sc[j][0] - base0);
      sc[j][1] = exp2_approx(sc[j][1] - base0);
      sc[j][2] = exp2_approx(sc[j][2] - base1);
      sc[j][3] = exp2_approx(sc[j][3] - base1);
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * al0 + rs0;                 // this lane's share of the row
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }
    gemm_pn<D, BN, SPLIT>(o, sc, kv_plane(s, 1), KP);
    __syncthreads();
  }

  // flush: out = acc / l (zeros for a row with no visible key)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < Tq)
      store2(out + ((long long)(b * Tq + r0) * H + h) * D + d, o[j][0] / ls0,
             o[j][1] / ls0);
    if (r1 < Tq)
      store2(out + ((long long)(b * Tq + r1) * H + h) * D + d, o[j][2] / ls1,
             o[j][3] / ls1);
  }
  if (t == 0) {
    // m is in log2 units; a row with no visible key (l = 0) has m =
    // NEG_INF and gets the reference's NEG_INF / 2 + log(1)
    float* lrow = lse + (long long)(b * H + h) * Tq;
    if (r0 < Tq)
      lrow[r0] = l0 == 0.f ? 0.5f * kNegInf : m0 * kLn2 + logf(l0);
    if (r1 < Tq)
      lrow[r1] = l1 == 0.f ? 0.5f * kNegInf : m1 * kLn2 + logf(l1);
  }
}

}  // namespace

namespace {

template <bool FULL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, const void* kv_lens,
                       const void* seg, const void* win_lo,
                       const void* win_hi, int B, int Tq, int Tk, int H,
                       int D, int dtype, long long sqb, long long sqt,
                       long long skb, long long skt, long long svb,
                       long long svt, int causal, float scale,
                       void* stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  return dispatch(D, dtype, [&](auto dc, auto tv) {
    constexpr int Dv = decltype(dc)::value;
    using T = decltype(tv);
    constexpr int BN = Tile<Dv>::BN;
    const size_t smem = plane_bytes<Dv, T>(kRows) +
                        4 * plane_bytes<Dv, T>(BN) + 2 * BN * sizeof(int);
    auto kern = flash_fwd_kernel<Dv, T, FULL>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), static_cast<const int*>(kv_lens),
        static_cast<const int*>(seg), static_cast<const int*>(win_lo),
        static_cast<const int*>(win_hi), Tq, Tk, H, sqb, sqt, skb, skt, svb,
        svt, causal, scale);
    return cudaGetLastError();
  });
}

}  // namespace

// q [B, Tq, H, D], k and v [B, Tk, H, D] (bf16 when dtype == 0, fp32
// when 1), each with its own batch and token strides (elements; a head's
// D values contiguous, heads D apart); out [B, Tq, H, D] contiguous in
// the same dtype; lse [B, H, Tq] f32.  kv_lens int32 [B] or null (all Tk
// valid); seg int32 [B, Tk] segment ids or null (padded mode; packed
// mode needs Tq == Tk); win_lo / win_hi int32 [B, ceil(Tq/64)], each q
// tile's live key tiles [lo, hi) in units of 64 keys.  D in {32, 64,
// 128}.  Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, const void* kv_lens,
                         const void* seg, const void* win_lo,
                         const void* win_hi, int B, int Tq, int Tk, int H,
                         int D, int dtype, long long sqb, long long sqt,
                         long long skb, long long skt, long long svb,
                         long long svt, int causal, float scale,
                         void* stream) {
  return static_cast<int>(launch_fwd<false>(
      q, k, v, out, lse, kv_lens, seg, win_lo, win_hi, B, Tq, Tk, H, D,
      dtype, sqb, sqt, skb, skt, svb, svt, causal, scale, stream));
}

// The legacy full grid (kernel 2): operands as flash_fwd's, padded mode
// only (no segment ids), no windows.
extern "C" int flash_fwd_legacy(const void* q, const void* k, const void* v,
                                void* out, void* lse, const void* kv_lens,
                                int B, int Tq, int Tk, int H, int D,
                                int dtype, long long sqb, long long sqt,
                                long long skb, long long skt, long long svb,
                                long long svt, int causal, float scale,
                                void* stream) {
  return static_cast<int>(launch_fwd<true>(
      q, k, v, out, lse, kv_lens, nullptr, nullptr, nullptr, B, Tq, Tk, H,
      D, dtype, sqb, sqt, skb, skt, svb, svt, causal, scale, stream));
}
