// Block-sparse flash attention backward, dq, for sm_90a.
//
// Replaces the TPU kernel `_bwd_dq_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_backward_sparse` over the
// q-major pair table: for each live (q tile, key tile) it rebuilds
// p = exp(s * scale - lse) with the forward's masks
// (`_recompute_block`), forms ds = p * (do v^T - delta) and accumulates
// dq += ds k * scale.  delta = sum_d do * out is a torch op outside the
// kernel, as the reference computes it outside its kernels
// (`_bwd_residual_streams`).
//
// Design.  A CTA owns 64 query rows of one (batch row, head) and walks
// the same live key tiles as flash_fwd.cu (the window [lo, hi) of
// 64-key tiles, capped by the causal diagonal).  Q and dO are loaded
// once; K/V tiles of BN keys are double-buffered with cp.async.  S = Q
// K^T and dP = dO V^T run on mma.sync (bf16, f32 accumulators); P and dS
// stay in registers in the accumulator layout, and dS is fed to dS K
// (K read with ldmatrix.trans) split into hi + lo bf16.  dq is written
// once, cast to q's dtype (the reference's cast after its kernel).
//
// Bound on the H100 (B 16, H 8, T 2048, D 64, bf16, non-causal, all keys
// valid): three T x T x D products, 206.2 GFLOP, 208.5 us at 989 TFLOP/s
// bf16; bytes (q, k, v, do, lse, delta read once, dq written once,
// ~203 MB) ~61 us: operations bound it.  The split makes the kernel's
// own mma work 1.33x the contract's.  Registers are capped for 4 CTAs an
// SM (168 uncapped at bf16 D = 64; the cap measured ~3 % faster,
// tools/flash_probe.py).
//
// Legacy full grid (`flash_bwd_dq_legacy`).  Also replaces the TPU
// kernel `_bwd_dq_kernel` (`_fa_backward_pallas`), the legacy grid's dq:
// this main loop with FULL, which walks every key tile of the row,
// issuing its loads, and computes only the live ones (`_bwd_live`: below
// the key length and not wholly above the causal diagonal).
#include "flash_common.cuh"

using namespace fa;

namespace {

template <int D, typename T, bool FULL>
__global__ void __launch_bounds__(kThreads, 4)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ seg,
                        const int* __restrict__ win_lo,
                        const int* __restrict__ win_hi, int Tq, int Tk,
                        int H, long long sqb, long long sqt, long long skb,
                        long long skt, long long svb, long long svt,
                        long long sdb, long long sdt, int causal,
                        float scale) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NP = SPLIT ? 2 : 1;
  constexpr int LDS = Tile<D>::LDS, BN = Tile<D>::BN;
  constexpr int QP = kRows * LDS, KP = BN * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + NP * QP;
  bf16* sKV = sDO + NP * QP;                         // [stage][K, V]
  int* sSeg = reinterpret_cast<int*>(sKV + 4 * NP * KP);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kRows, nq = gridDim.x;
  const bool packed = seg != nullptr;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Tk) : Tk;
  const int k_begin = FULL ? 0 : win_lo[b * nq + qt] * kRows;
  int k_end = FULL ? kv_len : min(win_hi[b * nq + qt] * kRows, kv_len);
  if (causal) k_end = min(k_end, q0 + kRows);
  const int n_tiles =
      FULL ? (Tk + BN - 1) / BN
           : (k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0);

  const T* kb = k + b * skb + h * D;
  const T* vb = v + b * svb + h * D;
  const int* segb = packed ? seg + (long long)b * Tk : nullptr;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int sq0 = packed && r0 < Tq ? segb[r0] : -1;
  const int sq1 = packed && r1 < Tq ? segb[r1] : -1;
  const float* lrow = lse + (long long)(b * H + h) * Tq;
  const float* drow = delta + (long long)(b * H + h) * Tq;
  // p = exp(s * scale - lse) = 2^(s * scale * log2 e - lse * log2 e)
  const float scale_log2 = scale * kLog2e;
  const float lse0 = r0 < Tq ? lrow[r0] * kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lrow[r1] * kLog2e : 0.f;
  const float dl0 = r0 < Tq ? drow[r0] : 0.f;
  const float dl1 = r1 < Tq ? drow[r1] : 0.f;

  auto kv_plane = [&](int s, int which) {
    return sKV + (2 * s + which) * NP * KP;
  };
  auto load_kv = [&](int i, int s) {
    const int k0 = k_begin + i * BN;
    load_rows<D, BN>(kv_plane(s, 0), KP, kb, skt, k0, Tk);
    load_rows<D, BN>(kv_plane(s, 1), KP, vb, svt, k0, Tk);
    if (packed) load_vec(sSeg + s * BN, segb, k0, BN, Tk);
  };

  float acc[D / 8][4];
  zero<D>(acc);
  if (n_tiles > 0) {
    load_rows<D, kRows>(sQ, QP, q + b * sqb + h * D, sqt, q0, Tq);
    load_rows<D, kRows>(sDO, QP, dout + b * sdb + h * D, sdt, q0, Tq);
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
    float sc[BN / 8][4], dp[BN / 8][4];
    zero<BN>(sc);
    zero<BN>(dp);
    gemm_nt<D, BN, SPLIT>(sc, sQ + warp * 16 * LDS, QP, kv_plane(s, 0), KP);
    gemm_nt<D, BN, SPLIT>(dp, sDO + warp * 16 * LDS, QP, kv_plane(s, 1), KP);
    const bool need = k0 + BN > kv_len || (causal && k0 + BN - 1 > q0) ||
                      packed;
    const int* sk = sSeg + s * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        float p = exp2_approx(
            fmaf(sc[j][e], scale_log2, -(top ? lse0 : lse1)));
        if (need) {
          const int col = j * 8 + 2 * t + (e & 1);
          if (!valid(top ? r0 : r1, k0 + col, kv_len, causal, packed,
                     top ? sq0 : sq1, packed ? sk[col] : 0))
            p = 0.f;
        }
        sc[j][e] = p * (dp[j][e] - (top ? dl0 : dl1));   // ds
      }
    }
    gemm_pn<D, BN, SPLIT>(acc, sc, kv_plane(s, 0), KP);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < Tq)
      store2(dq + ((long long)(b * Tq + r0) * H + h) * D + d,
             acc[j][0] * scale, acc[j][1] * scale);
    if (r1 < Tq)
      store2(dq + ((long long)(b * Tq + r1) * H + h) * D + d,
             acc[j][2] * scale, acc[j][3] * scale);
  }
}

}  // namespace

namespace {

template <bool FULL>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* kv_lens, const void* seg,
                      const void* win_lo, const void* win_hi, int B, int Tq,
                      int Tk, int H, int D, int dtype, long long sqb,
                      long long sqt, long long skb, long long skt,
                      long long svb, long long svt, long long sdb,
                      long long sdt, int causal, float scale, void* stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  return dispatch(D, dtype, [&](auto dc, auto tv) {
    constexpr int Dv = decltype(dc)::value;
    using T = decltype(tv);
    constexpr int BN = Tile<Dv>::BN;
    const size_t smem = 2 * plane_bytes<Dv, T>(kRows) +
                        4 * plane_bytes<Dv, T>(BN) + 2 * BN * sizeof(int);
    auto kern = flash_bwd_dq_kernel<Dv, T, FULL>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), static_cast<const int*>(kv_lens),
        static_cast<const int*>(seg), static_cast<const int*>(win_lo),
        static_cast<const int*>(win_hi), Tq, Tk, H, sqb, sqt, skb, skt, svb,
        svt, sdb, sdt, causal, scale);
    return cudaGetLastError();
  });
}

}  // namespace

// Operands as flash_fwd's, plus dout [B, Tq, H, D] (strides sdb, sdt) in
// q's dtype, lse and delta [B, H, Tq] f32; dq [B, Tq, H, D] contiguous in
// q's dtype.  The window arrays are the forward's.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, const void* kv_lens,
                            const void* seg, const void* win_lo,
                            const void* win_hi, int B, int Tq, int Tk, int H,
                            int D, int dtype, long long sqb, long long sqt,
                            long long skb, long long skt, long long svb,
                            long long svt, long long sdb, long long sdt,
                            int causal, float scale, void* stream) {
  return static_cast<int>(launch_dq<false>(
      q, k, v, dout, lse, delta, dq, kv_lens, seg, win_lo, win_hi, B, Tq,
      Tk, H, D, dtype, sqb, sqt, skb, skt, svb, svt, sdb, sdt, causal, scale,
      stream));
}

// The legacy full grid (kernel 5): padded mode only, no windows.
extern "C" int flash_bwd_dq_legacy(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, const void* kv_lens, int B,
                                   int Tq, int Tk, int H, int D, int dtype,
                                   long long sqb, long long sqt,
                                   long long skb, long long skt,
                                   long long svb, long long svt,
                                   long long sdb, long long sdt, int causal,
                                   float scale, void* stream) {
  return static_cast<int>(launch_dq<true>(
      q, k, v, dout, lse, delta, dq, kv_lens, nullptr, nullptr, nullptr, B,
      Tq, Tk, H, D, dtype, sqb, sqt, skb, skt, svb, svt, sdb, sdt, causal,
      scale, stream));
}
