// Block-sparse flash attention backward, dk and dv, for sm_90a.
//
// Replaces the TPU kernel `_bwd_dkv_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_backward_sparse` over the
// k-major pair table: for each live (key tile, q tile) it rebuilds p
// (`_recompute_block`), accumulates dv += p^T do and, with ds = p * (do
// v^T - delta), dk += ds^T q * scale.
//
// Design.  A CTA owns 64 key rows of one (batch row, head) (4 warps x 16
// keys) and walks its live query tiles: the window [lo, hi) of 64-query
// tiles computed outside the kernel (padded: every q tile when the key
// tile starts below the row's length, else none, which writes zeros;
// packed: the tiles whose segment range meets the key tile's), starting
// at the diagonal when causal.  It computes S^T = K Q^T, so that P^T is
// the accumulator and feeds dV += P^T dO directly (hi + lo split, dO read
// with ldmatrix.trans); then dP^T = V dO^T, dS^T = P^T * (dP^T - delta)
// and dK += dS^T Q.  K and V are loaded once; Q, dO, lse, delta (and the
// query segment ids) are double-buffered with cp.async.  Each (batch row,
// head, key tile) has one owner: no atomics, the result deterministic.
// dk and dv are written once in k's and v's dtype.
//
// Bound on the H100 (B 16, H 8, T 2048, D 64, bf16, non-causal, all keys
// valid): four T x T x D products, 274.9 GFLOP, 277.9 us at 989 TFLOP/s
// bf16; bytes (~271 MB) ~81 us: operations bound it.  The split makes
// the kernel's own mma work 1.5x the contract's.
//
// Legacy full grid (`flash_bwd_dkv_legacy`).  Also replaces the TPU
// kernel `_bwd_dkv_kernel` (`_fa_backward_pallas`), the legacy grid's dk
// and dv: this main loop with FULL, which walks every q tile for the key
// tile, issuing its loads, and computes only the live ones (`_bwd_live`:
// the key tile below the row's length, the q tile not wholly above the
// causal diagonal; the dead q tiles form a prefix).
#include "flash_common.cuh"

using namespace fa;

namespace {

template <int D, typename T, bool FULL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
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
  constexpr int KP = kRows * LDS, QP = BN * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + NP * KP;
  bf16* sQD = sV + NP * KP;                          // [stage][Q, dO]
  float* sVec = reinterpret_cast<float*>(sQD + 4 * NP * QP);
  // per stage: lse [BN], delta [BN], query segment ids [BN]
  auto lse_s = [&](int s) { return sVec + s * 3 * BN; };
  auto delta_s = [&](int s) { return sVec + s * 3 * BN + BN; };
  auto seg_s = [&](int s) {
    return reinterpret_cast<int*>(sVec + s * 3 * BN + 2 * BN);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kRows, nk = gridDim.x;
  const bool packed = seg != nullptr;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Tk) : Tk;
  // live queries [q_live, q_end); the sparse walk visits only their
  // tiles, the full grid every q tile (computing the live ones)
  int q_live = FULL ? 0 : win_lo[b * nk + kt] * kRows;
  const int q_end =
      k0 < kv_len ? (FULL ? Tq : min(win_hi[b * nk + kt] * kRows, Tq)) : 0;
  if (causal) q_live = max(q_live, k0);
  const int q_begin = FULL ? 0 : q_live;
  const int n_tiles =
      FULL ? (Tq + BN - 1) / BN
           : (q_end > q_begin ? (q_end - q_begin + BN - 1) / BN : 0);
  const float scale_log2 = scale * kLog2e;   // p = 2^(s log2e - lse log2e)

  const T* qb = q + b * sqb + h * D;
  const T* db = dout + b * sdb + h * D;
  const float* lrow = lse + (long long)(b * H + h) * Tq;
  const float* drow = delta + (long long)(b * H + h) * Tq;
  const int* segb = packed ? seg + (long long)b * Tk : nullptr;
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;    // this thread's keys
  const int sk0 = packed && r0 < Tk ? segb[r0] : -2;
  const int sk1 = packed && r1 < Tk ? segb[r1] : -2;

  auto qd_plane = [&](int s, int which) {
    return sQD + (2 * s + which) * NP * QP;
  };
  auto load_q = [&](int i, int s) {
    const int q0 = q_begin + i * BN;
    load_rows<D, BN>(qd_plane(s, 0), QP, qb, sqt, q0, Tq);
    load_rows<D, BN>(qd_plane(s, 1), QP, db, sdt, q0, Tq);
    load_vec(lse_s(s), lrow, q0, BN, Tq);
    load_vec(delta_s(s), drow, q0, BN, Tq);
    if (packed) load_vec(seg_s(s), segb, q0, BN, Tq);
  };

  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);
  if (n_tiles > 0) {
    load_rows<D, kRows>(sK, KP, k + b * skb + h * D, skt, k0, Tk);
    load_rows<D, kRows>(sV, KP, v + b * svb + h * D, svt, k0, Tk);
    load_q(0, 0);
  }
  cp_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    if (i + 1 < n_tiles) load_q(i + 1, s ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int q0 = q_begin + i * BN;
    if (FULL && (q0 >= q_end || q0 + BN <= q_live)) {   // dead q tile
      __syncthreads();
      continue;
    }
    const float* sl = lse_s(s);
    const float* sd = delta_s(s);
    const int* sq = seg_s(s);
    float pt[BN / 8][4];
    zero<BN>(pt);
    gemm_nt<D, BN, SPLIT>(pt, sK + warp * 16 * LDS, KP, qd_plane(s, 0), QP);
    const bool need = q0 + BN > Tq || k0 + kRows > kv_len ||
                      (causal && k0 + kRows - 1 > q0) || packed;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float p =
            exp2_approx(fmaf(pt[j][e], scale_log2, -sl[col] * kLog2e));
        if (need) {
          const int qi = q0 + col;
          if (qi >= Tq || !valid(qi, e < 2 ? r0 : r1, kv_len, causal,
                                 packed, packed ? sq[col] : 0,
                                 e < 2 ? sk0 : sk1))
            p = 0.f;
        }
        pt[j][e] = p;
      }
    }
    gemm_pn<D, BN, SPLIT>(dva, pt, qd_plane(s, 1), QP);     // dV += P^T dO
    float dpt[BN / 8][4];
    zero<BN>(dpt);
    gemm_nt<D, BN, SPLIT>(dpt, sV + warp * 16 * LDS, KP, qd_plane(s, 1), QP);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        dpt[j][e] = pt[j][e] * (dpt[j][e] - sd[col]);         // dS^T
      }
    }
    gemm_pn<D, BN, SPLIT>(dka, dpt, qd_plane(s, 0), QP);     // dK += dS^T Q
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < Tk) {
      const long long o = ((long long)(b * Tk + r0) * H + h) * D + d;
      store2(dk + o, dka[j][0] * scale, dka[j][1] * scale);
      store2(dv + o, dva[j][0], dva[j][1]);
    }
    if (r1 < Tk) {
      const long long o = ((long long)(b * Tk + r1) * H + h) * D + d;
      store2(dk + o, dka[j][2] * scale, dka[j][3] * scale);
      store2(dv + o, dva[j][2], dva[j][3]);
    }
  }
}

}  // namespace

namespace {

template <bool FULL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* kv_lens,
                       const void* seg, const void* win_lo,
                       const void* win_hi, int B, int Tq, int Tk, int H,
                       int D, int dtype, long long sqb, long long sqt,
                       long long skb, long long skt, long long svb,
                       long long svt, long long sdb, long long sdt,
                       int causal, float scale, void* stream) {
  const dim3 grid((Tk + kRows - 1) / kRows, H, B);
  return dispatch(D, dtype, [&](auto dc, auto tv) {
    constexpr int Dv = decltype(dc)::value;
    using T = decltype(tv);
    constexpr int BN = Tile<Dv>::BN;
    const size_t smem = 2 * plane_bytes<Dv, T>(kRows) +
                        4 * plane_bytes<Dv, T>(BN) + 6 * BN * sizeof(float);
    auto kern = flash_bwd_dkv_kernel<Dv, T, FULL>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<const int*>(kv_lens), static_cast<const int*>(seg),
        static_cast<const int*>(win_lo), static_cast<const int*>(win_hi), Tq,
        Tk, H, sqb, sqt, skb, skt, svb, svt, sdb, sdt, causal, scale);
    return cudaGetLastError();
  });
}

}  // namespace

// Operands as flash_bwd_dq's; dk, dv [B, Tk, H, D] contiguous in k's
// dtype.  win_lo / win_hi int32 [B, ceil(Tk/64)]: each key tile's live
// query tiles [lo, hi) in units of 64 queries.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const void* kv_lens, const void* seg,
                             const void* win_lo, const void* win_hi, int B,
                             int Tq, int Tk, int H, int D, int dtype,
                             long long sqb, long long sqt, long long skb,
                             long long skt, long long svb, long long svt,
                             long long sdb, long long sdt, int causal,
                             float scale, void* stream) {
  return static_cast<int>(launch_dkv<false>(
      q, k, v, dout, lse, delta, dk, dv, kv_lens, seg, win_lo, win_hi, B,
      Tq, Tk, H, D, dtype, sqb, sqt, skb, skt, svb, svt, sdb, sdt, causal,
      scale, stream));
}

// The legacy full grid (kernel 6): padded mode only, no windows.
extern "C" int flash_bwd_dkv_legacy(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, const void* kv_lens,
                                    int B, int Tq, int Tk, int H, int D,
                                    int dtype, long long sqb, long long sqt,
                                    long long skb, long long skt,
                                    long long svb, long long svt,
                                    long long sdb, long long sdt, int causal,
                                    float scale, void* stream) {
  return static_cast<int>(launch_dkv<true>(
      q, k, v, dout, lse, delta, dk, dv, kv_lens, nullptr, nullptr, nullptr,
      B, Tq, Tk, H, D, dtype, sqb, sqt, skb, skt, svb, svt, sdb, sdt, causal,
      scale, stream));
}
