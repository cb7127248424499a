// Block-sparse flash attention backward, dk and dv, for sm_90a.
//
// Replaces the TPU kernel `_bwd_dkv_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_backward_sparse` over the
// k-major pair table: for each live (key tile, q tile) it rebuilds p
// (`_recompute_block`), accumulates dv += p^T do and, with ds = p * (do
// v^T - delta), dk += ds^T q * scale.  Each (batch row, head, key tile)
// has one owner: no atomics, the result deterministic.  dk and dv are
// written once in k's and v's dtype.
//
// Bound on the H100 (B 16, H 8, T 2048, D 64, bf16, non-causal, all keys
// valid): four T x T x D products, 274.9 GFLOP, 277.9 us at 989 TFLOP/s
// bf16; bytes (~271 MB) ~81 us: operations bound it.  The hi + lo split
// of P^T and dS^T makes the kernel's own tensor work 1.5x the contract's.
//
// bf16 at D <= 64 (every path of the transformer): the wgmma loop of
// flash_wg.cuh, one CTA an SM.  A CTA owns 128 key rows of one (batch
// row, head) in two warpgroups of 64.  Each warpgroup has its own live
// query range: its key tile's window [lo, hi) of 64-query tiles
// (`ops/attention.py`: every q tile when the key tile starts below the
// row's length, else none; packed, the tiles whose segment range meets
// the key tile's) or under FULL every q tile of a key tile below the
// length, from the key tile's start when causal.  K and V come by TMA
// once and stay; 64-query Q and dO tiles come by TMA into a 4-stage ring
// two tiles ahead, and the tile's lse and delta (64 each; packed, the
// queries' segment ids too) by cp.async into the same slot, waited for
// and published by the __syncthreads that frees the slot of tile i - 2
// -- in shared memory before the exponentials.  Per live tile i of a warpgroup: S^T = K Q^T and dP^T =
// V dO^T (wgmma SS chains, K-major), then dV += P^T dO and dK += dS^T Q
// of tile i - 1 (RS: P^T and dS^T from registers as hi + lo, dO and Q
// read MN-major from the tiles that fed the SS products) are issued back
// to back; P^T is formed on S^T's accumulators as the first group
// retires, dS^T = P^T (dP^T - delta) as the second, and both are split
// into the fragments of the next tile's products once the last retires.
// Every branch retires what it issued.  dK, dV, S^T, dP^T (128 f32 a
// thread) and the fragments (64) take one CTA an SM (at most 255
// registers).  Causal CTAs run heaviest first (the first key tiles).
//
// fp32, and bf16 at D 128 (its accumulators and fragments would not fit
// in 255 registers), keep the mma.sync loop: a CTA of 4 warps owns 64
// key rows (16 a warp), loads K and V once, double-buffers Q, dO, lse,
// delta (and the query segment ids) with cp.async, computes S^T = K Q^T
// so that P^T is the accumulator, and splits P^T and dS^T into hi + lo
// in registers.  Under FULL it walks every q tile, issuing its loads, and
// computes only the live ones.
//
// Legacy full grid (`flash_bwd_dkv_legacy`).  Also replaces the TPU
// kernel `_bwd_dkv_kernel` (`_fa_backward_pallas`), the legacy grid's dk
// and dv: this main loop with FULL.  On the wgmma loop a dead q tile
// (`_bwd_live`: the key tile past the row's length, or the q tile wholly
// above the causal diagonal; the dead tiles form a prefix) is neither
// loaded nor visited, so the result is the block-sparse one.
#include "flash_wg.cuh"

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

// ------------------------------------------------ bf16: the wgmma loop
// 4-byte values a ring slot: lse, delta, the queries' segment ids
constexpr int kVec = 3 * kKeys;

template <int D>
constexpr size_t dkv_smem() {
  return 1024 + 2 * Wg<D>::QB + kWgStages * 2 * Wg<D>::KVB +
         kWgStages * kVec * sizeof(float) + (1 + kWgStages) * sizeof(uint64_t);
}

// The key rows' masks (r0 and r0 + 8 of this thread, their segment ids
// sk0, sk1) against the 64 queries of a tile.
struct KeyMask {
  int r0, kv_len, tq, sk0, sk1;
  bool causal, packed;
};

// S^T (accumulator layout: rows keys, columns queries) in place to p^T =
// 2^(s * scale_log2 - lse_log2) with each column's lse (and segment id)
// from the slot's vectors vec; MASK zeroes the masked elements (a query
// past Tq, the forward's masks).
template <bool MASK>
__device__ __forceinline__ void pt_tile(float (&sc)[32], float scale_log2,
                                        const float* vec, int q0,
                                        const KeyMask& km) {
  const int t = threadIdx.x & 3;
  const int* sq = reinterpret_cast<const int*>(vec + 2 * kKeys);
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t);
    int2 qs = make_int2(0, 0);
    if (MASK && km.packed)
      qs = *reinterpret_cast<const int2*>(sq + 8 * j + 2 * t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p = exp2_approx(fmaf(sc[4 * j + c], scale_log2,
                                 -((c & 1) ? l.y : l.x) * kLog2e));
      if constexpr (MASK) {
        const int qi = q0 + 8 * j + 2 * t + (c & 1);
        if (qi >= km.tq ||
            !valid(qi, km.r0 + (c < 2 ? 0 : 8), km.kv_len, km.causal,
                   km.packed, (c & 1) ? qs.y : qs.x, c < 2 ? km.sk0 : km.sk1))
          p = 0.f;
      }
      sc[4 * j + c] = p;
    }
  }
}

template <int D, bool FULL>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                            const __grid_constant__ CUtensorMap tmk,
                            const __grid_constant__ CUtensorMap tmv,
                            const __grid_constant__ CUtensorMap tmdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            const int* __restrict__ kv_lens,
                            const int* __restrict__ seg,
                            const int* __restrict__ win_lo,
                            const int* __restrict__ win_hi, int Tq, int Tk,
                            int H, int causal, float scale) {
  constexpr int QB = Wg<D>::QB, KVB = Wg<D>::KVB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = wg::align1024(smem_raw);
  unsigned char* sV = sK + QB;
  unsigned char* sQD = sV + QB;                     // [stage][Q, dO]
  float* sVec = reinterpret_cast<float*>(sQD + kWgStages * 2 * KVB);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(sVec + kWgStages * kVec);
  uint64_t* full = kv_bar + 1;                       // [stage] landed

  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ct = blockIdx.z;      // causal: the first key tiles see most
  const int nk = (Tk + kRows - 1) / kRows;     // 64-key tiles (windows)
  const bool packed = seg != nullptr;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Tk) : Tk;

  // live queries [lo, hi) of key tile kt: its window, or under FULL every
  // query; none past the key length; from the key tile's start when causal
  auto live = [&](int kt, int& lo, int& hi) {
    lo = hi = 0;
    if (kt >= nk || kt * kRows >= kv_len) return;
    lo = FULL ? 0 : win_lo[b * nk + kt] * kRows;
    hi = FULL ? Tq : min(win_hi[b * nk + kt] * kRows, Tq);
    if (causal) lo = max(lo, kt * kRows);
    if (hi <= lo) lo = hi = 0;
  };
  int lo0, hi0, lo1, hi1;
  live(2 * ct, lo0, hi0);
  live(2 * ct + 1, lo1, hi1);
  const int t_lo = hi0 == 0 ? lo1 / kKeys
                   : hi1 == 0 ? lo0 / kKeys : min(lo0, lo1) / kKeys;
  const int n_tiles = max((max(hi0, hi1) + kKeys - 1) / kKeys - t_lo, 0);
  const int my_lo = wgi ? lo1 : lo0, my_hi = wgi ? hi1 : hi0;
  const int a = my_hi > 0 ? my_lo / kKeys - t_lo : 0;
  const int e = my_hi > 0 ? (my_hi + kKeys - 1) / kKeys - t_lo : 0;

  const int k0w = ct * kCtaRows + wgi * 64;    // this warpgroup's keys
  const int r0 = k0w + wq * 16 + g, r1 = r0 + 8;
  const float scale_log2 = scale * kLog2e;
  // a q tile has masked elements when it runs past Tq, meets the causal
  // diagonal, the keys run past the length, or (packed) always
  const bool all_mask = packed || k0w + kKeys > kv_len;
  const int* segb = packed ? seg + (long long)b * Tk : nullptr;
  const int sk0 = packed && r0 < Tk ? segb[r0] : -2;
  const int sk1 = packed && r1 < Tk ? segb[r1] : -2;
  auto key_mask = [&]() {
    KeyMask km;
    km.r0 = r0;
    km.kv_len = kv_len;
    km.tq = Tq;
    km.sk0 = sk0;
    km.sk1 = sk1;
    km.causal = causal != 0;
    km.packed = packed;
    return km;
  };

  const float* lrow = lse + (long long)(b * H + h) * Tq;
  const float* drow = delta + (long long)(b * H + h) * Tq;
  const uint32_t k_addr = wg::smem_u32(sK), v_addr = wg::smem_u32(sV);
  const uint32_t qd_addr = wg::smem_u32(sQD);
  auto qtile = [&](int i) { return qd_addr + (i % kWgStages) * 2 * KVB; };
  // tile i's Q and dO into ring slot i % kWgStages (thread 0, TMA) and
  // its lse, delta and (packed) segment ids (threads 0-191, cp.async,
  // zeros past Tq; the caller commits the group)
  auto load_q = [&](int i) {
    const int s = i % kWgStages, q0 = (t_lo + i) * kKeys;
    if (tid == 0) {
      unsigned char* qt = sQD + s * 2 * KVB;
      wg::mbar_expect(full + s, 2 * KVB);
      tma_tile<D, kKeys>(qt, &tmq, full + s, h, q0, b);
      tma_tile<D, kKeys>(qt + KVB, &tmdo, full + s, h, q0, b);
    }
    if (tid < (packed ? 3 : 2) * kKeys) {
      const int qi = q0 + tid % kKeys, which = tid / kKeys;
      const bool ok = qi < Tq;
      const int at = ok ? qi : 0;
      cp_async4(sVec + s * kVec + tid,
                which == 0 ? static_cast<const void*>(lrow + at)
                : which == 1 ? static_cast<const void*>(drow + at)
                             : static_cast<const void*>(segb + at),
                ok);
    }
  };

  if (tid == 0) {
    wg::mbar_init(kv_bar, 1);
    for (int s = 0; s < kWgStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    wg::mbar_expect(kv_bar, 2 * QB);
    tma_tile<D, kCtaRows>(sK, &tmk, kv_bar, h, ct * kCtaRows, b);
    tma_tile<D, kCtaRows>(sV, &tmv, kv_bar, h, ct * kCtaRows, b);
  }
  for (int i = 0; i < kAhead; ++i) {
    if (i < n_tiles) load_q(i);
    cp_commit();
  }

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float sc[32], dp[32];
  uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];
  uint32_t sh[kKeys / 16][4], sl[kKeys / 16][4];
  // Per live tile i: S^T and dP^T of tile i, then dV and dK of tile i - 1
  // are issued together; P^T, dS^T and their fragments follow as the
  // groups retire.  The ring keeps tile i - 1's Q and dO until its
  // products are done.
  for (int i = 0; i < n_tiles; ++i) {
    cp_wait<kAhead - 1>();               // this thread's vectors of tile i
    __syncthreads();                     // ... everyone's; i - 2 is free
    if (i + kAhead < n_tiles) load_q(i + kAhead);
    cp_commit();
    if (i < a || i >= e) continue;       // not a tile of this warpgroup
    if (i == a) wg::mbar_wait(kv_bar, 0);
    wg::mbar_wait(full + i % kWgStages, (i / kWgStages) & 1);
    const int q0 = (t_lo + i) * kKeys;
    const float* vec = sVec + (i % kWgStages) * kVec;
    auto step = [&](auto first, auto mask) {
      constexpr bool F = decltype(first)::value, M = decltype(mask)::value;
      issue_s<D>(sc, k_addr, wgi * 64, qtile(i));
      issue_s<D>(dp, v_addr, wgi * 64, qtile(i) + KVB);
      if constexpr (!F) {
        issue_pv<D>(dva, ph, pl, qtile(i - 1) + KVB);
        issue_pv<D>(dka, sh, sl, qtile(i - 1));
      }
      wg::wait<F ? 1 : 3>();             // S^T of tile i is done
      wg::fence_acc<32>(sc);
      pt_tile<M>(sc, scale_log2, vec, q0, M ? key_mask() : KeyMask{});
      wg::wait<F ? 0 : 2>();             // dP^T of tile i is done
      wg::fence_acc<32>(dp);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(
            vec + kKeys + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dp[4 * j + c] =
              sc[4 * j + c] * (dp[4 * j + c] - ((c & 1) ? d.y : d.x));
      }
      if constexpr (!F) {
        wg::wait<0>();                   // dV, dK of tile i - 1 are done
        wg::fence_acc<D / 2>(dva);
        wg::fence_acc<D / 2>(dka);
      }
      split_p(sc, ph, pl);
      split_p(dp, sh, sl);
    };
    const bool need = all_mask || q0 + kKeys > Tq ||
                      (causal && q0 < k0w + kKeys);
    if (i == a) {
      step(std::true_type{}, std::true_type{});
    } else if (need) {
      step(std::false_type{}, std::true_type{});
    } else {
      step(std::false_type{}, std::false_type{});
    }
    if (i == e - 1) {                    // dV, dK of the last live tile
      issue_pv<D>(dva, ph, pl, qtile(i) + KVB);
      issue_pv<D>(dka, sh, sl, qtile(i));
      wg::wait<0>();
      wg::fence_acc<D / 2>(dva);
      wg::fence_acc<D / 2>(dka);
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < Tk) {
      const long long o = ((long long)(b * Tk + r0) * H + h) * D + d;
      store2(dk + o, dka[4 * j] * scale, dka[4 * j + 1] * scale);
      store2(dv + o, dva[4 * j], dva[4 * j + 1]);
    }
    if (r1 < Tk) {
      const long long o = ((long long)(b * Tk + r1) * H + h) * D + d;
      store2(dk + o, dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      store2(dv + o, dva[4 * j + 2], dva[4 * j + 3]);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && (D == 32 || D == 64)) {       // bf16: the wgmma loop
    const dim3 grid(H, B, (Tk + kCtaRows - 1) / kCtaRows);
    auto go = [&](auto dc) {
      constexpr int Dv = decltype(dc)::value;
      CUtensorMap tmq, tmk, tmv, tmdo;
      if (!operand_map<Dv>(&tmk, k, B, Tk, H, skb, skt, kCtaRows) ||
          !operand_map<Dv>(&tmv, v, B, Tk, H, svb, svt, kCtaRows) ||
          !operand_map<Dv>(&tmq, q, B, Tq, H, sqb, sqt, kKeys) ||
          !operand_map<Dv>(&tmdo, dout, B, Tq, H, sdb, sdt, kKeys))
        return cudaErrorInvalidValue;
      auto kern = flash_bwd_dkv_wg_kernel<Dv, FULL>;
      cudaError_t err = allow_smem(kern, dkv_smem<Dv>());
      if (err != cudaSuccess) return err;
      kern<<<grid, kWgThreads, dkv_smem<Dv>(), st>>>(
          tmq, tmk, tmv, tmdo, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), static_cast<const int*>(kv_lens),
          static_cast<const int*>(seg), static_cast<const int*>(win_lo),
          static_cast<const int*>(win_hi), Tq, Tk, H, causal, scale);
      return cudaGetLastError();
    };
    if (D == 32) return go(std::integral_constant<int, 32>{});
    return go(std::integral_constant<int, 64>{});
  }
  // fp32, and bf16 at D 128: the mma.sync loop
  const dim3 grid((Tk + kRows - 1) / kRows, H, B);
  return dispatch(D, dtype, [&](auto dc, auto tv) {
    constexpr int Dv = decltype(dc)::value;
    using T = decltype(tv);
    if constexpr (sizeof(T) == 2 && Dv != 128) {
      return cudaErrorInvalidValue;
    } else {
      constexpr int BN = Tile<Dv>::BN;
      const size_t smem = 2 * plane_bytes<Dv, T>(kRows) +
                          4 * plane_bytes<Dv, T>(BN) + 6 * BN * sizeof(float);
      auto kern = flash_bwd_dkv_kernel<Dv, T, FULL>;
      cudaError_t err = allow_smem(kern, smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv),
          static_cast<const int*>(kv_lens), static_cast<const int*>(seg),
          static_cast<const int*>(win_lo), static_cast<const int*>(win_hi),
          Tq, Tk, H, sqb, sqt, skb, skt, svb, svt, sdb, sdt, causal, scale);
      return cudaGetLastError();
    }
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
