// Block-sparse flash attention backward, dq, for sm_90a.
//
// Replaces the TPU kernel `_bwd_dq_pair_kernel` (paddle_tpu/ops/
// pallas_attention.py), launched by `_fa_backward_sparse` over the
// q-major pair table: for each live (q tile, key tile) it rebuilds
// p = exp(s * scale - lse) with the forward's masks
// (`_recompute_block`), forms ds = p * (do v^T - delta) and accumulates
// dq += ds k * scale.  delta = sum_d do * out is a torch op outside the
// kernel, as the reference computes it outside its kernels
// (`_bwd_residual_streams`).  dq is written once, cast to q's dtype (the
// reference's cast after its kernel).
//
// Bound on the H100 (B 16, H 8, T 2048, D 64, bf16, non-causal, all keys
// valid): three T x T x D products, 206.2 GFLOP, 208.5 us at 989 TFLOP/s
// bf16; bytes (q, k, v, do, lse, delta read once, dq written once,
// ~203 MB) ~61 us: operations bound it.  The hi + lo split of dS makes
// the kernel's own tensor work 4/3 of the contract's.
//
// bf16 (every path of the transformer): the wgmma loop of flash_wg.cuh,
// one CTA an SM.  A CTA owns 128 query rows of one (batch row, head) in
// two warpgroups of 64, each with its own live key range (its q tile's
// window [lo, hi) of 64-key tiles, or under FULL the whole row; both
// capped by the key length and the causal diagonal), as flash_fwd.cu's
// forward.  Q and dO come by TMA once; 64-key K/V tiles come by TMA into
// a 4-stage ring two tiles ahead (one thread issues the copies, an
// mbarrier a slot counts their bytes; one __syncthreads a tile frees the
// slot of tile i - 2), packed, with the tile's key segment ids by
// cp.async into the same slot (read per element from global memory,
// they stalled the exponentials).  Per live tile i of a warpgroup: S = Q K^T and dP
// = dO V^T (wgmma SS chains, K-major) and dQ += dS K of tile i - 1 (RS:
// dS from registers as hi + lo, K read MN-major from the tile that fed
// S) are issued back to back; P is formed on S's accumulators as the
// first group retires (one FFMA and one ex2.approx an element, the
// forward's masks; lse and delta of the thread's two rows sit in
// registers), dS = P (dP - delta) as the second retires, and dS is split
// into the fragments the next tile's dQ product reads once the third
// retires.  Every branch retires what it issued (nothing in flight
// across the loop, or ptxas serializes the groups).  The accumulators
// (dQ, S, dP: 96 f32 a thread at D 64) and dS's fragments (32) take
// more than the 128 registers of two CTAs an SM, so one CTA of 255 at
// most runs an SM, and the two warpgroups' math and products overlap.
// Causal CTAs run heaviest first (the last q tiles first).
//
// fp32 keeps the mma.sync loop (flash_common.cuh's SPLIT numbers): a CTA
// of 4 warps owns 64 query rows and double-buffers BN-key K/V tiles by
// cp.async; dS is split into hi + lo in registers.  Under FULL it
// walks every key tile of the row, issuing its loads, and computes only
// the live ones.
//
// Legacy full grid (`flash_bwd_dq_legacy`).  Also replaces the TPU
// kernel `_bwd_dq_kernel` (`_fa_backward_pallas`), the legacy grid's dq:
// this main loop with FULL.  On the wgmma loop a dead tile (`_bwd_live`:
// past the key length or wholly above the causal diagonal) is neither
// loaded nor visited; the legacy grid's dead key tiles are a suffix, so
// the result is the block-sparse one.
#include "flash_wg.cuh"

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

// ------------------------------------------------ bf16: the wgmma loop
template <int D>
constexpr size_t dq_smem() {
  return 1024 + 2 * Wg<D>::QB + kWgStages * 2 * Wg<D>::KVB +
         kWgStages * kKeys * sizeof(int) + (1 + kWgStages) * sizeof(uint64_t);
}

// S (accumulator layout) in place to p = 2^(s * scale_log2 - lse_log2)
// for the thread's rows (lse0 for r0, lse1 for r0 + 8, in log2 units);
// MASK zeroes the masked elements (the forward's masks; packed, the
// tile's key segment ids sk from shared memory).
template <bool MASK>
__device__ __forceinline__ void p_tile(float (&sc)[32], float scale_log2,
                                       float lse0, float lse1, int k0,
                                       const TileMask& tm, const int* sk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    int2 ks = make_int2(0, 0);
    if (MASK && tm.packed)
      ks = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p = exp2_approx(fmaf(sc[4 * j + c], scale_log2,
                                 -(c < 2 ? lse0 : lse1)));
      if constexpr (MASK) {
        const int col = j * 8 + 2 * t + (c & 1);
        if (!valid(tm.r0 + (c < 2 ? 0 : 8), k0 + col, tm.kv_len, tm.causal,
                   tm.packed, c < 2 ? tm.sq0 : tm.sq1,
                   (c & 1) ? ks.y : ks.x))
          p = 0.f;
      }
      sc[4 * j + c] = p;
    }
  }
}

// PACKED (segment ids; never with FULL) is a template switch, so that the
// padded loop compiles without the ids' staging and registers (with a
// run-time switch it ran 5 % slower on the H100).
template <int D, bool FULL, bool PACKED>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           const __grid_constant__ CUtensorMap tmdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ seg,
                           const int* __restrict__ win_lo,
                           const int* __restrict__ win_hi, int Tq, int Tk,
                           int H, int causal, float scale) {
  constexpr int QB = Wg<D>::QB, KVB = Wg<D>::KVB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = wg::align1024(smem_raw);
  unsigned char* sDO = sQ + QB;
  unsigned char* sKV = sDO + QB;                    // [stage][K, V]
  int* sSeg = reinterpret_cast<int*>(sKV + kWgStages * 2 * KVB);  // [stage]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sSeg + kWgStages * kKeys);
  uint64_t* full = q_bar + 1;                        // [stage] landed

  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the last (heaviest) q tiles first
  const int ct = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int nq = (Tq + kRows - 1) / kRows;     // 64-row q tiles (windows)
  constexpr bool packed = PACKED;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Tk) : Tk;

  // live keys [lo, hi) of q tile qt: its window, or under FULL the row;
  // capped by the key length and the causal diagonal
  auto live = [&](int qt, int& lo, int& hi) {
    lo = hi = 0;
    if (qt >= nq) return;
    lo = FULL ? 0 : win_lo[b * nq + qt] * kRows;
    hi = FULL ? kv_len : min(win_hi[b * nq + qt] * kRows, kv_len);
    if (causal) hi = min(hi, qt * kRows + kRows);
    if (hi <= lo) lo = hi = 0;
  };
  int lo0, hi0, lo1, hi1;
  live(2 * ct, lo0, hi0);
  live(2 * ct + 1, lo1, hi1);
  // the CTA loads the union of its warpgroups' tiles; a warpgroup
  // computes its own, [a, e) of the CTA's walk
  const int t_lo = hi0 == 0 ? lo1 / kKeys
                   : hi1 == 0 ? lo0 / kKeys : min(lo0, lo1) / kKeys;
  const int n_tiles = max((max(hi0, hi1) + kKeys - 1) / kKeys - t_lo, 0);
  const int my_lo = wgi ? lo1 : lo0, my_hi = wgi ? hi1 : hi0;
  const int a = my_hi > 0 ? my_lo / kKeys - t_lo : 0;
  const int e = my_hi > 0 ? (my_hi + kKeys - 1) / kKeys - t_lo : 0;

  const int q0w = ct * kCtaRows + wgi * 64;    // this warpgroup's rows
  const int r0 = q0w + wq * 16 + g, r1 = r0 + 8;
  const float scale_log2 = scale * kLog2e;   // scores in log2 units
  // tiles from first_mask on have masked elements: past the key length,
  // on the causal diagonal, or (packed) any
  const int first_mask =
      packed ? 0
             : min(kv_len / kKeys - t_lo,
                   causal ? q0w / kKeys - t_lo : n_tiles);
  const int* segb = packed ? seg + (long long)b * Tk : nullptr;
  const int sq0 = packed && r0 < Tq ? segb[r0] : -1;
  const int sq1 = packed && r1 < Tq ? segb[r1] : -1;
  auto tile_mask = [&]() {
    TileMask tm;
    tm.r0 = r0;
    tm.kv_len = kv_len;
    tm.tk = Tk;
    tm.sq0 = sq0;
    tm.sq1 = sq1;
    tm.causal = causal != 0;
    tm.packed = packed;
    return tm;
  };
  // p = exp(s * scale - lse) = 2^(s * scale_log2 - lse * log2 e); rows
  // past Tq read lse = delta = 0 (their dq is not written)
  const float* lrow = lse + (long long)(b * H + h) * Tq;
  const float* drow = delta + (long long)(b * H + h) * Tq;
  const float lse0 = r0 < Tq ? lrow[r0] * kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lrow[r1] * kLog2e : 0.f;
  const float dl0 = r0 < Tq ? drow[r0] : 0.f;
  const float dl1 = r1 < Tq ? drow[r1] : 0.f;

  const uint32_t q_addr = wg::smem_u32(sQ), do_addr = wg::smem_u32(sDO);
  const uint32_t kv_addr = wg::smem_u32(sKV);
  auto ktile = [&](int i) { return kv_addr + (i % kWgStages) * 2 * KVB; };
  // tile i's K and V into ring slot i % kWgStages (thread 0, TMA) and,
  // packed, its key segment ids (threads 0-63, cp.async; the caller
  // commits the group)
  auto load_kv = [&](int i) {
    const int s = i % kWgStages, k0 = (t_lo + i) * kKeys;
    if (tid == 0) {
      unsigned char* kt = sKV + s * 2 * KVB;
      wg::mbar_expect(full + s, 2 * KVB);
      tma_tile<D, kKeys>(kt, &tmk, full + s, h, k0, b);
      tma_tile<D, kKeys>(kt + KVB, &tmv, full + s, h, k0, b);
    }
    if (PACKED && tid < kKeys) {
      const bool ok = k0 + tid < Tk;
      cp_async4(sSeg + s * kKeys + tid, segb + (ok ? k0 + tid : 0), ok);
    }
  };

  if (tid == 0) {
    wg::mbar_init(q_bar, 1);
    for (int s = 0; s < kWgStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    wg::mbar_expect(q_bar, 2 * QB);
    tma_tile<D, kCtaRows>(sQ, &tmq, q_bar, h, ct * kCtaRows, b);
    tma_tile<D, kCtaRows>(sDO, &tmdo, q_bar, h, ct * kCtaRows, b);
  }
  for (int i = 0; i < kAhead; ++i) {
    if (i < n_tiles) load_kv(i);
    if (PACKED) cp_commit();
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t fh[kKeys / 16][4], fl[kKeys / 16][4];
  // Per live tile i: S and dP of tile i and dQ += dS K of tile i - 1 are
  // issued together; P, dS and dS's fragments follow as the three
  // groups retire.  The ring keeps tile i - 1's K until its product is
  // done.
  for (int i = 0; i < n_tiles; ++i) {
    if (PACKED) cp_wait<kAhead - 1>();   // this thread's ids of tile i
    __syncthreads();                     // ... everyone's; i - 2 is free
    if (i + kAhead < n_tiles) load_kv(i + kAhead);
    if (PACKED) cp_commit();
    if (i < a || i >= e) continue;       // not a tile of this warpgroup
    if (i == a) wg::mbar_wait(q_bar, 0);
    wg::mbar_wait(full + i % kWgStages, (i / kWgStages) & 1);
    const int k0 = (t_lo + i) * kKeys;
    auto step = [&](auto first, auto mask) {
      constexpr bool F = decltype(first)::value, M = decltype(mask)::value;
      issue_s<D>(sc, q_addr, wgi * 64, ktile(i));
      issue_s<D>(dp, do_addr, wgi * 64, ktile(i) + KVB);
      if constexpr (!F) issue_pv<D>(acc, fh, fl, ktile(i - 1));
      wg::wait<F ? 1 : 2>();             // S of tile i is done
      wg::fence_acc<32>(sc);
      p_tile<M>(sc, scale_log2, lse0, lse1, k0, M ? tile_mask() : TileMask{},
                sSeg + (i % kWgStages) * kKeys);
      wg::wait<F ? 0 : 1>();             // dP of tile i is done
      wg::fence_acc<32>(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dp[j] = sc[j] * (dp[j] - ((j & 2) ? dl1 : dl0));
      if constexpr (!F) {
        wg::wait<0>();                   // dQ of tile i - 1 is done
        wg::fence_acc<D / 2>(acc);
      }
      split_p(dp, fh, fl);
    };
    if (i == a) {
      step(std::true_type{}, std::true_type{});
    } else if (i >= first_mask) {
      step(std::false_type{}, std::true_type{});
    } else {
      step(std::false_type{}, std::false_type{});
    }
    if (i == e - 1) {                    // dQ of the last live tile
      issue_pv<D>(acc, fh, fl, ktile(i));
      wg::wait<0>();
      wg::fence_acc<D / 2>(acc);
    }
  }
  if (PACKED) cp_wait<0>();

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < Tq)
      store2(dq + ((long long)(b * Tq + r0) * H + h) * D + d,
             acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r1 < Tq)
      store2(dq + ((long long)(b * Tq + r1) * H + h) * D + d,
             acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {                 // fp32: the mma.sync loop
    const dim3 grid((Tq + kRows - 1) / kRows, H, B);
    return dispatch(D, dtype, [&](auto dc, auto tv) {
      constexpr int Dv = decltype(dc)::value;
      using T = decltype(tv);
      if constexpr (sizeof(T) == 2) {
        return cudaErrorInvalidValue;
      } else {
        constexpr int BN = Tile<Dv>::BN;
        const size_t smem = 2 * plane_bytes<Dv, T>(kRows) +
                            4 * plane_bytes<Dv, T>(BN) +
                            2 * BN * sizeof(int);
        auto kern = flash_bwd_dq_kernel<Dv, T, FULL>;
        cudaError_t err = allow_smem(kern, smem);
        if (err != cudaSuccess) return err;
        kern<<<grid, kThreads, smem, st>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<T*>(dq), static_cast<const int*>(kv_lens),
            static_cast<const int*>(seg), static_cast<const int*>(win_lo),
            static_cast<const int*>(win_hi), Tq, Tk, H, sqb, sqt, skb, skt,
            svb, svt, sdb, sdt, causal, scale);
        return cudaGetLastError();
      }
    });
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid(H, B, (Tq + kCtaRows - 1) / kCtaRows);
  auto go = [&](auto dc) {
    constexpr int Dv = decltype(dc)::value;
    CUtensorMap tmq, tmk, tmv, tmdo;
    if (!operand_map<Dv>(&tmq, q, B, Tq, H, sqb, sqt, kCtaRows) ||
        !operand_map<Dv>(&tmdo, dout, B, Tq, H, sdb, sdt, kCtaRows) ||
        !operand_map<Dv>(&tmk, k, B, Tk, H, skb, skt, kKeys) ||
        !operand_map<Dv>(&tmv, v, B, Tk, H, svb, svt, kKeys))
      return cudaErrorInvalidValue;
    auto kern = seg ? flash_bwd_dq_wg_kernel<Dv, FULL, !FULL>
                    : flash_bwd_dq_wg_kernel<Dv, FULL, false>;
    cudaError_t err = allow_smem(kern, dq_smem<Dv>());
    if (err != cudaSuccess) return err;
    kern<<<grid, kWgThreads, dq_smem<Dv>(), st>>>(
        tmq, tmk, tmv, tmdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq),
        static_cast<const int*>(kv_lens), static_cast<const int*>(seg),
        static_cast<const int*>(win_lo), static_cast<const int*>(win_hi), Tq,
        Tk, H, causal, scale);
    return cudaGetLastError();
  };
  if (D == 32) return go(std::integral_constant<int, 32>{});
  if (D == 64) return go(std::integral_constant<int, 64>{});
  if (D == 128) return go(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
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
