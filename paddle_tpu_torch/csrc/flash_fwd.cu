// Flash attention forward, training form, for sm_90a: kernel 1-train
// (block-sparse windows) and kernel 2 (the legacy full grid).
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas_attention.py:
// `_fa_pair_kernel` (:255, launched by `_fa_forward_sparse` for
// `flash_attention`, padded rows with key lengths, and
// `flash_attention_packed`, segment ids), and `_fa_kernel` (:467, the
// (B*H, q blocks, k blocks) grid of `_fa_forward_grid` behind
// --flash_block_sparse=false, which DMAs every K/V block and skips only
// the compute of a dead one).  Both compute out = softmax(q k^T * scale) v
// with the reference's masks (key past its row's length; above the
// diagonal when causal; packed, another segment or padding) and the
// per-query log-sum-exp lse [B, H, Tq] that the backward kernels rebuild
// p from.  A row with no visible key emits zeros and lse = NEG_INF / 2.
// The TPU carries the online softmax in VMEM across a q block's grid
// steps; here a CTA walks its key tiles in a loop.
//
// Bound on the H100 (the transformer step's shape: B 16, H 8, T 2048,
// D 64, bf16, all keys valid): 4 B H T^2 D = 137.4 GFLOP non-causal,
// 139.0 us at 989 TFLOP/s bf16, and half of that causal (69.5 us); the
// bytes (q, k, v read once, out and lse written once, ~135 MB) take ~40
// us, so operations bound it.
//
// bf16 (every path of the transformer): the wgmma loop, two CTAs an SM.
// A CTA owns 128 query rows of one (batch row, head) in two warpgroups of
// 64.  Each warpgroup has its own live key range: its 64-row q tile's
// window [lo, hi) of 64-key tiles (`ops/attention.py`, from the key
// lengths or the segment ids' ranges) or, for the legacy grid (FULL), the
// whole row; both capped by the key length and the causal diagonal.  The
// CTA loads the union of the two ranges and nothing else -- a dead tile
// is neither loaded nor visited, under FULL too (the dead tiles of the
// TPU's grid are a suffix, so the result is the block-sparse one).  Q and
// the 64-key K/V tiles come by TMA (tensor maps of the [B, T, H, D]
// operands built on the host; one thread issues the copies, an mbarrier
// a ring slot counts their bytes) into a 4-stage ring two tiles ahead,
// in the 128-byte swizzled layout of wgmma.cuh (64 bytes at D 32); one
// __syncthreads a tile frees the slot of tile i - 2.  S = Q K^T is one
// wgmma m64n64k16 chain per warpgroup with both operands in shared memory
// (K-major).  The online softmax runs on the accumulators (quad shuffles
// for row max and sum, log2 units, one FFMA and one ex2.approx an
// element, the reference's max(m, NEG_INF / 2) clamp; maxima and sums in
// four independent chains a row, because few warps share a scheduler).
// P is split into hi + lo bf16 in registers (the contract's P is f32; the
// split makes the P V work 2x) and O += P V is two wgmma m64nDk16 chains
// with P from registers and V read MN-major (transposed).  Per tile, S of
// tile i and P V of tile i - 1 are issued back to back and the softmax of
// tile i follows while P V runs; nothing is written between the two
// groups and nothing stays in flight across the loop, or ptxas serializes
// them.  (ptxas still retires P V a few dozen instructions into the
// softmax of a tile without masked elements -- its SASS shows the wait
// there -- so that overlap is partial.)
// Causal CTAs are launched heaviest first (the last q tiles first).
//
// fp32 (the SPLIT numbers of flash_common.cuh: q, k, v as hi + lo bf16,
// three products each) keeps the mma.sync loop: a CTA of 4 warps owns 64
// query rows and double-buffers BN-key tiles by cp.async; under FULL it
// too visits only the live tiles.
#include "flash_wg.cuh"

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
  // live keys [k_begin, k_end): the window's, or under FULL the row's
  // (its key length and the causal diagonal); only their tiles are visited
  const int k_begin = FULL ? 0 : win_lo[b * nq + qt] * kRows;
  int k_end = FULL ? kv_len : min(win_hi[b * nq + qt] * kRows, kv_len);
  if (causal) k_end = min(k_end, q0 + kRows);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
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

// ------------------------------------------------ bf16: the wgmma loop
// (two warpgroups of 64 query rows; flash_wg.cuh)
template <int D>
constexpr size_t fwd_smem() {
  return 1024 + Wg<D>::QB + kWgStages * 2 * Wg<D>::KVB +
         (1 + kWgStages) * sizeof(uint64_t);
}

// The raw scores s of one 64-key tile (accumulator layout) in place to
// p = 2^(s * scale_log2 - base) under the masks (one FFMA and one ex2 an
// element; a masked score is set to NEG_INF / scale_log2, so that it
// scales to NEG_INF and the clamp below sees the reference's numbers);
// the running row maxima m (log2 units) and sums l (this lane's share)
// updated; al = the factors that rescale O.  MASK applies tm's masks,
// which the caller gathers only for a tile that has masked elements, so
// that they hold no registers across the loop (at the 128-register cap
// every register held there pushed ptxas to spill or to retire P V
// early).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[32],
                                             float scale_log2, int k0,
                                             const TileMask& tm, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  if constexpr (MASK) {
    const int t = threadIdx.x & 3;
    const float masked = kNegInf / scale_log2;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * 8 + 2 * t + (c & 1);
        if (!valid(tm.r0 + (c < 2 ? 0 : 8), k0 + col, tm.kv_len, tm.causal,
                   tm.packed, c < 2 ? tm.sq0 : tm.sq1,
                   tm.packed && k0 + col < tm.tk ? __ldg(tm.segb + k0 + col)
                                                 : 0))
          sc[4 * j + c] = masked;
      }
  }
  // row maxima and sums in four independent chains a row (short
  // dependency chains: few warps share a scheduler here)
  float mx[2][4], rs[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    mx[0][q] = fmaxf(sc[8 * q], sc[8 * q + 1]);
    mx[1][q] = fmaxf(sc[8 * q + 2], sc[8 * q + 3]);
    mx[0][q] = fmaxf(mx[0][q], fmaxf(sc[8 * q + 4], sc[8 * q + 5]));
    mx[1][q] = fmaxf(mx[1][q], fmaxf(sc[8 * q + 6], sc[8 * q + 7]));
  }
  const float mn0 = fmaxf(
      m0, quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3])))
              * scale_log2);
  const float mn1 = fmaxf(
      m1, quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3])))
              * scale_log2);
  // a row with no valid key so far keeps p = 0: exp(NEG_INF - NEG_INF/2)
  const float base0 = fmaxf(mn0, 0.5f * kNegInf);
  const float base1 = fmaxf(mn1, 0.5f * kNegInf);
  al0 = exp2_approx(m0 - base0);
  al1 = exp2_approx(m1 - base1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    sc[4 * j] = exp2_approx(fmaf(sc[4 * j], scale_log2, -base0));
    sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -base0));
    sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -base1));
    sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -base1));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    rs[0][q] = (sc[8 * q] + sc[8 * q + 1]) + (sc[8 * q + 4] + sc[8 * q + 5]);
    rs[1][q] =
        (sc[8 * q + 2] + sc[8 * q + 3]) + (sc[8 * q + 6] + sc[8 * q + 7]);
  }
  l0 = l0 * al0 + ((rs[0][0] + rs[0][1]) + (rs[0][2] + rs[0][3]));
  l1 = l1 * al1 + ((rs[1][0] + rs[1][1]) + (rs[1][2] + rs[1][3]));
}

// O *= al by rows (O not in flight), pinned before the next wgmma issue:
// a register write between two wgmma groups makes ptxas serialize them.
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2], float al0,
                                          float al1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= al0;
    o[4 * j + 1] *= al0;
    o[4 * j + 2] *= al1;
    o[4 * j + 3] *= al1;
  }
  wg::fence_acc<D / 2>(o);
}

// Two CTAs an SM at D <= 64 (128 registers a thread); at D 128 the ring
// takes one SM's shared memory, and O twice the registers.
template <int D, bool FULL>
__global__ void __launch_bounds__(kWgThreads, D <= 64 ? 2 : 1)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ seg,
                        const int* __restrict__ win_lo,
                        const int* __restrict__ win_hi, int Tq, int Tk, int H,
                        int causal, float scale) {
  constexpr int KVB = Wg<D>::KVB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = wg::align1024(smem_raw);
  unsigned char* sKV = sQ + Wg<D>::QB;              // [stage][K, V]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sKV + kWgStages * 2 * KVB);
  uint64_t* full = q_bar + 1;                        // [stage] landed

  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, wq = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the last (heaviest) q tiles first
  const int ct = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int nq = (Tq + kRows - 1) / kRows;     // 64-row q tiles (windows)
  const bool packed = seg != nullptr;
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
  auto tile_mask = [&]() {
    TileMask tm;
    tm.r0 = r0;
    tm.kv_len = kv_len;
    tm.tk = Tk;
    tm.causal = causal != 0;
    tm.packed = packed;
    tm.segb = packed ? seg + (long long)b * Tk : nullptr;
    tm.sq0 = packed && r0 < Tq ? tm.segb[r0] : -1;
    tm.sq1 = packed && r1 < Tq ? tm.segb[r1] : -1;
    return tm;
  };
  const uint32_t q_addr = wg::smem_u32(sQ), kv_addr = wg::smem_u32(sKV);
  auto ktile = [&](int i) { return kv_addr + (i % kWgStages) * 2 * KVB; };
  // tile i's K and V into ring slot i % kWgStages (thread 0)
  auto load_kv = [&](int i) {
    const int s = i % kWgStages, k0 = (t_lo + i) * kKeys;
    unsigned char* kt = sKV + s * 2 * KVB;
    wg::mbar_expect(full + s, 2 * KVB);
    tma_tile<D, kKeys>(kt, &tmk, full + s, h, k0, b);
    tma_tile<D, kKeys>(kt + KVB, &tmv, full + s, h, k0, b);
  };

  if (tid == 0) {
    wg::mbar_init(q_bar, 1);
    for (int s = 0; s < kWgStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    wg::mbar_expect(q_bar, Wg<D>::QB);
    tma_tile<D, kCtaRows>(sQ, &tmq, q_bar, h, ct * kCtaRows, b);
    for (int i = 0; i < min(kAhead, n_tiles); ++i) load_kv(i);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0 = 0.f, al1 = 0.f;
  float sc[32];
  uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];
  // Per live tile i past the first: S of tile i and P V of tile i - 1
  // are issued together, and the softmax of tile i follows while P V runs
  // (partly overlapped: see the file's head).  Every branch retires what
  // it issued (nothing in flight across the loop), so ptxas keeps the
  // groups asynchronous.  Tiles i + 1 and i + 2 load
  // meanwhile; the ring keeps tile i - 1's V until its P V is done.
  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();                     // tile i - 2's slot is free
    if (tid == 0 && i + kAhead < n_tiles) load_kv(i + kAhead);
    if (i < a || i >= e) continue;       // not a tile of this warpgroup
    if (i == a) wg::mbar_wait(q_bar, 0);
    wg::mbar_wait(full + i % kWgStages, (i / kWgStages) & 1);
    const int k0 = (t_lo + i) * kKeys;
    // tile i past the first, with or without masked elements
    auto step = [&](auto mask) {
      rescale_o<D>(o, al0, al1);
      issue_s<D>(sc, q_addr, wgi * 64, ktile(i));
      issue_pv<D>(o, ph, pl, ktile(i - 1) + KVB);
      wg::wait<1>();                     // S of tile i is done
      wg::fence_acc<32>(sc);
      constexpr bool M = decltype(mask)::value;
      softmax_tile<M>(sc, scale_log2, k0, M ? tile_mask() : TileMask{}, m0,
                      m1, l0, l1, al0, al1);
      wg::wait<0>();                     // P V of tile i - 1 is done
      wg::fence_acc<D / 2>(o);
      split_p(sc, ph, pl);
    };
    if (i == a) {
      issue_s<D>(sc, q_addr, wgi * 64, ktile(i));
      wg::wait<0>();
      wg::fence_acc<32>(sc);
      softmax_tile<true>(sc, scale_log2, k0, tile_mask(), m0, m1, l0, l1,
                         al0, al1);
      split_p(sc, ph, pl);
    } else if (i >= first_mask) {
      step(std::true_type{});
    } else {
      step(std::false_type{});
    }
    if (i == e - 1) {                    // P V of the last live tile
      rescale_o<D>(o, al0, al1);
      issue_pv<D>(o, ph, pl, ktile(i) + KVB);
      wg::wait<0>();
      wg::fence_acc<D / 2>(o);
    }
  }

  // flush: out = acc / l (zeros for a row with no visible key)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < Tq)
      store2(out + ((long long)(b * Tq + r0) * H + h) * D + d,
             o[4 * j] / ls0, o[4 * j + 1] / ls0);
    if (r1 < Tq)
      store2(out + ((long long)(b * Tq + r1) * H + h) * D + d,
             o[4 * j + 2] / ls1, o[4 * j + 3] / ls1);
  }
  if (t == 0) {
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
        const size_t smem = plane_bytes<Dv, T>(kRows) +
                            4 * plane_bytes<Dv, T>(BN) +
                            2 * BN * sizeof(int);
        auto kern = flash_fwd_kernel<Dv, T, FULL>;
        cudaError_t err = allow_smem(kern, smem);
        if (err != cudaSuccess) return err;
        kern<<<grid, kThreads, smem, st>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out),
            static_cast<float*>(lse), static_cast<const int*>(kv_lens),
            static_cast<const int*>(seg), static_cast<const int*>(win_lo),
            static_cast<const int*>(win_hi), Tq, Tk, H, sqb, sqt, skb, skt,
            svb, svt, causal, scale);
        return cudaGetLastError();
      }
    });
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid(H, B, (Tq + kCtaRows - 1) / kCtaRows);
  auto go = [&](auto dc) {
    constexpr int Dv = decltype(dc)::value;
    CUtensorMap tmq, tmk, tmv;
    if (!operand_map<Dv>(&tmq, q, B, Tq, H, sqb, sqt, kCtaRows) ||
        !operand_map<Dv>(&tmk, k, B, Tk, H, skb, skt, kKeys) ||
        !operand_map<Dv>(&tmv, v, B, Tk, H, svb, svt, kKeys))
      return cudaErrorInvalidValue;
    auto kern = flash_fwd_wg_kernel<Dv, FULL>;
    cudaError_t err = allow_smem(kern, fwd_smem<Dv>());
    if (err != cudaSuccess) return err;
    kern<<<grid, kWgThreads, fwd_smem<Dv>(), st>>>(
        tmq, tmk, tmv, static_cast<bf16*>(out), static_cast<float*>(lse),
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
