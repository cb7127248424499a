// The wgmma pieces shared by the bf16 flash loops for sm_90a: the forward
// (flash_fwd.cu, kernels 1-train and 2) and the backward (flash_bwd_dq.cu,
// kernels 3 and 5; flash_bwd_dkv.cu, kernels 4 and 6).
//
// A CTA is two warpgroups (256 threads).  Its outer tile is 128 rows of
// one (batch row, head) of one operand, 64 a warpgroup; it walks inner
// tiles of 64 rows of the other sequence through a ring in shared memory.
// Tiles of a [B, T, H, D] bf16 operand come by TMA (tensor maps built on
// the host, one box per column block; rows past T read as zeros) in the
// swizzled layout of wgmma.cuh: rows of 128 bytes (64 at D 32).  One tile
// serves both majors: read K-major (D, the reduction, contiguous) by a
// product S = A B^T, and MN-major (transposed) as the B operand of a
// product acc += F B whose reduction runs over the tile's rows.  Every
// product is a 64-row wgmma chain a warpgroup: S-like ones with both
// operands in shared memory, the others with F (an f32 accumulator tile,
// P or dS) from registers, split into hi + lo bf16 (the contract's F is
// f32).
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace fa {

constexpr int kWgThreads = 256;     // two warpgroups of 64 outer rows
constexpr int kCtaRows = 128;       // outer rows a CTA
constexpr int kKeys = 64;           // rows of an inner (ring) tile
constexpr int kWgStages = 4;        // ring: tiles i - 1 .. i + 2
constexpr int kAhead = 2;           // tiles loaded ahead of the walk

template <int D>
struct Wg {
  static constexpr int SW = D >= 64 ? 128 : 64;    // swizzled row bytes
  static constexpr int CB = SW / 2;                // bf16 a block row
  static constexpr int QB = kCtaRows * D * 2;      // outer tile bytes
  static constexpr int KVB = kKeys * D * 2;        // inner tile bytes
};

// Rows [row0, row0 + R) of head h of batch row b of a [B, T, H, D]
// operand into an R-row tile by TMA, one box a column block (rows past T
// read as zeros), counted on `bar`.
template <int D, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int h, int row0,
                                         int b) {
#pragma unroll
  for (int cb = 0; cb < D / Wg<D>::CB; ++cb)
    wg::tma_load_4d(dst + cb * R * Wg<D>::SW, map, bar, cb * Wg<D>::CB, h,
                    row0, b);
}

// Descriptor of rows [r0, r0 + 64) of a K-major R-row tile; k step kk
// adds kmajor_step<D, R>(kk) (the start address is the descriptor's low
// field, in 16-byte units, and shared addresses do not carry out of it).
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int r0) {
  constexpr int SW = Wg<D>::SW;
  return wg::desc<SW>(base + r0 * SW, 16, 8 * SW);
}
template <int D, int R>
__host__ __device__ constexpr uint64_t kmajor_step(int kk) {
  return ((kk * 16 / Wg<D>::CB) * R * Wg<D>::SW +
          (kk * 16 % Wg<D>::CB) * 2) >> 4;
}

// Descriptor of a 64-row inner tile read MN-major (V in O = P V, K in
// dQ = dS K, dO and Q in dV = P^T dO and dK = dS^T Q); rows [16 kk, 16 kk
// + 16) add vmajor_step<D>(kk).
template <int D>
__device__ __forceinline__ uint64_t vmajor(uint32_t base) {
  constexpr int SW = Wg<D>::SW;
  return wg::desc<SW>(base, kKeys * SW, 8 * SW);
}
template <int D>
__host__ __device__ constexpr uint64_t vmajor_step(int kk) {
  return (kk * 16 * Wg<D>::SW) >> 4;
}

// S = A B^T for a warpgroup's 64 rows (from row r0 of the outer tile at
// shared address a_addr) and the inner tile at bt, into sc, as one wgmma
// group (both operands K-major in shared memory): S = Q K^T and dP = dO
// V^T (forward and dq), S^T = K Q^T and dP^T = V dO^T (dk, dv).
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[32], uint32_t a_addr,
                                        int r0, uint32_t bt) {
  const uint64_t ad = kmajor<D>(a_addr, r0), bd = kmajor<D>(bt, 0);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_ss_n64<0>(sc, ad + kmajor_step<D, kCtaRows>(kk),
                      bd + kmajor_step<D, kKeys>(kk), kk > 0);
  wg::commit();
}

// F (a 64 x 64 accumulator tile, f32) as hi and lo bf16 A fragments:
// columns 16kk.. of the tile are accumulator blocks 2kk and 2kk + 1.
__device__ __forceinline__ void split_p(const float (&p)[32],
                                       uint32_t (&ph)[kKeys / 16][4],
                                       uint32_t (&pl)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const float* x = p + 8 * kk;
    split2(x[0], x[1], &ph[kk][0], &pl[kk][0]);
    split2(x[2], x[3], &ph[kk][1], &pl[kk][1]);
    split2(x[4], x[5], &ph[kk][2], &pl[kk][2]);
    split2(x[6], x[7], &ph[kk][3], &pl[kk][3]);
  }
}

// acc += F B as one wgmma group (hi and lo products), B the inner tile at
// shared address bt read MN-major: O += P V, dQ += dS K, dV += P^T dO,
// dK += dS^T Q.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&ph)[kKeys / 16][4],
                                         const uint32_t (&pl)[kKeys / 16][4],
                                         uint32_t bt) {
  const uint64_t bd = vmajor<D>(bt);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wg::mma_rs<D, 1>(acc, ph[kk], bd + vmajor_step<D>(kk), 1);
    wg::mma_rs<D, 1>(acc, pl[kk], bd + vmajor_step<D>(kk), 1);
  }
  wg::commit();
}

// The element masks of a thread's two outer rows (r0 and r0 + 8),
// gathered when a tile needs them rather than held in registers across
// the loop.
struct TileMask {
  int r0, kv_len, sq0, sq1, tk;
  bool causal, packed;
  const int* segb;      // the row's segment ids (packed), read in place
};

// A [B, T, H, D] bf16 operand with batch and token strides bs, ts
// (elements; 0 for a dimension of extent 1, which a map does not take)
// as a 4-d tensor map with boxes of `rows` rows of one column block.
template <int D>
inline bool operand_map(CUtensorMap* m, const void* base, int B, int T,
                        int H, long long bs, long long ts, int rows) {
  const long long st1 = ts ? ts : (long long)H * D;
  const long long sb1 = bs ? bs : (long long)T * st1;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)st1 * 2,
                               (uint64_t)sb1 * 2};
  const uint32_t box[4] = {(uint32_t)Wg<D>::CB, 1, (uint32_t)rows, 1};
  return wg::tma_map(m, base, 4, dims, strides, box, Wg<D>::SW);
}

}  // namespace fa
