// The tensor-core step loop of the recurrences: kernels 9 (the
// single-block LSTM BPTT, lstm_bwd.cu), 10 (the blocked LSTM forward,
// lstm_fwd_blocked.cu), 11 (the blocked LSTM BPTT, lstm_bwd_blocked.cu),
// 15 (the blocked GRU forward, gru_fwd_blocked.cu) and 14 and 16 (the GRU
// BPTT, gru_wg.cuh) -- the GRU's with two step products over one ring;
// kernel 8 (the single-block LSTM forward, lstm_fwd.cu) takes its planes,
// numbers and launch helpers with a step product of its own.
//
// Each step of a recurrence needs one product across the hidden units,
// C[rows, cols] = A[rows, K] B[cols, K]^T (a TN GEMM, both operands
// K-major): the forward's gates = h_{t-1} w_hh (A = h_{t-1}, K = H, B =
// w_hh's transpose, cols = 4H gate columns), the backward's pull-back
// dh_prev = dgates_t w_hh^T (A = dgates_t, K = 4H, B = w_hh, cols = H
// units).  It runs on wgmma (wgmma.cuh) with both operands read by TMA in
// the 128-byte swizzle.
//
// Numbers.  The contract is f32.  Each f32 operand is carried as hi =
// bf16(x) and lo = bf16(x - hi), and a product as hi*hi + hi*lo + lo*hi
// (three bf16 passes, f32 accumulators); each 64-wide K chunk's sums
// leave the accumulators for IEEE f32 adds into registers, so the tensor
// cores' accumulation error stays that of one chunk (dw_wg.cuh's rule).
//
// Planes.  The kernels write both operands' hi and lo planes themselves
// (bf16, pitch Kp = K rounded up to 64, the bytes of a whole swizzle
// row): B's once, in a prologue (w_hh does not change over T), and A's
// each step, by the per-(row, unit) phase of the step before, in
// compacted row order -- the rows valid at the step first, by rank (a
// table of ranks and counts a step, made in the prologue, step_ranks).
// So the product loads ready planes, a step runs over ceil(n_t / 128)
// row blocks of contiguous rows, and padded rows cost nothing.  TMA reads
// past K and past the planes' rows as zeros, so any H and any B take the
// same path.  The planes are written by the generic proxy and read by
// TMA after a grid barrier: the writers run fence.proxy.async.global
// before it.
//
// Tiles: 128 compacted rows x 128 columns x one K slice of `cps` chunks
// (the wrapper picks the slices so that one step's tiles about fill the
// co-resident CTAs).  Warpgroup w < 2 takes rows 64w .. 64w + 63 of the
// tile (64 x 128 f32 accumulators and their running sum); a ring of three
// stages of four planes (A hi, A lo, B hi, B lo: 128 rows x 64 values
// each, 64 KB a stage) keeps two chunks in flight.  B's boxes of a CTA's
// next tile's first two chunks do not depend on the step: they are asked
// for before the step's barrier (Tiles::ahead), so only A's wait after
// it.  A tile writes its slice's sums into part[slice] (8-byte stores);
// after the grid barrier the (row, unit) phase adds the slices in order
// -- a fixed order, no atomics, the same bits on every run.
//
// The second half of the file is the backward's whole kernel, shared by
// kernels 9 and 11 (lstm_bwd_wg_kernel).
#pragma once

#include <cuda_bf16.h>

#include "dw_wg.cuh"
#include "lstm_common.cuh"
#include "wgmma.cuh"

namespace lstm {

namespace lwg {
constexpr int kRows = 128;                 // compacted rows of a tile
constexpr int kCols = 128;                 // product columns of a tile
constexpr int kChunk = 64;                 // K values a chunk (128 bytes)
constexpr int kPlane = kRows * 128;        // bytes of one plane's chunk
constexpr int kStage = 4 * kPlane;         // A hi, A lo, B hi, B lo
constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;        // chunks in flight
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStage;
static_assert(kCols == kRows, "one box shape serves both operands");
static_assert(kSmemBytes >= dwg::kSmemBytes, "the dW tile reuses the ring");
}  // namespace lwg

// Orders this thread's generic writes to global memory before later
// reads of them by the async proxy (the TMA loads of the planes).
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// x as hi = bf16(x) at p[0] and lo = bf16(x - hi) at p[lo].
__device__ __forceinline__ void put_split(__nv_bfloat16* p, long lo,
                                          float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  p[0] = h;
  p[lo] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// The planes of a row-major f32 [rows, K] source: dst[r * Kp + k] (hi)
// and dst[rows * Kp + r * Kp + k] (lo), element i = r * K + k taken by
// the grid's threads from `first` with `stride`.
__device__ __forceinline__ void split_rows(__nv_bfloat16* dst,
                                           const float* __restrict__ src,
                                           int rows, int K, int Kp,
                                           long first, long stride) {
  for (long i = first; i < (long)rows * K; i += stride)
    put_split(dst + i / K * Kp + i % K, (long)rows * Kp, src[i]);
}

// Ranks of step s's rows among its valid ones (mask != 0), ascending b:
// rank[s * B + b] (-1 when padded) and the count at rank[T * B + s].
template <int kCta>
__device__ __forceinline__ void step_ranks(const float* mask, int B, int T,
                                           int s, int* rank, int* warp_n) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += kCta) {
    const int b = b0 + tid;
    const bool v = b < B && mask[(long)b * T + s] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_n[w] = __popc(bal);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int k = 0; k < kCta / 32; ++k) {
      if (k < w) before += warp_n[k];
      all += warp_n[k];
    }
    if (b < B)
      rank[(long)s * B + b] =
          v ? base + before + __popc(bal & ((1u << lane) - 1u)) : -1;
    base += all;
    __syncthreads();
  }
  if (threadIdx.x == 0) rank[(long)T * B + s] = base;
}

// The step product's tiles, walked by a persistent grid with its stride.
// A tile is (row block, column block, K slice), slices innermost.
struct Tiles {
  const CUtensorMap* ahi;
  const CUtensorMap* alo;
  const CUtensorMap* bhi;
  const CUtensorMap* blo;
  unsigned char* ring;   // kStages stages, 1024-byte aligned
  uint64_t* full;        // the stages' mbarriers (one arrival each)
  int n_slices, cps;     // K slices, chunks a slice
  int nch, n_cb;         // chunks of K, column blocks
  int n_tiles;
  uint32_t it;   // chunks this CTA has taken through the ring
  int pf_tile;   // (thread 0) the tile whose first B boxes are asked

  // a tile's first compacted row, K slice and first column
  __device__ __forceinline__ void decode(int tile, int& r0, int& sl,
                                         int& c0) const {
    sl = tile % n_slices;
    c0 = tile / n_slices % n_cb * lwg::kCols;
    r0 = tile / (n_slices * n_cb) * lwg::kRows;
  }
  // B's planes of the chunk at k0, columns c0.., into ring slot s
  __device__ __forceinline__ void load_b(int s, int k0, int c0) const {
    unsigned char* st = ring + s * lwg::kStage;
    wg::tma_load_2d(st + 2 * lwg::kPlane, bhi, full + s, k0, c0);
    wg::tma_load_2d(st + 3 * lwg::kPlane, blo, full + s, k0, c0);
  }

  // One step over the n valid rows: this CTA's tiles, each writing its
  // slice's sums at part[(sl * ldr + row) * ld + col] (col < cols).
  __device__ __forceinline__ void step(int n, float* part, int ldr, int ld,
                                       int cols) {
    using lwg::kAhead, lwg::kChunk, lwg::kPlane, lwg::kStage, lwg::kStages;
    const int tid = threadIdx.x, wgi = tid >> 7;
    const uint32_t ring_addr = wg::smem_u32(ring);
    const int lane = tid & 31, wq = (tid >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int r0, sl, c0;
      decode(tile, r0, sl, c0);
      if (r0 >= n) continue;
      const int k_first = sl * cps, nc = min(cps, nch - k_first);
      // chunk k_first + i into the ring slot of the CTA's chunk it + i
      auto load = [&](int i, bool with_b) {
        const int s = (it + i) % kStages, k0 = (k_first + i) * kChunk;
        unsigned char* st = ring + s * kStage;
        wg::mbar_expect(full + s, kStage);
        wg::tma_load_2d(st, ahi, full + s, k0, r0);
        wg::tma_load_2d(st + kPlane, alo, full + s, k0, r0);
        if (with_b) load_b(s, k0, c0);
      };
      if (tid == 0) {
        fence_proxy_global();
        for (int i = 0; i < kAhead && i < nc; ++i) load(i, tile != pf_tile);
        pf_tile = -1;
      }
      float acc[64], tot[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
      const bool active = wgi < 2 && r0 + 64 * wgi < n;
      for (int i = 0; i < nc; ++i) {
        // the slot of chunk i - 1 is free: its products retired before
        // the last barrier
        if (tid == 0 && i + kAhead < nc) load(i + kAhead, true);
        const uint32_t j = it + i;
        wg::mbar_wait(full + j % kStages, (j / kStages) & 1);
        if (active) {
          const uint32_t sb = ring_addr + (j % kStages) * kStage;
          const uint64_t ah = wg::desc<128>(sb + wgi * 64 * 128, 16, 1024);
          const uint64_t al = ah + (kPlane >> 4);
          const uint64_t bh = wg::desc<128>(sb + 2 * kPlane, 16, 1024);
          const uint64_t bl = bh + (kPlane >> 4);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {  // 32 bytes a k step
            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, bh + 2 * kk, kk > 0);
            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, bl + 2 * kk, 1);
            wg::mma_ss_n128<0, 0>(acc, al + 2 * kk, bh + 2 * kk, 1);
          }
          wg::commit();
          wg::wait<0>();
          wg::fence_acc<64>(acc);
#pragma unroll
          for (int e = 0; e < 64; ++e) tot[e] += acc[e];
        }
        __syncthreads();
      }
      it += nc;
      // accumulator rows g and g + 8 of warp wq's 16, columns 8j + 2tq, + 1
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int row = r0 + 64 * wgi + 16 * wq + g + 8 * h8;
        if (row >= n || wgi >= 2) continue;
        float* dst = part + ((long)sl * ldr + row) * ld;
#pragma unroll
        for (int jb = 0; jb < 16; ++jb) {
          const int u = c0 + 8 * jb + 2 * tq;
          const float v0 = tot[4 * jb + 2 * h8], v1 = tot[4 * jb + 2 * h8 + 1];
          if (ld % 2 == 0 && u + 1 < cols) {   // 8-byte aligned pairs
            *reinterpret_cast<float2*>(dst + u) = make_float2(v0, v1);
          } else {
            if (u < cols) dst[u] = v0;
            if (u + 1 < cols) dst[u + 1] = v1;
          }
        }
      }
    }
  }

  // (thread 0, before the step's barrier) B's planes of the first chunks
  // of this CTA's first tile at the next step (n1 valid rows) into their
  // slots now: they do not depend on the step, and their bytes count on
  // the slots' barriers before the arrivals expect them
  __device__ __forceinline__ void ahead(int n1) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int r0, sl, c0;
      decode(tile, r0, sl, c0);
      if (r0 >= n1) continue;
      // exactly the chunks the tile's first loads take (load(i, false))
      for (int i = 0; i < lwg::kAhead && i < min(cps, nch - sl * cps); ++i)
        load_b((it + i) % lwg::kStages, (sl * cps + i) * lwg::kChunk, c0);
      pf_tile = tile;
      break;
    }
  }
};

// Chunks a slice when the nch chunks of K are cut into n_slices slices
// of ceil(nch / n_slices), none empty; -1 when they cannot be.
__host__ inline int slice_chunks(int nch, int n_slices) {
  if (n_slices < 1 || n_slices > nch) return -1;
  const int cps = (nch + n_slices - 1) / n_slices;
  return (n_slices - 1) * cps >= nch ? -1 : cps;
}

// A [rows, K] bf16 plane of pitch Kp as a 2-d tensor map: boxes of 128
// rows x 64 values (128 bytes, the swizzle's row); TMA reads past K and
// past `rows` as zeros.
__host__ inline bool plane_map(CUtensorMap* m, const void* base, int rows,
                               int K, int Kp) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)Kp * 2};
  const uint32_t box[2] = {lwg::kChunk, lwg::kRows};
  return wg::tma_map(m, base, 2, dims, strides, box, 128);
}

// Launch a step-loop kernel cooperatively, one CTA of `threads` an SM
// (the ring takes most of its shared memory), every one co-resident: the
// per-(row, unit) phase runs on all of them.  0, a cudaError_t, or -1
// when not even one CTA fits or the card has no cooperative launch.
template <typename K>
__host__ inline int launch_resident(K kernel, int threads, void** args,
                                    cudaStream_t stream) {
  const long resident =
      resident_ctas(kernel, lwg::kSmemBytes / sizeof(float), threads);
  if (resident < 0) return (int)-resident;
  if (resident == 0) return -1;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3((unsigned)resident), dim3(threads), args,
      lwg::kSmemBytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------- the backward (kernels 9, 11)
// The reversed time loop with the dh/dc carries (pallas_lstm.py's
// _bwd_kernel and _bwd_kernel_blocked): per step t, the pull-back of
// dgates_t's planes (Tiles), a barrier, then per (row, unit) pair the
// slices' sums join the carry and phase A of step t - 1 runs, writing
// dgates_{t-1} into dxw and, at the row's rank, into the planes.  Kernel
// 9 (kDw) also sums the peephole products and dW_hh (see below).
//
//   prologue: w_hh's planes; the step ranks; barrier
//             phase A of step T-1 for every pair (zero carries); barrier
//   for t = T-1 .. 0:
//     per tile: part[slice] = pull-back of dgates_t's planes
//     barrier
//     per pair: dh = (1-m) dh_tot (step t) + part[0..S) (valid rows);
//               t > 0: phase A of step t-1 with carries (dh, dc) --
//               dgates_{t-1} into dxw and its planes, the new dc and
//               (1-m) dh_tot into scratch; t = 0: dh0, dc0
//     barrier (t > 0)
struct BwdArgs {
  const float* gates;
  const float* cseq;
  const float* c0;
  const float* mask;
  const float* checks;
  const float* dy;
  const float* dyc;
  float* dxw;
  float* dhp;   // [B, H] (1-m) * dh_tot of the last phase A
  float* dcc;   // [B, H] dc carry
  float* part;  // [S, B, H] the pull-back by K slice, compacted rows
  int* rank;    // [T, B] row b's rank among step t's valid rows (-1
                // padded), then [T] the counts
  __nv_bfloat16* apl;  // [2, B, Kp] dgates planes (hi, lo), compacted
  int B, T, H, Kp;
};

// Kernel 9's weight gradients.  ckp [3, B, H]: each pair's peephole
// products summed over the steps (its own thread, in step order); rows
// [B * T]: the valid (b, t) rows as b * T + t, by descending t, then
// rank; dw_part [n_split, H, 4H] when n_split > 1.
struct DwArgs {
  const float* hseq;
  const float* h0;
  float* dw;
  float* dck;
  float* ckp;
  int* rows;
  float* dw_part;
  int n_split;
};

// Step s for (b, unit) with incoming carries dh_c, dc_c; r is row b's
// rank among step s's valid rows (-1: padded, no planes written).  kDw:
// the pair's peephole products join ckp (`first`: step T-1, they start
// it) and unit 0 lists a valid row at rows[base + r].
template <bool kDw>
__device__ __forceinline__ void phase_a(const BwdArgs& a, const DwArgs& d,
                                        int s, int b, int unit, float dh_c,
                                        float dc_c, int r, bool first,
                                        int base) {
  const int H = a.H;
  const long TH = (long)a.T * H;
  const long o_s = b * TH + (long)s * H + unit;
  const long o_g = 4 * b * TH + (long)s * 4 * H + unit;
  const float gi = __ldcs(a.gates + o_g), gf = __ldcs(a.gates + o_g + H);
  const float gg = __ldcs(a.gates + o_g + 2 * H);
  const float go = __ldcs(a.gates + o_g + 3 * H);
  const float c_prev = s > 0 ? a.cseq[o_s - H] : a.c0[(long)b * H + unit];
  const float c = a.cseq[o_s];
  const float m = a.mask[(long)b * a.T + s];
  const float tanh_c = tanhf(c);
  const float dh_tot = __ldcs(a.dy + o_s) + dh_c;
  const float dc_tot = __ldcs(a.dyc + o_s) + dc_c;
  const float dh = m * dh_tot;
  const float do_pre = dh * tanh_c * go * (1.f - go);
  const float dc = m * dc_tot + dh * go * (1.f - tanh_c * tanh_c) +
                   do_pre * a.checks[2 * H + unit];
  const float di_pre = dc * gg * gi * (1.f - gi);
  const float df_pre = dc * c_prev * gf * (1.f - gf);
  const float dg_pre = dc * gi * (1.f - gg * gg);
  __stcs(a.dxw + o_g, di_pre);
  __stcs(a.dxw + o_g + H, df_pre);
  __stcs(a.dxw + o_g + 2 * H, dg_pre);
  __stcs(a.dxw + o_g + 3 * H, do_pre);
  if (r >= 0) {
    __nv_bfloat16* p = a.apl + (long)r * a.Kp + unit;
    const long lo = (long)a.B * a.Kp;
    put_split(p, lo, di_pre);
    put_split(p + H, lo, df_pre);
    put_split(p + 2 * H, lo, dg_pre);
    put_split(p + 3 * H, lo, do_pre);
  }
  const long o_c = (long)b * H + unit;
  a.dcc[o_c] = (1.f - m) * dc_tot + dc * gf + di_pre * a.checks[unit] +
               df_pre * a.checks[H + unit];
  a.dhp[o_c] = (1.f - m) * dh_tot;
  if constexpr (kDw) {
    const long BH = (long)a.B * H;
    float* q = d.ckp + o_c;
    const float v0 = di_pre * c_prev, v1 = df_pre * c_prev, v2 = do_pre * c;
    q[0] = first ? v0 : q[0] + v0;
    q[BH] = first ? v1 : q[BH] + v1;
    q[2 * BH] = first ? v2 : q[2 * BH] + v2;
    if (unit == 0 && r >= 0) d.rows[base + r] = b * a.T + s;
  }
}

// The backward's kernel: kCta threads (two warpgroups on the tiles, any
// more only on the pairs), one CTA an SM.  kDw (kernel 9): after the
// loop, dchecks[k][u] = sum over b of ckp[k][b][u] (ascending b), and
// dW_hh = sum over the listed rows of h_{t-1}^T dgates_t on dw_wg.cuh's
// tile (kVec: H % 4 == 0), its tiles x n_split splits of the row list
// spread over the grid, the splits added in split order after a barrier.
template <int kCta, bool kDw, bool kVec>
__global__ void __launch_bounds__(kCta, 1) lstm_bwd_wg_kernel(
    BwdArgs a, const __grid_constant__ CUtensorMap tm_ahi,
    const __grid_constant__ CUtensorMap tm_alo,
    const __grid_constant__ CUtensorMap tm_whi,
    const __grid_constant__ CUtensorMap tm_wlo,
    const float* __restrict__ w_hh, __nv_bfloat16* wpl, float* dh0,
    float* dc0, int n_slices, int cps, DwArgs d) {
  static_assert(!kDw || kCta == kThreads, "dw_tile_wg's CTA");
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  __shared__ uint64_t full[lwg::kStages];
  __shared__ int warp_n[kCta / 32];
  const int tid = threadIdx.x;
  const int B = a.B, T = a.T, H = a.H, K = 4 * H;
  const long BH = (long)B * H;
  const long first = (long)blockIdx.x * kCta + tid;
  const long stride = (long)gridDim.x * kCta;

  // prologue: w_hh's planes, the step ranks, the ring's barriers
  if (tid == 0) {
    for (int s = 0; s < lwg::kStages; ++s) wg::mbar_init(full + s, 1);
    wg::mbar_fence_init();
  }
  split_rows(wpl, w_hh, H, K, a.Kp, first, stride);
  for (int s = blockIdx.x; s < T; s += gridDim.x)
    step_ranks<kCta>(a.mask, B, T, s, a.rank, warp_n);
  fence_proxy_global();
  grid.sync();
  for (long p = first; p < BH; p += stride) {
    const int b = (int)(p / H);
    phase_a<kDw>(a, d, T - 1, b, (int)(p % H), 0.f, 0.f,
                 __ldcg(a.rank + (long)(T - 1) * B + b), true, 0);
  }
  fence_proxy_global();
  grid.sync();

  const int n_ub = (H + lwg::kCols - 1) / lwg::kCols;
  Tiles tl{&tm_ahi, &tm_alo, &tm_whi, &tm_wlo, ring, full, n_slices, cps,
           a.Kp / lwg::kChunk, n_ub,
           (B + lwg::kRows - 1) / lwg::kRows * n_ub * n_slices, 0u, -1};
  int n = 0, base = 0;  // valid rows at t; kDw: rows listed before step t-1's
  for (int t = T - 1; t >= 0; --t) {
    n = __ldcg(a.rank + (long)T * B + t);
    tl.step(n, a.part, B, H, H);
    if (tid == 0 && t > 0) tl.ahead(__ldcg(a.rank + (long)T * B + t - 1));
    grid.sync();  // step
    if (kDw && t > 0) base += n;
    for (long p = first; p < BH; p += stride) {
      const int b = (int)(p / H), unit = (int)(p % H);
      float dh = __ldcg(a.dhp + p);
      const int r = __ldcg(a.rank + (long)t * B + b);
      if (r >= 0)
        for (int sl = 0; sl < n_slices; ++sl)
          dh += __ldcg(a.part + ((long)sl * B + r) * H + unit);
      const float dc = __ldcg(a.dcc + p);
      if (t > 0) {
        phase_a<kDw>(a, d, t - 1, b, unit, dh, dc,
                     __ldcg(a.rank + (long)(t - 1) * B + b), false, base);
      } else {
        dh0[p] = dh;
        dc0[p] = dc;
      }
    }
    fence_proxy_global();
    if (t > 0) grid.sync();  // step
  }

  if constexpr (kDw) {
    // every phase A (the last one, of step 0, before the barrier of
    // t = 1, or the prologue's at T = 1) has run: ckp, rows and dxw are
    // complete
    for (long i = first; i < 3L * H; i += stride) {
      const float* q = d.ckp + i / H * BH + i % H;
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += __ldcg(q + (long)b * H);
      d.dck[i] = s;
    }
    const int n_rows = base + n;
    const int nkt = (H + dwg::kTile - 1) / dwg::kTile;
    const int n_dw = nkt * ((K + dwg::kTile - 1) / dwg::kTile);
    // the list was written in this launch: read it through L2 (__ldcg),
    // never the read-only path
    auto hrow = [&](int j) -> const float* {   // h_{t-1} of listed row j
      const int row = __ldcg(d.rows + j);
      return row % T ? d.hseq + (long)(row - 1) * H
                     : d.h0 + (long)(row / T) * H;
    };
    auto grow = [&](int j) -> const float* {   // dgates_t of listed row j
      return a.dxw + (long)__ldcg(d.rows + j) * K;
    };
    float* out = d.n_split > 1 ? d.dw_part : d.dw;
    for (int task = blockIdx.x; task < n_dw * d.n_split; task += gridDim.x) {
      const int tile = task % n_dw, split = task / n_dw;
      dw_tile_wg<kVec>(hrow, grow, n_rows, split, d.n_split, H, K,
                       (tile % nkt) * dwg::kTile, (tile / nkt) * dwg::kTile,
                       out + (long)split * H * K, K, ring, d.h0);
    }
    if (d.n_split > 1) {
      grid.sync();
      for (long i = first; i < (long)H * K; i += stride) {
        float s = __ldcg(d.dw_part + i);
        for (int k = 1; k < d.n_split; ++k)
          s += __ldcg(d.dw_part + k * (long)H * K + i);
        d.dw[i] = s;
      }
    }
  }
}

// Launch the backward over a's scratch (a.Kp = 4H rounded up to 64, a.apl
// the dgates planes [2, B, Kp]) and w_hh's planes wpl ([2, H, Kp]);
// n_slices cuts the chunks of K = 4H as slice_chunks does.  0, a
// cudaError_t, or -1 (launch_resident).
template <int kCta, bool kDw>
__host__ inline int launch_bwd(BwdArgs a, const float* w_hh,
                               __nv_bfloat16* wpl, float* dh0, float* dc0,
                               int n_slices, DwArgs d, cudaStream_t stream) {
  const int B = a.B, H = a.H, Kp = a.Kp;
  int cps = slice_chunks(Kp / lwg::kChunk, n_slices);
  CUtensorMap tm[4];
  if (cps < 0 || !plane_map(tm, a.apl, B, 4 * H, Kp) ||
      !plane_map(tm + 1, a.apl + (long)B * Kp, B, 4 * H, Kp) ||
      !plane_map(tm + 2, wpl, H, 4 * H, Kp) ||
      !plane_map(tm + 3, wpl + (long)H * Kp, H, 4 * H, Kp))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a,  tm,   tm + 1, tm + 2,    tm + 3, &w_hh,
                  &wpl, &dh0, &dc0,  &n_slices, &cps,   &d};
  if constexpr (kDw) {
    if (H % 4 != 0)
      return launch_resident(lstm_bwd_wg_kernel<kCta, true, false>, kCta,
                             args, stream);
  }
  return launch_resident(lstm_bwd_wg_kernel<kCta, kDw, kDw>, kCta, args,
                         stream);
}

}  // namespace lstm
