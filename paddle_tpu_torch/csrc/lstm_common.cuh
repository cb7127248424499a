// Shared pieces of the fused LSTM and GRU kernels: the single-block tier
// (lstm_fwd.cu, gru_fwd.cu, gru_bwd.cu) and the hidden-blocked tier
// (gru_{fwd,bwd,dw}_blocked.cu; see the end of this file), and what the
// tensor-core LSTM kernels (lstm_wg.cuh, dw_wg.cuh) build on.
//
// The single-block kernels are persistent cooperative launches: one CTA
// per slice of U hidden units (U in {1, 2, 4}, a template constant), the
// whole grid resident, one grid barrier per time step.  Layouts are
// batch-major, as the port's public function takes them: xw / gates /
// dxw [B, T, 4H] (gate order i, f, c, o), state sequences [B, T, H],
// mask [B, T] (1.0 valid, 0.0 padding), w_hh [H, 4H], checks [3, H]
// (peepholes i, f on c_prev; o on the new c).
//
// A CTA's local gate columns are numbered j = g * U + u (gate g of its
// unit u); unit0 + u is the hidden unit, g * H + unit0 + u the column of
// the [.., 4H] arrays.  Units past H (the last CTA when H % U != 0) are
// zero-filled and never written.
//
// The products here run on CUDA cores in fp32 (TF32 would change the
// numbers): the GRU kernels 13-15.  Shared memory serves one 32-bit word
// per bank per cycle, so a product is register-blocked: each thread keeps
// a 4 x 4 block of sums and reads its operands as float4, 2 shared loads
// per 16 FMAs.  The other recurrent kernels' products -- the step
// products of kernels 8-11 and 16 (lstm_fwd.cu, lstm_wg.cuh) and the dW
// products of kernels 9, 12 and 17 (dw_wg.cuh) -- run on the tensor cores
// instead, their f32 operands as hi + lo bf16 in three passes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lstm {

constexpr int kThreads = 256;
constexpr int kKT = 64;          // k-tile of the forward's row product
constexpr int kTileRows = 128;   // batch rows per staged tile
constexpr int kTileStride = kKT + 4;  // padded row: float4-aligned
constexpr int kTileFloats = kTileRows * kTileStride;
constexpr int kStages = 3;       // tiles in flight: 2 loading, 1 in use
constexpr int kRedFloats = 8 * kTileRows * 4;    // k-group partial sums

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// 16-byte asynchronous copy global -> shared through L2 only (.cg: never
// a stale L1 line of data another CTA wrote before the last grid
// barrier); zero-fills when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for all but the newest N groups of this thread's copies; a
// compiler barrier too, so that no shared-memory read moves above it.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage an [nr, nc] block into shared memory: dst[r * ds + c] =
// row(r)[k0 + c], 0 where row(r) is null or k0 + c >= K.  With `vec`
// (every row start and K a multiple of 4 floats) the copies are 16-byte
// cp.async, completed by cp_wait; otherwise synchronous L2 loads.
template <class RowPtr>
__device__ __forceinline__ void stage(float* dst, int ds, RowPtr row, int nr,
                                      int nc, int k0, int K, bool vec,
                                      const float* any) {
  if (vec) {
    const int c4n = nc / 4;
    for (int idx = threadIdx.x; idx < nr * c4n; idx += kThreads) {
      const int r = idx / c4n, c = 4 * (idx % c4n);
      const float* src = row(r);
      const bool ok = src != nullptr && k0 + c < K;
      cp_async16(dst + r * ds + c, ok ? src + k0 + c : any, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < nr * nc; idx += kThreads) {
      const int r = idx / nc, c = idx % nc;
      const float* src = row(r);
      dst[r * ds + c] =
          (src != nullptr && k0 + c < K) ? __ldcg(src + k0 + c) : 0.f;
    }
  }
}

// Row product of one chunk of kTileRows rows, N = 4U columns:
//   C[r][j] = sum_k A[r0 + r][k] * bs[k * N + j]
// A rows are at a + row * lda (global, `rows` rows, K columns); bs is
// [round_up(K, kKT), N] in shared memory, zero past K; tiles is
// kStages staging buffers.  Tiles stream through a kStages-deep cp.async
// pipeline.  Threads form KG k-groups; thread (rb, cb, g) sums rows
// rb + 32 i (i < 4) x columns 4 cb .. 4 cb + 3 over its group's k-slice
// of every tile, 2 float4 shared loads per 16 FMAs.  The partial sums
// land in red[g][r][j]; the caller adds the KG groups in a fixed order
// (red_sum), so the result has the same bits on every run.
template <int N>
__device__ __forceinline__ void row_product(const float* a, long lda,
                                            int rows, int K, const float* bs,
                                            int r0, float* tiles, float* red,
                                            bool vec) {
  static_assert(N % 4 == 0, "row_product needs N = 4U");
  constexpr int CB = N / 4;
  constexpr int KG = kThreads / (32 * CB);
  constexpr int KS = kKT / KG;
  const int tid = threadIdx.x;
  const int rb = tid % 32, cb = (tid / 32) % CB, g = tid / (32 * CB);
  auto row = [&](int r) -> const float* {
    return r0 + r < rows ? a + (long)(r0 + r) * lda : nullptr;
  };
  const int nt = (K + kKT - 1) / kKT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  __syncthreads();  // the buffers are free
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt)
      stage(tiles + s * kTileFloats, kTileStride, row, kTileRows, kKT,
            s * kKT, K, vec, a);
    cp_commit();
  }
  for (int kt = 0; kt < nt; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nt)
      stage(tiles + ((kt + kStages - 1) % kStages) * kTileFloats,
            kTileStride, row, kTileRows, kKT, (kt + kStages - 1) * kKT, K,
            vec, a);
    cp_commit();
    const float* tile = tiles + (kt % kStages) * kTileFloats;
    const float* bk = bs + kt * kKT * N;
#pragma unroll 2
    for (int kk = g * KS; kk < (g + 1) * KS; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            tile + (rb + 32 * i) * kTileStride + kk);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 w =
            *reinterpret_cast<const float4*>(bk + (kk + d) * N + 4 * cb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = d == 0 ? av[i].x : d == 1 ? av[i].y
                        : d == 2 ? av[i].z : av[i].w;
          acc[i][0] += x * w.x;
          acc[i][1] += x * w.y;
          acc[i][2] += x * w.z;
          acc[i][3] += x * w.w;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(g * kTileRows + rb + 32 * i) * N + 4 * cb + c] = acc[i][c];
}

template <int N>
__device__ __forceinline__ float red_sum(const float* red, int idx) {
  constexpr int KG = kThreads / (32 * (N / 4));
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < KG; ++g) s += red[g * kTileRows * N + idx];
  return s;
}

// Launch `kernel` cooperatively on ceil(H / U) CTAs after checking that
// the whole grid can be resident.  Returns 0 or a cudaError_t; -1 when
// the grid cannot be co-resident (the wrapper raises; it never shrinks
// the grid or falls back).
template <typename K>
__host__ inline int cooperative_launch(K kernel, int H, int U, long smem_floats,
                                       void** args, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (H + U - 1) / U;
  if (!coop || (long)per_sm * sms < grid) return -1;
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------- weight gradient of a time loop
// The single-block GRU backward (gru_bwd.cu) sums its weight gradients
// over all (b, t) rows after the time loop, one kGK x kGC output tile per
// CTA at a time (dw_tile).
namespace dwt {
constexpr int kGR = 32;                  // rows per dW product chunk
constexpr int kGK = 128, kGC = 64;       // dW output tile: kGK x kGC
constexpr int kGAS = kGK + 4, kGBS = kGC + 4;      // padded chunk rows
constexpr int kGStage = kGR * (kGAS + kGBS);  // one A chunk + one B chunk
constexpr int kStageFloats = kStages * kGStage;   // the staging buffers
}  // namespace dwt

// One tile of dW[k, c] = sum over rows r < R of arow(r)[k] * brow(r)[c]
// (k < K, c < C): dW rows k0 .. k0 + kGK, columns col0 .. col0 + kGC,
// written at dw[k * ldw + c].  Rows stream in chunks of kGR through a
// kStages-deep cp.async pipeline in gst (dwt::kStageFloats floats);
// thread (kb, cb) sums dW rows 4 kb .. 4 kb + 3 and 64 + 4 kb .. 64 + 4 kb
// + 3 by columns 4 cb .. 4 cb + 3 over all R rows in order, so the result
// has the same bits on every run.
template <class ARow, class BRow>
__device__ __forceinline__ void dw_tile(ARow arow, BRow brow, int R, int K,
                                        int C, int k0, int col0, float* dw,
                                        long ldw, float* gst, bool vec,
                                        const float* any) {
  using dwt::kGR, dwt::kGK, dwt::kGC, dwt::kGAS, dwt::kGBS, dwt::kGStage;
  const int tid = threadIdx.x, kb = tid % 16, cb = tid / 16;
  const int nch = (R + kGR - 1) / kGR;
  auto fetch_chunk = [&](int ch) {
    float* st = gst + (ch % kStages) * kGStage;
    const int r0 = ch * kGR;
    auto a = [&](int r) -> const float* {
      return r0 + r < R ? arow(r0 + r) : nullptr;
    };
    auto b = [&](int r) -> const float* {
      return r0 + r < R ? brow(r0 + r) : nullptr;
    };
    stage(st, kGAS, a, kGR, kGK, k0, K, vec, any);
    stage(st + kGR * kGAS, kGBS, b, kGR, kGC, col0, C, vec, any);
  };
  float acc[8][4] = {};
  __syncthreads();  // the staging buffers are free
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) fetch_chunk(s);
    cp_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (ch + kStages - 1 < nch) fetch_chunk(ch + kStages - 1);
    cp_commit();
    const float* ga = gst + (ch % kStages) * kGStage;
    const float* gb = ga + kGR * kGAS;
#pragma unroll 2
    for (int r = 0; r < kGR; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(ga + r * kGAS + 4 * kb);
      const float4 a1 =
          *reinterpret_cast<const float4*>(ga + r * kGAS + 64 + 4 * kb);
      const float4 v = *reinterpret_cast<const float4*>(gb + r * kGBS + 4 * cb);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] += av[i] * v.x;
        acc[i][1] += av[i] * v.y;
        acc[i][2] += av[i] * v.z;
        acc[i][3] += av[i] * v.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * kb + i : 64 + 4 * kb + i - 4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + 4 * cb + c;
      if (k < K && col < C) dw[(long)k * ldw + col] = acc[i][c];
    }
  }
}

// ------------------------------------------------ hidden-blocked tier
// The blocked kernels own no hidden units: they walk a list of output
// tiles (kBRows batch rows x COLS columns) with a stride of the grid, so
// any B and H run on any grid size, and a tile's result does not depend
// on the grid.  Nothing stays resident: both operands of every product
// stream from L2.  The CUDA-core tiles below serve the GRU's forward
// (kernel 15): a CTA has kBThreads threads in KG k-groups; the launcher
// picks, among the tile widths below, the one that spreads a step's work
// most evenly over the co-resident CTAs (tile_cost).  The LSTM's (10, 11)
// and the GRU's backward (16) run on lstm_wg.cuh's tensor-core tiles.
constexpr int kBThreads = 512;   // threads of a blocked-tier CTA
constexpr int kBRows = 128;      // batch rows of a blocked-tier tile
constexpr int kBStages = 3;      // k tiles in flight: 2 loading, 1 in use

// Shape of one tile product: kBRows x COLS outputs; thread (cb, rg, g)
// sums rows rg + RG i (i < DR) x columns cb + CB d (d < DC) over
// k-group g's KS-wide slice of every kKT-wide k tile.
template <int COLS_, int DR_, int DC_>
struct NtTile {
  static constexpr int ROWS = kBRows, COLS = COLS_, DR = DR_, DC = DC_;
  static constexpr int RG = ROWS / DR, CB = COLS / DC;
  static constexpr int KG = kBThreads / (RG * CB), KS = kKT / KG;
  static constexpr int SF = (ROWS + COLS) * kTileStride;  // one stage
  static constexpr long smem_floats = (long)kBStages * SF;
  static_assert(ROWS % DR == 0 && COLS % DC == 0 &&
                    KG * RG * CB == kBThreads && KS % 4 == 0,
                "tile shape");
  static_assert((long)KG * ROWS * COLS <= smem_floats,
                "the k-group sums alias the stages");
};
// The GRU's blocked kernels (gru_{fwd,bwd}_blocked.cu): a tile of U hidden
// units sums 2U columns (the forward's u and r gates) or U columns (the
// forward's candidate, both backward products), U in {8, 16}.
template <int U>
struct GruTile;
template <>
struct GruTile<8> {
  using Gates = NtTile<16, 4, 4>;
  using Units = NtTile<8, 4, 2>;
};
template <>
struct GruTile<16> {
  using Gates = NtTile<32, 4, 8>;
  using Units = NtTile<16, 4, 4>;
};

// Stage rows [0, ROWS) of A and [0, COLS) of B, columns [k0, k0 + kKT)
// of each, into dst ([ROWS + COLS, kTileStride]); past K reads as 0.  A
// null row (past an edge, or a skipped row) is not loaded at all: its
// sums are never read.  `vec`: rows start 16-byte aligned, K % 4 == 0.
template <class Tl, class ARow, class BRow>
__device__ __forceinline__ void stage_nt(float* dst, ARow arow, BRow brow,
                                         int k0, int K, bool vec,
                                         const float* any) {
  constexpr int NR = Tl::ROWS + Tl::COLS, C4 = kKT / 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < NR * C4; idx += kBThreads) {
      const int r = idx / C4, c = 4 * (idx % C4);
      const float* src = r < Tl::ROWS ? arow(r) : brow(r - Tl::ROWS);
      if (src == nullptr) continue;
      const bool ok = k0 + c < K;
      cp_async16(dst + r * kTileStride + c, ok ? src + k0 + c : any, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < NR * kKT; idx += kBThreads) {
      const int r = idx / kKT, c = idx % kKT;
      const float* src = r < Tl::ROWS ? arow(r) : brow(r - Tl::ROWS);
      if (src == nullptr) continue;
      dst[r * kTileStride + c] = k0 + c < K ? __ldcg(src + k0 + c) : 0.f;
    }
  }
}

// "NT" tile product: C[r][c] = sum_{k < K} A(r)[k] * B(c)[k] for
// r < ROWS, c < COLS, where arow(r) / brow(c) point at rows whose k is
// contiguous (nullptr: a row past an edge or skipped, not loaded; its
// sums are garbage and never read).  Only the first NB of each thread's
// DR row blocks (rows rg + RG i, i < NB) are loaded and summed; the
// others sum to 0.  k streams in kKT-wide tiles through a kBStages-deep
// cp.async pipeline.  Per four k, a thread reads NB + DC float4 from
// shared memory for 4 NB DC FMAs; in a quarter-warp the A loads are
// broadcasts and the B loads hit distinct rows kTileStride floats
// apart, so no bank conflicts.  On return the KG partial sums sit in
// stages[(g * ROWS + r) * COLS + c]; red_sum_nt adds them in a fixed
// order, so a result has the same bits on every run.
template <class Tl, int NB, class ARow, class BRow>
__device__ __forceinline__ void product_nt(ARow arow, BRow brow, int K,
                                           bool vec, const float* any,
                                           float* stages) {
  constexpr int DR = Tl::DR, DC = Tl::DC, RG = Tl::RG, CB = Tl::CB;
  constexpr int KS = Tl::KS, SF = Tl::SF;
  const int tid = threadIdx.x;
  const int cb = tid % CB, rg = (tid / CB) % RG, g = tid / (CB * RG);
  const int nt = (K + kKT - 1) / kKT;
  float acc[DR][DC];
#pragma unroll
  for (int i = 0; i < DR; ++i)
#pragma unroll
    for (int d = 0; d < DC; ++d) acc[i][d] = 0.f;
  __syncthreads();  // the buffers (and the last tile's sums) are free
#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    if (s < nt)
      stage_nt<Tl>(stages + s * SF, arow, brow, s * kKT, K, vec, any);
    cp_commit();
  }
  for (int kt = 0; kt < nt; ++kt) {
    cp_wait<kBStages - 2>();
    __syncthreads();
    if (kt + kBStages - 1 < nt)
      stage_nt<Tl>(stages + ((kt + kBStages - 1) % kBStages) * SF, arow,
                   brow, (kt + kBStages - 1) * kKT, K, vec, any);
    cp_commit();
    const float* ta = stages + (kt % kBStages) * SF;
    const float* tb = ta + Tl::ROWS * kTileStride;
#pragma unroll
    for (int kk = g * KS; kk < (g + 1) * KS; kk += 4) {
      float4 a[NB], b[DC];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        a[i] = *reinterpret_cast<const float4*>(ta + (rg + RG * i) *
                                                kTileStride + kk);
#pragma unroll
      for (int d = 0; d < DC; ++d)
        b[d] = *reinterpret_cast<const float4*>(tb + (cb + CB * d) *
                                                kTileStride + kk);
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int d = 0; d < DC; ++d) {
          acc[i][d] += a[i].x * b[d].x;
          acc[i][d] += a[i].y * b[d].y;
          acc[i][d] += a[i].z * b[d].z;
          acc[i][d] += a[i].w * b[d].w;
        }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every tile is read: the sums may overwrite them
#pragma unroll
  for (int i = 0; i < DR; ++i)
#pragma unroll
    for (int d = 0; d < DC; ++d)
      stages[(g * Tl::ROWS + rg + RG * i) * Tl::COLS + cb + CB * d] =
          acc[i][d];
  __syncthreads();
}

template <class Tl>
__device__ __forceinline__ float red_sum_nt(const float* red, int r, int c) {
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < Tl::KG; ++g) s += red[(g * Tl::ROWS + r) * Tl::COLS + c];
  return s;
}

// The tile product over the first a_rows (>= 1) rows of A: the rows from
// a_rows on are neither loaded nor summed, in quarters of the tile's
// rows (32 rows), each count of quarters a straight-line product.
template <class Tl, class ARow, class BRow>
__device__ __forceinline__ void product_rows(ARow arow, BRow brow, int K,
                                             bool vec, const float* any,
                                             float* stages, int a_rows) {
  static_assert(Tl::DR % 4 == 0, "quarters of the rows");
  constexpr int Q = Tl::DR / 4;  // row blocks a quarter
  switch ((a_rows + Q * Tl::RG - 1) / (Q * Tl::RG)) {
    case 1:
      product_nt<Tl, Q>(arow, brow, K, vec, any, stages);
      break;
    case 2:
      product_nt<Tl, 2 * Q>(arow, brow, K, vec, any, stages);
      break;
    case 3:
      product_nt<Tl, 3 * Q>(arow, brow, K, vec, any, stages);
      break;
    default:
      product_nt<Tl, 4 * Q>(arow, brow, K, vec, any, stages);
  }
}

// The rows of batch tile [r0, r0 + kBRows) valid at step t (mask[b, t] !=
// 0, b < B), ascending: rows_s[0, n) holds them, pos_s[r] the place of
// row r0 + r in that list (-1 when it is not valid).  Returns n; ends
// with a barrier, after which both arrays are visible to the CTA.
__device__ __forceinline__ int valid_tile_rows(const float* mask, int B,
                                               int T, int t, int r0,
                                               int* rows_s, int* pos_s) {
  static_assert(kBThreads >= kBRows && kBRows % 32 == 0, "one row a thread");
  __shared__ int warp_n[kBRows / 32];
  const int tid = threadIdx.x;
  const bool valid = tid < kBRows && r0 + tid < B &&
                     mask[(long)(r0 + tid) * T + t] != 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if (tid < kBRows && tid % 32 == 0) warp_n[tid / 32] = __popc(ballot);
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kBRows / 32; ++w) {
    if (w < tid / 32) before += warp_n[w];
    n += warp_n[w];
  }
  if (tid < kBRows) {
    const int p = before + __popc(ballot & ((1u << (tid % 32)) - 1u));
    pos_s[tid] = valid ? p : -1;
    if (valid) rows_s[p] = r0 + tid;
  }
  __syncthreads();
  return n;
}

// The valid (b, t) rows of a [B, T] mask, for the blocked tiers' dW
// products (lstm_dw_blocked.cu, gru_dw_blocked.cu), which skip the padded
// rows: their dgates are exact zeros.  One CTA of kCompactThreads:
// rows[0, n) = the indices r < R with mask[r] != 0, ascending; n into
// rows[R].
constexpr int kCompactThreads = 1024;
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

// CTAs of `kernel` (`threads` threads, smem_floats of shared memory) that
// can be co-resident on the current card; 0 when the card has no
// cooperative launch, a cudaError_t as a negative number on failure.
template <typename K>
__host__ inline long resident_ctas(K kernel, long smem_floats,
                                   int threads = kBThreads) {
  const size_t smem = (size_t)smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(long)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(long)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return -(long)err;
  return coop ? (long)per_sm * sms : 0;
}

// Per-CTA work of a tiling: rounds of the grid over n_tiles, times the
// tile's width; "none" (a huge cost) when nothing is resident.
__host__ inline long tile_cost(long n_tiles, long resident, int cols) {
  if (resident <= 0) return 1L << 62;
  return (n_tiles + resident - 1) / resident * cols;
}

// Launch `kernel` cooperatively on min(n_tiles, resident) CTAs of
// kBThreads threads (the kernels stride over their tiles).  Returns 0 or
// a cudaError_t; -1 when not even one CTA fits or the card has no
// cooperative launch.
template <typename K>
__host__ inline int launch_tiles(K kernel, long n_tiles, long resident,
                                 long smem_floats, void** args,
                                 cudaStream_t stream) {
  if (resident < 0) return (int)-resident;
  if (resident == 0) return -1;
  const int grid = (int)(n_tiles < resident ? n_tiles : resident);
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(grid), dim3(kBThreads), args,
      (size_t)smem_floats * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lstm
