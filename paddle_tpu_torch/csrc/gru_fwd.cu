// Fused GRU forward: the whole time loop of one direction in one launch,
// for H <= 512.
//
// Replaces paddle_tpu/ops/pallas_gru.py::_fwd_kernel (_fwd_call), which
// runs a sequential grid over T on one TPU core with h carried in VMEM
// and both recurrent weights resident.  On Hopper the batch rows, which
// never mix, are cut into groups of kRows = 32, and each group runs its
// whole time loop in one thread-block cluster of C = ceil(H / 32) CTAs
// (up to 16, a non-portable cluster size), with no grid barrier:
//
// - CTA c of a cluster owns hidden units [32c, 32c + 32).  Its 64 gate
//   columns of w_gates (u and r of its units) stay in shared memory for
//   all T steps as bf16 hi/lo planes, K-major in the 128-byte swizzle
//   (128 KB at H 512); its 32 columns of w_cand as a hi plane there (32
//   KB) and a lo plane in registers (64 a thread at H 512).  The h carry
//   of its (row, unit) pairs stays in registers.
// - Each step's two products put the weights in M and the rows in N:
//   g^T [64 x 32] = w_gates[:, own]^T h_{t-1}^T, then c^T [32 x 32] =
//   w_cand[:, own]^T (r h_{t-1})^T, on wgmma m64n32k16 (wgmma.cuh) with A =
//   the resident planes and B = a 64 KB buffer that holds the group's 32
//   rows of h_{t-1} (then of r h_{t-1}) for all H units as bf16 hi/lo
//   planes.  A's rows are ordered so that one thread's accumulators hold
//   u and r of one unit: row 16w + j is u of unit 8w + j and row 16w + 8
//   + j its r (j < 8).  The candidate has 32 rows, in the even 8-row
//   groups of its m64 tile: its hi planes pair chunks c and c + P (P =
//   half the chunks, rounded up) in one 8 KB block, c's groups in the
//   even slots and c + P's in the odd ones, so the tile's odd groups
//   read the other chunk's rows, which are dropped; its lo pass takes A
//   from registers (zeros in the odd groups).
// - Numbers (lstm_wg.cuh's): three passes hi*hi + hi*lo + lo*hi, each
//   64-wide K chunk's sums drained into f32 registers in chunk order;
//   gate math in fp32.
// - The buffer.  Its layout has no swizzle, so that the 32 units of a
//   CTA are 4 KB of contiguous bytes (8-row x 16-byte core matrices,
//   ordered chunk x 8-unit block x plane x 8-row group).  After each
//   product a CTA writes the planes of its own units (r h_{t-1} after
//   the gates, h_t after the candidate) into its buffer and hands those
//   4 KB to each peer's buffer with one bulk asynchronous copy through
//   distributed shared memory (cp.async.bulk.shared::cluster), counted on
//   the peer's mbarrier of the chunk that holds them; the next product
//   waits on each chunk's mbarrier just before that chunk's k steps, so
//   later chunks' copies land while earlier chunks multiply.  One
//   cluster barrier a phase, split into arrive (after the product) and
//   wait (after the gate math): past it every CTA has read its buffer
//   and every copy of the phase before has landed, so the copies may
//   overwrite.
// - The prologue reads each weight column eight rows at a time, a warp's
//   lanes on 32 columns (coalesced), and h0 eight units of a row at a
//   time, a warp's lanes on 32 rows, and stores 16-byte pieces of the
//   planes (no bank conflicts); the candidate's lo plane passes through
//   the buffer's place on its way into the fragments.
//
// Every row takes part in every step's products (a padded step's
// residue u, r, c is part of the contract, from the kept h), so there
// are no ranks: column n of the products is row 32 g + n of the batch.
// Rows past B and units past H are zeros that are never written out;
// the buffer's K padding stays zero.  Nothing leaves the cluster but the
// outputs: no planes go through L2.
//
// Layouts are batch-major: xw / gates [B, T, 3H] (gate order u, r, c),
// H [B, T, H], mask [B, T] (1.0 valid, 0.0 padding), w_gates [H, 2H],
// w_cand [H, H], h0 [B, H].
//
// Bound on this card: operations.  At B 128, T 30, H 512 the two
// recurrent products are 2 * B * T * H * 3H = 6.04 GFLOP, three bf16
// passes 18.1 GFLOP: 18.3 us at 989 TFLOP/s (90.1 us at the fp32 rate);
// the bytes (~40 MB) take ~12 us.  A product streams its A operand from
// shared memory (2 KB a wgmma for 32 columns), and each phase waits on
// a cluster barrier and its copies.
#include <cuda_bf16.h>

#include "lstm_common.cuh"
#include "wgmma.cuh"

using namespace lstm;

namespace {
constexpr int kCta = 128;            // one warpgroup
constexpr int kUnits = 32;           // hidden units a CTA
constexpr int kRows = 32;            // batch rows a cluster (wgmma N)
constexpr int kMaxCluster = 16;      // H <= 512
constexpr int kMaxChunks = 8;
constexpr int kChunk = 64;           // K values a chunk (128 bytes)
constexpr int kGate = 64 * 128;      // bytes of a gate plane's chunk
constexpr int kGateChunk = 2 * kGate;        // hi, lo
constexpr int kCandBlock = 64 * 128;         // two chunks' hi planes
constexpr int kCore = 128;                   // a core matrix, 8 rows x 16 B
constexpr int kPlaneCores = kRows / 8 * kCore;   // a plane's 8-unit block
constexpr int kBlock8 = 2 * kPlaneCores;     // 8 units: hi, lo (1 KB)
constexpr int kBufChunk = 8 * kBlock8;       // 64 units (8 KB)
constexpr int kRegion = kUnits / 8 * kBlock8;    // a CTA's units (4 KB)

__host__ __device__ constexpr int n_chunks(int H) {
  return (H + kChunk - 1) / kChunk;
}
// Shared memory for H: 1 KB of alignment, the gate planes, the
// candidate's hi blocks and the buffer (the candidate's odd groups of
// its last block read 1 KB past the blocks, into the buffer).
__host__ __device__ constexpr int smem_bytes(int H) {
  return 1024 + n_chunks(H) * (kGateChunk + kBufChunk) +
         (n_chunks(H) + 1) / 2 * kCandBlock;
}

struct Args {
  const float* xw;
  const float* mask;
  const float* w_gates;
  const float* w_cand;
  const float* h0;
  float* hseq;
  float* gates;
  int B, T, H, C;
};

// The arrival needs no release: what it announces is that this CTA's
// products have retired (their reads of the buffer are complete) and
// that every copy into this CTA has landed (its mbarriers said so).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Matrix descriptor of a K-major tile without swizzle: core matrices of
// 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo` along M or N.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// Byte offset of (row n, unit k, plane p) in the buffer.
__device__ __forceinline__ int buf_off(int n, int k, int p) {
  return k / kChunk * kBufChunk + k % kChunk / 8 * kBlock8 +
         p * kPlaneCores + n / 8 * kCore + n % 8 * 16 + k % 8 * 2;
}

// x's planes at (row n, unit k) of the buffer.
__device__ __forceinline__ void put_buf(unsigned char* buf, int n, int k,
                                        float x) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  unsigned char* p = buf + buf_off(n, k, 0);
  *reinterpret_cast<__nv_bfloat16*>(p) = hi;
  *reinterpret_cast<__nv_bfloat16*>(p + kPlaneCores) =
      __float2bfloat16_rn(x - __bfloat162float(hi));
}

// B's descriptors (hi, lo) of k step kk of chunk c of the buffer.
__device__ __forceinline__ uint64_t buf_desc(uint32_t b_addr, int c,
                                             int kk) {
  return desc_plain(b_addr + c * kBufChunk + 2 * kk * kBlock8, kBlock8,
                    kCore);
}

// The gates: tot[64 x 32] = A B^T over nch chunks of K, A = the gate
// planes; three passes a k step, each chunk's sums added to tot in f32.
// Chunk c waits for its copies on inbox[c] first (parity par; none when
// par < 0), so the later chunks' copies land during the earlier products.
__device__ __forceinline__ void gate_product(float* tot, uint32_t a_addr,
                                             uint32_t b_addr, int nch,
                                             uint64_t* inbox, int par) {
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) tot[e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (par >= 0) wg::mbar_wait(inbox + c, par);
    const uint64_t ah = wg::desc<128>(a_addr + c * kGateChunk, 16, 1024);
    const uint64_t al = ah + (kGate >> 4);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {  // 32 bytes a k step
      const uint64_t bh = buf_desc(b_addr, c, kk);
      const uint64_t bl = bh + (kPlaneCores >> 4);
      wg::mma_ss_n32(acc, ah + 2 * kk, bh, kk > 0);
      wg::mma_ss_n32(acc, ah + 2 * kk, bl, 1);
      wg::mma_ss_n32(acc, al + 2 * kk, bh, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc<16>(acc);
#pragma unroll
    for (int e = 0; e < 16; ++e) tot[e] += acc[e];
  }
}

// The candidate: A = the hi blocks (chunk c at block c % P, odd slots
// when c >= P) and, for the lo pass, this thread's fragments in lo; the
// copies waited for as gate_product does.
__device__ __forceinline__ void cand_product(
    float* tot, uint32_t a_addr, uint32_t b_addr, int nch,
    const uint32_t (&lo)[kMaxChunks][kChunk / 16][2], uint64_t* inbox,
    int par) {
  const int P = (nch + 1) / 2;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) tot[e] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c >= nch) break;
    wg::mbar_wait(inbox + c, par);
    // the chunk's addresses made here (opaque to the compiler), so that
    // the unrolled chunks' descriptors are not all kept in registers
    // across the time loop
    uint32_t aa = a_addr + c % P * kCandBlock + c / P * 1024, bb = b_addr;
    asm volatile("" : "+r"(aa), "+r"(bb));
    const uint64_t ah = wg::desc<128>(aa, 16, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint64_t bh = buf_desc(bb, c, kk);
      const uint64_t bl = bh + (kPlaneCores >> 4);
      const uint32_t a[4] = {lo[c][kk][0], 0u, lo[c][kk][1], 0u};
      wg::mma_ss_n32(acc, ah + 2 * kk, bh, kk > 0);
      wg::mma_ss_n32(acc, ah + 2 * kk, bl, 1);
      wg::mma_rs_n32<0>(acc, a, bh, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc<16>(acc);
#pragma unroll
    for (int e = 0; e < 16; ++e) tot[e] += acc[e];
  }
}

// Eight f32 values as 16-byte pieces of their hi and lo planes.
__device__ __forceinline__ void split8(const float (&x)[8], uint4& h4,
                                       uint4& l4) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    const float2 hf = __bfloat1622float2(h2);
    const __nv_bfloat162 l2 =
        __floats2bfloat162_rn(x[2 * e] - hf.x, x[2 * e + 1] - hf.y);
    hi[e] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[e] = *reinterpret_cast<const uint32_t*>(&l2);
  }
  h4 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  l4 = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Rows k0 .. k0 + 7 of weight column j of a CTA (j < 64: gate j / 32 of
// unit j % 32; else the candidate of unit j - 64) as 16-byte pieces of
// its planes: the gates' hi and lo, the candidate's hi; the candidate's
// lo into stage ([32 units, Kp + 8] bf16, read back as fragments).
__device__ __forceinline__ void put_w8(unsigned char* wgp, unsigned char* wcp,
                                       unsigned char* stage, int P, int Kp,
                                       int k0, int j, const float (&x)[8]) {
  uint4 h4, l4;
  split8(x, h4, l4);
  const int c = k0 / kChunk, kk = k0 % kChunk;
  const int u = j % kUnits;
  if (j < 2 * kUnits) {
    const int m = 16 * (u / 8) + 8 * (j / kUnits) + u % 8;
    unsigned char* p = wgp + c * kGateChunk + wg::swz<128>(m * 128 + kk * 2);
    *reinterpret_cast<uint4*>(p) = h4;
    *reinterpret_cast<uint4*>(p + kGate) = l4;
  } else {
    const int slot = 2 * (u / 8) + c / P;
    *reinterpret_cast<uint4*>(
        wcp + c % P * kCandBlock +
        wg::swz<128>(slot * 1024 + u % 8 * 128 + kk * 2)) = h4;
    *reinterpret_cast<uint4*>(stage + (u * (Kp + 8) + k0) * 2) = l4;
  }
}

}  // namespace

__global__ void __launch_bounds__(kCta, 1) gru_fwd_cluster_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t inbox[kMaxChunks];   // the copies into each chunk
  const int B = a.B, T = a.T, H = a.H, C = a.C;
  const int nch = n_chunks(H), Kp = nch * kChunk, P = (nch + 1) / 2;
  unsigned char* wgp = wg::align1024(smem_raw);   // [chunk][hi, lo] gates
  unsigned char* wcp = wgp + nch * kGateChunk;    // [P] candidate hi
  unsigned char* buf = wcp + P * kCandBlock;      // the rows' planes
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int rank = blockIdx.x % C, b0 = blockIdx.x / C * kRows;
  const int u0 = rank * kUnits;
  const int unit = u0 + 8 * wq + g8;   // this thread's unit
  const bool unit_ok = unit < H;
  const long TH = (long)T * H, T3H = 3 * TH;
  // this thread's rows: accumulator columns 8 jb + 2 tq + e, q = 2 jb + e
  auto row = [&](int q) { return 8 * (q >> 1) + 2 * tq + (q & 1); };

  // prologue: the mbarriers; the weights' planes (the candidate's lo
  // staged in the buffer's place, then read into this thread's
  // fragments); h0's planes for every unit (the buffer of step 0) and
  // this thread's h carry
  if (tid < kMaxChunks) wg::mbar_init(inbox + tid, 1);
  if (tid == 0) wg::mbar_fence_init();
  // eight rows of one column an item, a warp's lanes on 32 columns of
  // one gate: coalesced loads, conflict-free 16-byte stores
#pragma unroll 8
  for (int i = tid; i < 3 * kUnits * (Kp / 8); i += kCta) {
    const int j = i % (3 * kUnits), k0 = i / (3 * kUnits) * 8;
    const int u = u0 + j % kUnits;
    const float* src = j < 2 * kUnits ? a.w_gates + j / kUnits * H + u
                                      : a.w_cand + u;
    const long ld = j < 2 * kUnits ? 2L * H : H;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = u < H && k0 + e < H ? __ldg(src + (k0 + e) * ld) : 0.f;
    put_w8(wgp, wcp, buf, P, Kp, k0, j, x);
  }
  __syncthreads();
  // the candidate's lo pass: row g8 of warp wq's 16 is unit 8 wq + g8,
  // k step kk of chunk c holds k = 64 c + 16 kk + 2 tq (+1) and (+8, +9)
  uint32_t clo[kMaxChunks][kChunk / 16][2];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = c * kChunk + 16 * kk + 8 * h + 2 * tq;
        clo[c][kk][h] = c < nch ? *reinterpret_cast<const uint32_t*>(
                                      buf + ((8 * wq + g8) * (Kp + 8) + k) * 2)
                                : 0u;
      }
  __syncthreads();   // the stage is read
  // h0's planes over the whole buffer (zeros past B and past H): units
  // k0 .. k0 + 7 of one row an item, a warp's lanes on 32 rows (16-byte
  // stores without bank conflicts)
#pragma unroll 4
  for (int i = tid; i < kRows * (Kp / 8); i += kCta) {
    const int n = i % kRows, k0 = i / kRows * 8, b = b0 + n;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = b < B && k0 + e < H ? __ldg(a.h0 + (long)b * H + k0 + e) : 0.f;
    uint4 h4, l4;
    split8(x, h4, l4);
    *reinterpret_cast<uint4*>(buf + buf_off(n, k0, 0)) = h4;
    *reinterpret_cast<uint4*>(buf + buf_off(n, k0, 1)) = l4;
  }
  float hc[8];   // the h carry of this thread's pairs
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int b = b0 + row(q);
    hc[q] = b < B && unit_ok ? a.h0[(long)b * H + unit] : 0.f;
  }
  wg::fence_proxy_async();   // the planes: generic writes, then wgmma
  __syncthreads();

  const uint32_t wg_addr = wg::smem_u32(wgp), wc_addr = wg::smem_u32(wcp);
  const uint32_t b_addr = wg::smem_u32(buf);
  const uint32_t region = b_addr + rank / 2 * kBufChunk +
                          rank % 2 * (kUnits / 8) * kBlock8;
  int exchanges = 0;   // the next product waits on the last one's parity
  // Past a phase's cluster barrier, with this CTA's new planes written
  // into its buffer: those planes to every peer's buffer (counted on the
  // peer's mbarrier of this CTA's chunk; thread r issues the copy to peer
  // r), and each chunk's mbarrier armed for the copies of the peers in
  // it (a thread of the second warp each); the next product waits on
  // them.
  auto exchange = [&]() {
    wg::fence_proxy_async();   // the generic writes, then the copies
    __syncthreads();
    if (tid < C && tid != rank) {   // thread r copies to peer r
      uint32_t dst, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(dst)
                   : "r"(region), "r"(tid));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(bar)
                   : "r"(wg::smem_u32(inbox + rank / 2)), "r"(tid));
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
          "::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
          "r"(region), "n"(kRegion), "r"(bar)
          : "memory");
    }
    if (tid >= 32 && tid < 32 + nch) {   // chunk c: peers 2c and 2c + 1
      const int c = tid - 32;
      const int n = (2 * c < C && 2 * c != rank) +
                    (2 * c + 1 < C && 2 * c + 1 != rank);
      wg::mbar_expect(inbox + c, n * kRegion);
    }
    ++exchanges;
  };

  for (int t = 0; t < T; ++t) {
    // this step's inputs of the gates, loaded before the product
    float xu[8], xr[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int b = b0 + row(q);
      const bool ok = b < B && unit_ok;
      const float* x = a.xw + b * T3H + (long)t * 3 * H + unit;
      xu[q] = ok ? __ldcs(x) : 0.f;
      xr[q] = ok ? __ldcs(x + H) : 0.f;
    }
    // the gates: accumulator rows 16 wq + g8 (u) and + 8 (r) of the unit
    float g[16];
    gate_product(g, wg_addr, b_addr, nch, inbox,
                 exchanges ? (exchanges - 1) & 1 : -1);
    cluster_arrive();   // this CTA has read its buffer
    float uu[8], rh[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int b = b0 + row(q), e = 4 * (q >> 1) + (q & 1);
      uu[q] = sigm(xu[q] + g[e]);
      const float rr = sigm(xr[q] + g[e + 2]);
      if (b < B && unit_ok) {
        float* go = a.gates + b * T3H + (long)t * 3 * H + unit;
        go[0] = uu[q];
        go[H] = rr;
      }
      rh[q] = rr * hc[q];
    }
    float xc[8], m[8];   // the candidate's inputs
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int b = b0 + row(q);
      xc[q] = b < B && unit_ok
                  ? __ldcs(a.xw + b * T3H + (long)t * 3 * H + 2 * H + unit)
                  : 0.f;
      m[q] = b < B ? a.mask[(long)b * T + t] : 0.f;
    }
    cluster_wait();   // every CTA has read its buffer; no copy in flight
    if (unit_ok)
#pragma unroll
      for (int q = 0; q < 8; ++q) put_buf(buf, row(q), unit, rh[q]);
    exchange();
    // the candidate: accumulator rows 16 wq + g8 of the unit (the rows +
    // 8 are the other chunk's, dropped)
    float s[16];
    cand_product(s, wc_addr, b_addr, nch, clo, inbox, (exchanges - 1) & 1);
    const bool more = t + 1 < T;
    if (more) cluster_arrive();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int b = b0 + row(q);
      const float c = tanhf(xc[q] + s[4 * (q >> 1) + (q & 1)]);
      const float h_new = uu[q] * hc[q] + (1.f - uu[q]) * c;
      hc[q] = m[q] * h_new + (1.f - m[q]) * hc[q];
      if (b < B && unit_ok) {
        a.hseq[b * TH + (long)t * H + unit] = hc[q];
        a.gates[b * T3H + (long)t * 3 * H + 2 * H + unit] = c;
      }
    }
    if (more) {
      cluster_wait();
      if (unit_ok)
#pragma unroll
        for (int q = 0; q < 8; ++q) put_buf(buf, row(q), unit, hc[q]);
      exchange();
    }
  }
  // every copy has landed before any CTA leaves
  cluster_arrive();
  cluster_wait();
}

// Clusters of kernel 13 at H that the card can hold at once (its
// clusters run in waves past that); a negative cudaError_t on failure.
extern "C" int gru_fwd_clusters(int H) {
  if (H < 1 || H > kMaxCluster * kUnits) return -(int)cudaErrorInvalidValue;
  const int C = (H + kUnits - 1) / kUnits, smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gru_fwd_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kCta);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gru_fwd_cluster_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// One cluster of ceil(H / 32) CTAs per 32 batch rows; H <= 512, no
// scratch.  0 or a cudaError_t.
extern "C" int gru_fwd(const float* xw, const float* mask,
                       const float* w_gates, const float* w_cand,
                       const float* h0, float* hseq, float* gates, int B,
                       int T, int H, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || H > kMaxCluster * kUnits)
    return (int)cudaErrorInvalidValue;
  const int fit = gru_fwd_clusters(H);
  if (fit < 0) return -fit;
  if (fit == 0) return (int)cudaErrorInvalidConfiguration;
  const int C = (H + kUnits - 1) / kUnits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * ((B + kRows - 1) / kRows)));
  cfg.blockDim = dim3(kCta);
  cfg.dynamicSmemBytes = smem_bytes(H);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Args args{xw, mask, w_gates, w_cand, h0, hseq, gates, B, T, H, C};
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, gru_fwd_cluster_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
