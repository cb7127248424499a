// Hopper warpgroup matrix products (wgmma, sm_90a only) and the swizzled
// shared-memory tiles they read, shared by the tensor-core main loops of
// kernels 18-21 (conv3x3_tc.cuh), the flash kernels (flash_wg.cuh), the
// recurrences' step products (lstm_wg.cuh, lstm_fwd.cu, gru_fwd.cu) and
// the dW tile (dw_wg.cuh).
//
// A warpgroup is 4 consecutive warps (128 threads, the first warp's index
// a multiple of 4).  One wgmma adds a 64 x N product (N in {16, 32, 64,
// 128} here) of bf16 operands, 16 deep, into f32 accumulators.  Warp w of the
// group owns rows 16w..16w+15 in mma.sync's m16n8 layout: thread (g =
// lane / 4, t = lane % 4) holds, for each 8-column block j, d[4j + 0, 1]
// = (row g, columns 8j + 2t, + 1) and d[4j + 2, 3] = (row g + 8, the same
// columns).  An A operand from registers (RS) is 4 b32 a thread in
// mma.sync's m16n8k16 A layout: an ldmatrix.x4 fragment, or 16 columns
// of an accumulator tile converted in registers.
//
// B, and A of a product from shared memory (SS), is read through a
// matrix descriptor from a tile in the canonical swizzled layout: rows of
// SW bytes (SW = 128, or 64 for 32 bf16 values), the 16-byte chunk c of
// row r stored at chunk c ^ ((r * SW / 128) % (SW / 16)) -- the
// hardware's Swizzle<3,4,3> (SW 128) or Swizzle<2,4,3> (SW 64) of the
// byte address, so every tile starts on a 1024-byte boundary.  Wider rows
// are cut into column blocks of SW bytes, each a tile of its own.
//   K-major (the reduction dimension contiguous: Q and K in S = Q K^T):
//   8-row groups SBO = 8 * SW bytes apart; a 16-deep step advances the
//   start address by 32 bytes inside a column block.
//   MN-major (the output dimension contiguous: V in O = P V, the conv
//   weights [Cin, Cout]; also A in dW = X^T G from the rows of X):
//   rows run along the reduction, 8-row groups SBO = 8 * SW bytes apart,
//   column blocks LBO bytes apart; transpose flag 1 (an MN-major A, SS
//   only, sets the A flag).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset `off` inside a tile of SW-byte rows, swizzled.
template <int SW>
__host__ __device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// The 1024-byte aligned start of dynamic shared memory (the caller
// allocates 1024 bytes more than it uses).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Matrix descriptor of a swizzled tile at shared address `addr`.
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma operands from shared memory); then a
// barrier hands the tile to the warpgroups.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins n accumulator registers at this point of the program, so that no
// read of them moves above a wait() nor any write below a wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarriers in shared memory (8 bytes each, 8-byte aligned) and tensor
// copies (TMA): one thread asks for a box of a tensor, the copy engine
// writes it into shared memory in the swizzled layout of the map and
// counts its bytes on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the copy engine (then a
// __syncthreads).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more bytes of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// The box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst (1024-byte aligned for a swizzled map).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The box of a 2-d tensor map at coordinates (c0 innermost, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// A tiled tensor map of a bf16 tensor of `rank` dims (dims[0]
// contiguous), byte strides of dims 1.., boxes of `box` elements,
// swizzled by sw bytes (128 or 64), zeros outside.  cuTensorMapEncodeTiled
// is a driver function: it is fetched through the runtime, so the library
// needs no -lcuda.  Returns false when the map cannot be made.
inline bool tma_map(CUtensorMap* map, const void* base, int rank,
                    const uint64_t* dims, const uint64_t* strides,
                    const uint32_t* box, int sw) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    if (!fn || found != cudaDriverEntryPointSuccess) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t cbox[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    cbox[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides[i];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), gdim, gstride, cbox, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)

// d[64 x 16] (+)= A[64 x 16] * B[16 x 16], A and B from shared memory,
// both K-major.
__device__ __forceinline__ void mma_ss_n16(float* d, uint64_t adesc,
                                           uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : WG_D4(0), WG_D4(4)
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// d[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B from shared memory,
// both K-major.
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t adesc,
                                           uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D16(0)
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory.
template <int TNSPB>
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t adesc,
                                           uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : WG_D16(0), WG_D16(16)
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TNSPB));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory,
// each K-major (flag 0) or MN-major (flag 1).
template <int TNSPA, int TNSPB>
__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t adesc,
                                            uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TNSPA), "n"(TNSPB));
}

// d[64 x N] (+)= A[64 x 16] * B[16 x N], A in registers (a[4]).
template <int TNSPB>
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : WG_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d), "n"(TNSPB));
}

template <int TNSPB>
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D16(0), WG_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d), "n"(TNSPB));
}

template <int TNSPB>
__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d), "n"(TNSPB));
}

#undef WG_D16
#undef WG_D4

template <int N, int TNSPB>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t bdesc, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32) mma_rs_n32<TNSPB>(d, a, bdesc, scale_d);
  else if constexpr (N == 64) mma_rs_n64<TNSPB>(d, a, bdesc, scale_d);
  else mma_rs_n128<TNSPB>(d, a, bdesc, scale_d);
}

}  // namespace wg
