// Hopper building blocks shared by the tensor-core kernels (dot_moa_wgmma.cuh,
// flash_attention.cu): cp.async with zero fill, and wgmma's shared-memory
// descriptor, fences, commit / wait and the m64n64k16 bf16 -> f32 products.
#pragma once

#include <cstdint>

#include "common.cuh"

// ---- cp.async (sm_80+) ----------------------------------------------------
// ``src_bytes`` < the copy size fills the rest of the destination with zeros:
// that is how a tile is padded past a slice's end or a matrix edge.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- wgmma (sm_90a) -------------------------------------------------------
// Operand tiles live in the 128-byte swizzled layout: rows of 128 bytes
// (64 bf16), 16-byte chunk c of row r stored at chunk c ^ (r % 8), atoms of
// 8 rows (1024 bytes) on 1024-byte boundaries.

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (between 64-element atoms along M or N of an MN-major operand;
// unused by a K-major one), stride byte offset between groups of 8 rows, in
// 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo, unsigned sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (cp.async, stores) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The warpgroup's m64nN f32 fragment: d[4 j + q] is row 16 warp + lane / 4 +
// 8 (q / 2), column 8 j + 2 (lane % 4) + q % 2.
#define REPRO_WG_D32                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
      "+f"(d[31])
#define REPRO_WG_D32_LIST                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32) = A . B + (scale_d ? d : 0), A (64 x 16) and B (16 x 64)
// from shared memory; TRANS_B = 0: B K-major (a row of the tile is one
// column of B, K contiguous), 1: MN-major (a row is one K index).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_D32_LIST
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : REPRO_WG_D32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 64 f32) += A . B, A (64 x 16 bf16) from registers (a[i] packs two
// bf16, the low half first, in the fragment layout of d's 16 columns),
// B (16 x 64) MN-major from shared memory.
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32], const unsigned (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
