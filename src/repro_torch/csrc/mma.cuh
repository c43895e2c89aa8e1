// Tensor-core and asynchronous-copy wrappers (PTX) for the bf16 attention
// kernels (decode_attention.cu and dct2.cu take only the cp.async ones):
// mma.sync m16n8k16 with f32 accumulators, ldmatrix (plain and
// transposed) from shared memory, and 16-byte cp.async with zero fill.
// Fragment layouts are PTX's for m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..), two bf16 per register, the lower
//                     column in the low half;
//   B (16 x 8, col):  b0 (rows 2t..2t+1, column g), b1 (rows 2t+8.., g);
//   C (16 x 8, f32):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// Included by .cu files only; each translation unit gets its own copy (an
// unnamed namespace), as with tile_io.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a b: one 16 x 8 x 16 bf16 product into f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives (row lane / 4, columns 2 (lane % 4)..)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed: register i receives (rows 2 (lane % 4)
// .. + 1, column lane / 4) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, asynchronous; with valid false nothing is
// read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// (x, y) -> bf16x2, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x = hi + lo + O(2^-17 |x|): hi = bf16(x), lo = bf16(x - hi), packed in
// pairs as pack_bf16 does
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// ---- warpgroup products (wgmma, sm_90a) ----------------------------------
// D (64 x 64 f32 over the 128 threads of a warpgroup, 32 a thread) in the
// layout of four m16n8 C fragments stacked by warp: warp w, lane 4 g + t
// holds d[4 j + 0..1] = (16 w + g, 8 j + 2 t..) and d[4 j + 2..3] =
// (16 w + g + 8, 8 j + 2 t..).  Operands in shared memory are described
// by a matrix descriptor over a 128-byte-swizzled tile: rows of 128 bytes
// whose 16-byte chunk c sits at chunk c ^ (row % 8), 1024-byte aligned.

// descriptor of a 128-byte-swizzled K-major operand starting at p (rows
// along M or N, K contiguous): 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is not read
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// the same for an MN-major operand (rows along K, N contiguous) stored as
// 64-wide column blocks `block` bytes apart: 8-row groups along K 1024
// bytes apart (the stride byte offset), blocks along N `block` bytes apart
// (the leading byte offset)
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* p,
                                                  uint32_t block) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(block >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// the async proxy (wgmma) sees what this thread wrote to shared memory
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Accumulator operands of an m64nN wgmma (N / 2 f32 a thread): the asm
// text "{%0, ..., %(N/2 - 1)}" and the outputs "+f"(d[0]) ...
#define REPRO_WG_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define REPRO_WG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define REPRO_WG_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define REPRO_WG_OUT4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define REPRO_WG_OUT16(i) \
  REPRO_WG_OUT4(i), REPRO_WG_OUT4(i + 4), REPRO_WG_OUT4(i + 8), \
      REPRO_WG_OUT4(i + 12)
#define REPRO_WG_OUT32 REPRO_WG_OUT16(0), REPRO_WG_OUT16(16)
#define REPRO_WG_OUT64 REPRO_WG_OUT32, REPRO_WG_OUT16(32), REPRO_WG_OUT16(48)
#define REPRO_WG_OUT128                                                  \
  REPRO_WG_OUT64, REPRO_WG_OUT16(64), REPRO_WG_OUT16(80),                \
      REPRO_WG_OUT16(96), REPRO_WG_OUT16(112)

// d = (accumulate ? d : 0) + A B, m64n64k16, A (64 x 16) and B (64 x 16,
// i.e. the 16 x 64 operand stored N-major) both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      REPRO_WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WG_OUT32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64nNk16, A (16 rows a warp) from registers in the m16n8k16 A
// fragment layout, B (16 x N) in shared memory MN-major (rows along K, N
// contiguous: transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

#define REPRO_WG_RS(N, D, OUT, A, DB, ONE)                                \
  template <>                                                              \
  __device__ __forceinline__ void wgmma_rs<N>(                             \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t db) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " ONE ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                    \
                 "k16.f32.bf16.bf16 " D ", " A ", " DB ", p, 1, 1, 1;\n}\n" \
                 : OUT                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                   "r"(1));                                                \
  }
REPRO_WG_RS(64, REPRO_WG_D32, REPRO_WG_OUT32,
            "{%32, %33, %34, %35}", "%36", "%37")
REPRO_WG_RS(128, REPRO_WG_D64, REPRO_WG_OUT64,
            "{%64, %65, %66, %67}", "%68", "%69")
REPRO_WG_RS(256, REPRO_WG_D128, REPRO_WG_OUT128,
            "{%128, %129, %130, %131}", "%132", "%133")
#undef REPRO_WG_RS
#undef REPRO_WG_D32
#undef REPRO_WG_D64
#undef REPRO_WG_D128
#undef REPRO_WG_OUT4
#undef REPRO_WG_OUT16
#undef REPRO_WG_OUT32
#undef REPRO_WG_OUT64
#undef REPRO_WG_OUT128

}  // namespace
