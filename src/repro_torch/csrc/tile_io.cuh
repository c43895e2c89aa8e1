// Tile staging shared by the attention kernels: element conversion to and
// from f32 (attention.cu, decode_attention.cu), and the copy of a tile of
// bf16 or f32 rows from global memory into shared memory as f32
// (attention.cu).  Included by .cu files only; each translation unit gets its own
// copy (an unnamed namespace), as with the rest of their helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Copy `rows` rows of DH elements (row r at src + r * stride; rows at or
// past `valid` read as 0) into shared memory as f32, row r at dst + r *
// dst_stride (a multiple of 4 floats).  16-byte loads and stores when the
// rows are 16-byte aligned, so a thread has several independent loads in
// flight instead of a chain of 2-byte ones; element by element otherwise.
template <int DH, typename T>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const T* src, size_t stride,
                                           int rows, int valid, int tid,
                                           int nthr) {
  constexpr int VEC = 16 / sizeof(T);
  if (DH % VEC == 0 && ((size_t)src % 16) == 0 &&
      (stride * sizeof(T)) % 16 == 0) {
    constexpr int NV = DH / VEC;
#pragma unroll 4
    for (int i = tid; i < rows * NV; i += nthr) {
      const int r = i / NV, c = i % NV;
      float4 raw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < valid)
        raw = *reinterpret_cast<const float4*>(src + r * stride + c * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
      float4* out = reinterpret_cast<float4*>(dst + r * dst_stride + c * VEC);
#pragma unroll
      for (int t = 0; t < VEC / 4; ++t)
        out[t] = make_float4(to_f32(e[4 * t]), to_f32(e[4 * t + 1]),
                             to_f32(e[4 * t + 2]), to_f32(e[4 * t + 3]));
    }
  } else {
    for (int i = tid; i < rows * DH; i += nthr) {
      const int r = i / DH, d = i % DH;
      dst[r * dst_stride + d] = r < valid ? to_f32(src[r * stride + d]) : 0.0f;
    }
  }
}

}  // namespace
