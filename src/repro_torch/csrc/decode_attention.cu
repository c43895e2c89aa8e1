// Decode attention — one query token per row against a KV cache — for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/decode_attention/kernel.py  decode_attention  (body _decode_kernel)
// q (B, Hq, Dh), k/v (B, S, Hkv, Dh), cache_len (B,) int32: row b attends
// the keys k_pos < cache_len[b] and, with a window, k_pos >= cache_len[b] -
// window; GQA maps query head h*rep + r to KV head h (rep = Hq / Hkv);
// f32 online softmax; a fully masked row gives 0; the output has q's type.
//
// What bounds it on this card: bytes.  Every valid key and value row is
// read once and used for rep query rows (2 * rep * Dh operations per
// element read), far below the ~20 operations per byte at which f32 FMAs
// outrun 3.35 TB/s, let alone the tensor cores.  At the served shapes
// (gemma3-1b: B = 4, Hkv = 1, rep = 4, Dh = 256, bf16, ~700 valid keys)
// a call moves ~1.4 MB, a fraction of a microsecond of traffic, so in
// practice the two launches set its time.
//
// Design.  The TPU walks the cache's blocks one after another on one core
// and carries (m, l, acc) in VMEM; one block per (b, kv-head) here would be
// 4 blocks on 132 SMs.  So the cache is split (split-K): one block per
// (32-key chunk, kv-head, b) does the online softmax over its chunk for the
// rep query rows that share the KV head and writes a partial (m, l, acc);
// a second small pass merges each row's partials.  Chunks wholly outside
// [cache_len - window, cache_len) exit at once, before any load (the TPU
// kernel's pl.when skip): decode costs O(min(cache_len, window)), not
// O(S).  A block stages its chunk's K and V and the q rows in shared
// memory as f32, with 16-byte loads; warp r scores query row r against
// the chunk's 32 keys, one key per lane, reading 4 floats of q and of its
// key at a time (K rows padded to Dh + 4 floats, so the lanes of each
// quarter-warp hit 32 distinct banks), and takes the chunk's max and sum
// with shuffles; then each thread accumulates p . V for (row, column)
// pairs.  The GQA repeat is
// never materialized: the rep rows read one K/V tile.  f32 FMAs on the
// CUDA cores; no tensor cores in this version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_io.cuh"

namespace {

constexpr int kChunk = 32;         // keys per block: one per lane
constexpr int kMaxRep = 16;        // rep * 32 threads per block

// The valid keys of a row are [lo, hi); a chunk is live if it meets them.
// Both passes decide liveness the same way, so the merge reads exactly the
// partials the first pass wrote.
struct Band {
  int lo, hi;
  __device__ Band(int cache_len, int S, int window) {
    hi = min(cache_len, S);
    lo = window > 0 ? max(0, cache_len - window) : 0;
  }
  __device__ bool live(int c) const {
    return c * kChunk < hi && (c + 1) * kChunk > lo;
  }
};

// K rows are padded by 4 floats: 16-byte aligned for vector reads, and the
// 8 keys of a quarter-warp start in 8 different 4-bank groups
template <int DH>
__host__ __device__ constexpr int k_pad() { return DH + 4; }

template <int DH>
constexpr size_t split_smem(int rep) {
  return sizeof(float) * ((size_t)rep * DH + kChunk * k_pad<DH>() +
                          kChunk * DH + (size_t)rep * kChunk);
}

// 4 consecutive floats of shared memory in one 16-byte read
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid (n_chunks, Hkv, B), rep * 32 threads.  Partials: acc (B, Hkv,
// n_chunks, rep, DH), ml (B, Hkv, n_chunks, rep, 2) = (chunk max, chunk sum
// of exp(s - max)).
template <int DH, typename T>
__global__ void decode_split_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ cache_len,
                                    float* __restrict__ part_acc,
                                    float* __restrict__ part_ml, int S,
                                    int Hkv, int rep, int window, float scale) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Band band(cache_len[b], S, window);
  if (!band.live(c)) return;

  constexpr int PAD = k_pad<DH>();
  float* qs = sm;                               // (rep, DH)
  float* ks = qs + rep * DH;                    // (kChunk, PAD)
  float* vs = ks + kChunk * PAD;                // (kChunk, DH)
  float* ps = vs + kChunk * DH;                 // (rep, kChunk)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int k0 = c * kChunk;
  const size_t row0 = ((size_t)b * S + k0) * Hkv + h;   // first key's row
  stage_rows<DH>(qs, DH, q + ((size_t)b * Hkv + h) * rep * DH, DH, rep, rep,
                 tid, nthr);
  stage_rows<DH>(ks, PAD, k + row0 * DH, (size_t)Hkv * DH, kChunk, S - k0,
                 tid, nthr);
  stage_rows<DH>(vs, DH, v + row0 * DH, (size_t)Hkv * DH, kChunk, S - k0,
                 tid, nthr);
  __syncthreads();

  const int r = tid / 32, j = tid % 32;
  const int pos = k0 + j;
  float dot = 0.0f;                             // summed in d order
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    const float4 qv = load4(&qs[r * DH + d]), kv = load4(&ks[j * PAD + d]);
    dot = fmaf(qv.x, kv.x, dot);
    dot = fmaf(qv.y, kv.y, dot);
    dot = fmaf(qv.z, kv.z, dot);
    dot = fmaf(qv.w, kv.w, dot);
  }
  const bool valid = pos >= band.lo && pos < band.hi;
  const float s = valid ? dot * scale : -INFINITY;
  float m = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  // m is finite: a live chunk holds at least one valid key for every row
  const float p = valid ? expf(s - m) : 0.0f;
  float l = p;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  ps[r * kChunk + j] = p;
  __syncthreads();

  const size_t prow = (((size_t)b * Hkv + h) * gridDim.x + c) * rep;
  for (int i = tid; i < rep * DH; i += nthr) {
    const int rr = i / DH, d = i % DH;
    float acc = 0.0f;
#pragma unroll 8
    for (int jj = 0; jj < kChunk; ++jj)
      acc = fmaf(ps[rr * kChunk + jj], vs[jj * DH + d], acc);
    part_acc[(prow + rr) * DH + d] = acc;
  }
  if (j == 0) {
    part_ml[(prow + r) * 2] = m;
    part_ml[(prow + r) * 2 + 1] = l;
  }
}

// grid (rep, Hkv, B), DH threads: one block per query row, thread d merges
// column d.  The live chunks are one contiguous range; every thread reads
// their (m, l) (the same addresses across the block: L1 broadcasts) and
// its column of acc, and the loops carry nothing but the running max and
// sums, so the loads of successive chunks overlap.
template <int DH, typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    const int* __restrict__ cache_len,
                                    T* __restrict__ o, int S, int Hkv,
                                    int rep, int n_chunks, int window) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const Band band(cache_len[b], S, window);
  const int c_lo = max(0, band.lo) / kChunk;
  const int c_hi = min(n_chunks, (band.hi + kChunk - 1) / kChunk);
  const size_t row0 = ((size_t)b * Hkv + h) * n_chunks * rep + r;
  float M = -INFINITY;
#pragma unroll 4
  for (int c = c_lo; c < c_hi; ++c)
    M = fmaxf(M, part_ml[(row0 + (size_t)c * rep) * 2]);
  float L = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int c = c_lo; c < c_hi; ++c) {
    const size_t row = row0 + (size_t)c * rep;
    const float w = expf(part_ml[row * 2] - M);
    L = fmaf(part_ml[row * 2 + 1], w, L);
    acc = fmaf(part_acc[row * DH + d], w, acc);
  }
  // L == 0 only when no chunk is live: a fully masked row gives 0
  const float out = L > 0.0f ? acc / L : 0.0f;
  store(&o[(((size_t)b * Hkv + h) * rep + r) * DH + d], out);
}

template <int DH, typename T>
int launch_split(const void* q, const void* k, const void* v,
                 const int* cache_len, float* part_acc, float* part_ml, int B,
                 int S, int Hkv, int rep, int window, float scale,
                 cudaStream_t st) {
  static bool opted_in = false;   // above 48 KB needs the opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)split_smem<DH>(kMaxRep));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const dim3 grid(n_chunks, Hkv, B);
  decode_split_kernel<DH, T><<<grid, rep * 32, split_smem<DH>(rep), st>>>(
      (const T*)q, (const T*)k, (const T*)v, cache_len, part_acc, part_ml, S,
      Hkv, rep, window, scale);
  return (int)cudaGetLastError();
}

template <int DH, typename T>
int launch_merge(const float* part_acc, const float* part_ml,
                 const int* cache_len, void* o, int B, int S, int Hkv, int rep,
                 int window, cudaStream_t st) {
  const int n_chunks = (S + kChunk - 1) / kChunk;
  decode_merge_kernel<DH, T><<<dim3(rep, Hkv, B), DH, 0, st>>>(
      part_acc, part_ml, cache_len, (T*)o, S, Hkv, rep, n_chunks, window);
  return (int)cudaGetLastError();
}

#define REPRO_DH_SWITCH(Dh, CALL)                     \
  switch (Dh) {                                       \
    case 16: { constexpr int DH = 16; return CALL; }  \
    case 32: { constexpr int DH = 32; return CALL; }  \
    case 64: { constexpr int DH = 64; return CALL; }  \
    case 128: { constexpr int DH = 128; return CALL; } \
    case 256: { constexpr int DH = 256; return CALL; } \
    default: return (int)cudaErrorInvalidValue;       \
  }

template <typename T>
int split_dh(const void* q, const void* k, const void* v, const int* cl,
             float* pa, float* pm, int B, int S, int Hkv, int rep, int Dh,
             int window, float scale, cudaStream_t st) {
  REPRO_DH_SWITCH(Dh, (launch_split<DH, T>(q, k, v, cl, pa, pm, B, S, Hkv,
                                           rep, window, scale, st)))
}

template <typename T>
int merge_dh(const float* pa, const float* pm, const int* cl, void* o, int B,
             int S, int Hkv, int rep, int Dh, int window, cudaStream_t st) {
  REPRO_DH_SWITCH(Dh, (launch_merge<DH, T>(pa, pm, cl, o, B, S, Hkv, rep,
                                           window, st)))
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (B, Hkv*rep, Dh), k/v (B, S, Hkv, Dh) contiguous, cache_len (B,) int32;
// part_acc (B, Hkv, ceil(S/32), rep, Dh) and part_ml (..., rep, 2) f32
// scratch; window <= 0 means none; dtype 0 = f32, 1 = bf16.
int repro_decode_split(const void* q, const void* k, const void* v,
                       const void* cache_len, void* part_acc, void* part_ml,
                       int B, int S, int Hkv, int rep, int Dh, int window,
                       int dtype, float scale, void* stream) {
  if (rep < 1 || rep > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* cl = (const int*)cache_len;
  float* pa = (float*)part_acc;
  float* pm = (float*)part_ml;
  if (dtype == 0)
    return split_dh<float>(q, k, v, cl, pa, pm, B, S, Hkv, rep, Dh, window,
                           scale, st);
  if (dtype == 1)
    return split_dh<__nv_bfloat16>(q, k, v, cl, pa, pm, B, S, Hkv, rep, Dh,
                                   window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// o (B, Hkv*rep, Dh) in q's dtype.
int repro_decode_merge(const void* part_acc, const void* part_ml,
                       const void* cache_len, void* o, int B, int S, int Hkv,
                       int rep, int Dh, int window, int dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* pa = (const float*)part_acc;
  const float* pm = (const float*)part_ml;
  const int* cl = (const int*)cache_len;
  if (dtype == 0)
    return merge_dh<float>(pa, pm, cl, o, B, S, Hkv, rep, Dh, window, st);
  if (dtype == 1)
    return merge_dh<__nv_bfloat16>(pa, pm, cl, o, B, S, Hkv, rep, Dh, window,
                                   st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
