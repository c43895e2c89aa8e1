// Flash attention forward, non-causal, Hq == Hkv (the DiT form), for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/attention/kernel.py  flash_attention  (body _flash_kernel)
// in the form every DiT layer calls it: no causal or window mask, no GQA,
// q_offset 0.  The causal/window/GQA form is for LM prefill and is not
// ported here.
//
// What bounds it on this card: operations.  At the DiT's shapes (S = 256
// tokens, d_head 64) each (batch, head) does 4 S^2 Dh = 16.8 MFLOP on
// 4 S Dh = 64 K elements of q, k, v and o: some 130 operations per bf16
// byte, below the 295 at which the tensor cores outrun memory, so the
// memory bound and the bf16 tensor-core bound are both far below what this
// kernel reaches; it is bound by its own f32 FMA issue rate.  This first
// version computes both products with f32 FMAs on the CUDA cores (no mma /
// wgmma yet): simple and right first, tensor cores in a later change.
//
// Design.  One block per (q-tile of 64 rows, head, batch); the TPU kernel's
// sequential k-block grid axis, which carried (m, l, acc) in VMEM scratch
// across grid steps, becomes a loop over 32-key tiles inside the block.
// Four threads share a query row: each keeps the whole q row in registers
// and scores 8 of the tile's 32 keys, the row max and row sum are reduced
// over the four lanes with warp shuffles, the probabilities go through
// shared memory, and each thread accumulates a quarter of the output
// columns (strided, so the four lanes hit four banks).  K and V tiles are
// staged in shared memory as f32, padded to dodge bank conflicts.  The
// online-softmax state (m, l, acc) is f32 whatever the input type; inputs
// are bf16 or f32, the output has the input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kTPR = 4;        // threads per query row
constexpr int kThreads = kBQ * kTPR;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 float scale) {
  __shared__ float Ks[kBK][DH + 1];
  __shared__ float Vs[kBK][DH];
  __shared__ float Ps[kBQ][kBK + 1];

  const int tid = threadIdx.x;
  const int r = tid / kTPR, sub = tid % kTPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kBQ + r;
  const size_t tok = (size_t)H * DH;               // stride between tokens
  const size_t base = (size_t)b * S * tok + (size_t)h * DH;

  float qr[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i)
    qr[i] = row < S ? to_f32(q[base + (size_t)row * tok + i]) : 0.0f;

  constexpr int NC = DH / kTPR;                    // output columns per thread
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();                               // previous tile consumed
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int j = idx / DH, dd = idx % DH;
      const bool ok = k0 + j < S;
      const size_t g = base + (size_t)(k0 + j) * tok + dd;
      Ks[j][dd] = ok ? to_f32(k[g]) : 0.0f;
      Vs[j][dd] = ok ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[kBK / kTPR];
    float mloc = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / kTPR; ++i) {
      const int j = sub + kTPR * i;
      float dot = 0.0f;
#pragma unroll
      for (int dd = 0; dd < DH; ++dd) dot = fmaf(qr[dd], Ks[j][dd], dot);
      s[i] = k0 + j < S ? dot * scale : -INFINITY;
      mloc = fmaxf(mloc, s[i]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    float lsum = 0.0f;
#pragma unroll
    for (int i = 0; i < kBK / kTPR; ++i) {
      const float p = expf(s[i] - m_new);         // masked keys: exp(-inf) = 0
      Ps[r][sub + kTPR * i] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float alpha = expf(m - m_new);           // first tile: exp(-inf) = 0
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();                                  // Ps row written by this warp
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float pv = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK; ++j) pv = fmaf(Ps[r][j], Vs[j][sub + kTPR * c], pv);
      acc[c] = fmaf(acc[c], alpha, pv);
    }
  }

  if (row < S) {
    const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(&o[base + (size_t)row * tok + sub + kTPR * c], acc[c] * inv);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, float scale, cudaStream_t s) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DH, T><<<grid, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int Dh, float scale, cudaStream_t s) {
  switch (Dh) {
    case 32: return launch<32, T>(q, k, v, o, B, S, H, scale, s);
    case 64: return launch<64, T>(q, k, v, o, B, S, H, scale, s);
    case 128: return launch<128, T>(q, k, v, o, B, S, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v, o: (B, S, H, Dh) contiguous; dtype 0 = f32, 1 = bf16
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          int B, int S, int H, int Dh, int dtype, float scale,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dh<float>(q, k, v, o, B, S, H, Dh, scale, s);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, Dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
