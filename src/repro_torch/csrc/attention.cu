// Flash attention forward for Hopper (sm_90a), in two forms.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/attention/kernel.py  flash_attention  (body _flash_kernel)
// in the two forms the served models call it:
//
//   * the DiT form (flash_fwd_kernel): non-causal, no window, Hq == Hkv,
//     q_offset 0, Sq == Sk, head width 32/64/128;
//   * the LM prefill form (flash_lm_kernel): causal, an optional sliding
//     window (keep k_pos > q_pos - window), GQA (query head h reads KV head
//     h / rep, as the TPU kernel's BlockSpec index map does; the repeat is
//     never materialized), Sq != Sk, q_offset as an int or a device
//     scalar, head width 16/32/64/128/256.
//
// What bounds it on this card: operations.  At the DiT's shapes (S = 256
// tokens, d_head 64) each (batch, head) does 4 S^2 Dh = 16.8 MFLOP on
// 4 S Dh = 64 K elements of q, k, v and o: some 130 operations per bf16
// byte, below the 295 at which the tensor cores outrun memory, so the
// memory bound and the bf16 tensor-core bound are both far below what this
// kernel reaches; it is bound by its own f32 FMA issue rate.  Prefill at
// gemma3-1b's shapes (L = 640 prompt tokens, d_head 256, window 512) is
// the same story with longer rows.  Both forms compute the two products
// with f32 FMAs on the CUDA cores (no mma / wgmma yet): simple and right
// first, tensor cores in a later change.
//
// DiT design.  One block per (q-tile of 64 rows, head, batch); the TPU
// kernel's sequential k-block grid axis, which carried (m, l, acc) in VMEM
// scratch across grid steps, becomes a loop over 32-key tiles inside the
// block.  Four threads share a query row: each keeps the whole q row in
// registers and scores 8 of the tile's 32 keys, the row max and row sum are
// reduced over the four lanes with warp shuffles, the probabilities go
// through shared memory, and each thread accumulates a quarter of the
// output columns (strided, so the four lanes hit four banks).  K and V
// tiles are staged in shared memory as f32, padded to dodge bank
// conflicts.  The online-softmax state (m, l, acc) is f32 whatever the
// input type; inputs are bf16 or f32, the output has the input type.
//
// LM design.  A q row of 256 floats does not fit in registers beside its
// accumulator (the DiT kernel already needs 167 registers at d_head 64),
// and the DiT kernel's static tiles would need ~73 KB at d_head 256, past
// the 48 KB static limit.  So the LM kernel stages the q tile in dynamic
// shared memory too (32 rows; ~100 KB in all at d_head 256, opted in once
// per instance), and eight threads share a row: each scores 4 of the
// tile's 32 keys over the whole row from shared memory and owns Dh / 8
// output columns.  Tiles are staged with 16-byte loads (several in flight
// per thread), and shared memory is read 4 floats at a time: the eight
// lanes of a row read one q address (a broadcast) and eight key rows,
// padded to Dh + 4 floats so they start in eight different 4-bank groups;
// for P V the eight lanes read one contiguous run of a V row, each lane
// owning interleaved 4-column groups.  The LM kernel is always causal and
// takes the window as its one template flag; the DiT kernel is a kernel of
// its own, untouched by either.  The key loop runs only over the tiles that meet the
// block's causal/window band — from the lowest query's window start to
// the highest query's position — which is the TPU kernel's pl.when skip:
// prefill costs O(L min(L, W)), not O(L max_len), although the keys run
// to the end of the preallocated cache.  A row with no visible key so far
// keeps m = -inf and takes its exponentials against 0, so it never turns
// into NaN and a fully masked row gives 0, as the plain version's guard.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_io.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kTPR = 4;        // threads per query row
constexpr int kThreads = kBQ * kTPR;


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

// ---- LM prefill form: causal, optional window, GQA, Dh up to 256 --------

constexpr int kLBQ = 32;                  // query rows per block
constexpr int kLBK = 32;                  // keys per tile
constexpr int kLTPR = 8;                  // threads per query row
constexpr int kLThreads = kLBQ * kLTPR;

// q and k rows are padded by 4 floats: 16-byte aligned for vector reads,
// and the 8 keys a warp reads at once start in 8 different 4-bank groups
template <int DH>
__host__ __device__ constexpr int lm_pad() { return DH + 4; }

template <int DH>
constexpr size_t lm_smem() {
  return sizeof(float) * (kLBQ * lm_pad<DH>() + kLBK * lm_pad<DH>() +
                          kLBK * DH + kLBQ * (kLBK + 1));
}

template <int N> struct FloatN;
template <> struct FloatN<2> { using type = float2; };
template <> struct FloatN<4> { using type = float4; };

// N consecutive floats of shared memory in one read (16- or 8-byte aligned)
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&out)[N]) {
  const typename FloatN<N>::type raw =
      *reinterpret_cast<const typename FloatN<N>::type*>(p);
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int t = 0; t < N; ++t) out[t] = e[t];
}

template <int DH, bool WINDOW, typename T>
__global__ void __launch_bounds__(kLThreads)
flash_lm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                const int* __restrict__ q_off_ptr, int q_off_val, int Sq,
                int Sk, int Hq, int Hkv, int window, float scale) {
  constexpr int PAD = lm_pad<DH>();
  constexpr int NK = kLBK / kLTPR;             // keys scored per thread
  constexpr int VW = DH >= 32 ? 4 : 2;         // output columns per read
  constexpr int NCH = DH / (kLTPR * VW);       // column chunks per thread
  extern __shared__ float sm[];
  float* Qs = sm;                              // (BQ, PAD)
  float* Ks = Qs + kLBQ * PAD;                 // (BK, PAD)
  float* Vs = Ks + kLBK * PAD;                 // (BK, DH)
  float* Ps = Vs + kLBK * DH;                  // (BQ, BK + 1)

  const int tid = threadIdx.x;
  const int r = tid / kLTPR, sub = tid % kLTPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kLBQ, row = q0 + r;
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  const size_t qtok = (size_t)Hq * DH, ktok = (size_t)Hkv * DH;
  const T* kb = k + (size_t)b * Sk * ktok + (size_t)hk * DH;
  const T* vb = v + (size_t)b * Sk * ktok + (size_t)hk * DH;

  stage_rows<DH>(Qs, PAD, q + ((size_t)b * Sq + q0) * qtok + (size_t)h * DH,
                 qtok, kLBQ, Sq - q0, tid, kLThreads);

  // the keys any row of this tile can see: [k_begin, k_end)
  const int lo_q = q_off + q0;
  const int hi_q = q_off + min(q0 + kLBQ, Sq) - 1;
  int k_begin = 0;
  const int k_end = min(Sk, hi_q + 1);
  if (WINDOW) k_begin = max(0, lo_q - window + 1);
  k_begin = k_begin / kLBK * kLBK;
  const int q_pos = q_off + row;

  // thread `sub` owns output columns ch * 8 * VW + sub * VW + t: the 8
  // lanes of a row read one contiguous run of V per chunk
  float acc[NCH][VW];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int t = 0; t < VW; ++t) acc[ch][t] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kLBK) {
    __syncthreads();                           // Qs staged / tile consumed
    stage_rows<DH>(Ks, PAD, kb + (size_t)k0 * ktok, ktok, kLBK, Sk - k0, tid,
                   kLThreads);
    stage_rows<DH>(Vs, DH, vb + (size_t)k0 * ktok, ktok, kLBK, Sk - k0, tid,
                   kLThreads);
    __syncthreads();

    // scores of keys sub + 8 i: dot products summed in d order
    float s[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < DH; d4 += 4) {
      float qv[4];
      load_n<4>(&Qs[r * PAD + d4], qv);
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        float kv[4];
        load_n<4>(&Ks[(sub + kLTPR * i) * PAD + d4], kv);
#pragma unroll
        for (int t = 0; t < 4; ++t) s[i] = fmaf(qv[t], kv[t], s[i]);
      }
    }
    float mloc = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int kp = k0 + sub + kLTPR * i;
      bool ok = kp < Sk && row < Sq && kp <= q_pos;
      if (WINDOW) ok = ok && kp > q_pos - window;
      s[i] = ok ? s[i] * scale : -INFINITY;
      mloc = fmaxf(mloc, s[i]);
    }
#pragma unroll
    for (int off = 1; off < kLTPR; off <<= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
    const float m_new = fmaxf(m, mloc);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    float lsum = 0.0f;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const float p = expf(s[i] - m_use);      // masked keys: exp(-inf) = 0
      Ps[r * (kLBK + 1) + sub + kLTPR * i] = p;
      lsum += p;
    }
#pragma unroll
    for (int off = 1; off < kLTPR; off <<= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const float alpha = expf(m - m_use);       // nothing seen yet: 0
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();                              // Ps row written by this warp
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < VW; ++t) acc[ch][t] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kLBK; ++j) {
      const float p = Ps[r * (kLBK + 1) + j];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float vv[VW];
        load_n<VW>(&Vs[j * DH + (ch * kLTPR + sub) * VW], vv);
#pragma unroll
        for (int t = 0; t < VW; ++t) acc[ch][t] = fmaf(p, vv[t], acc[ch][t]);
      }
    }
  }

  if (row < Sq) {
    const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
    T* ob = o + ((size_t)b * Sq + row) * qtok + (size_t)h * DH;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int t = 0; t < VW; ++t)
        store(&ob[(ch * kLTPR + sub) * VW + t], acc[ch][t] * inv);
  }
}

template <int DH, bool WINDOW, typename T>
int launch_lm(const void* q, const void* k, const void* v, void* o,
              const int* q_off_ptr, int q_off, int B, int Sq, int Sk, int Hq,
              int Hkv, int window, float scale, cudaStream_t s) {
  static bool opted_in = false;   // above 48 KB needs the opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_lm_kernel<DH, WINDOW, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lm_smem<DH>());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((Sq + kLBQ - 1) / kLBQ, Hq, B);
  flash_lm_kernel<DH, WINDOW, T><<<grid, kLThreads, lm_smem<DH>(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, q_off_ptr, q_off, Sq, Sk,
      Hq, Hkv, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool WINDOW>
int launch_lm_dh(const void* q, const void* k, const void* v, void* o,
                 const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                 int Hq, int Hkv, int Dh, int window, float scale,
                 cudaStream_t s) {
#define REPRO_LM(DH)                                                        \
  case DH:                                                                  \
    return launch_lm<DH, WINDOW, T>(q, k, v, o, q_off_ptr, q_off, B, Sq, Sk, \
                                    Hq, Hkv, window, scale, s);
  switch (Dh) {
    REPRO_LM(16)
    REPRO_LM(32)
    REPRO_LM(64)
    REPRO_LM(128)
    REPRO_LM(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LM
}

template <typename T>
int launch_lm_form(const void* q, const void* k, const void* v, void* o,
                   const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                   int Hq, int Hkv, int Dh, int window, float scale,
                   cudaStream_t s) {
  if (window > 0)
    return launch_lm_dh<T, true>(q, k, v, o, q_off_ptr, q_off, B, Sq, Sk, Hq,
                                 Hkv, Dh, window, scale, s);
  return launch_lm_dh<T, false>(q, k, v, o, q_off_ptr, q_off, B, Sq, Sk, Hq,
                                Hkv, Dh, 0, scale, s);
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

// LM prefill form, causal.  q, o: (B, Sq, Hq, Dh); k, v: (B, Sk, Hkv, Dh),
// contiguous, Hkv dividing Hq; q_offset read from the device scalar
// q_off_ptr when it is not null, else q_off; window <= 0 means none;
// dtype 0 = f32, 1 = bf16.
int repro_flash_attention_lm(const void* q, const void* k, const void* v,
                             void* o, const void* q_off_ptr, int q_off, int B,
                             int Sq, int Sk, int Hq, int Hkv, int Dh,
                             int window, int dtype, float scale,
                             void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qp = (const int*)q_off_ptr;
  if (dtype == 0)
    return launch_lm_form<float>(q, k, v, o, qp, q_off, B, Sq, Sk, Hq, Hkv,
                                 Dh, window, scale, s);
  if (dtype == 1)
    return launch_lm_form<__nv_bfloat16>(q, k, v, o, qp, q_off, B, Sq, Sk,
                                         Hq, Hkv, Dh, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
