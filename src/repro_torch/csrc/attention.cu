// Flash attention forward for Hopper (sm_90a), in two forms.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/attention/kernel.py  flash_attention  (body _flash_kernel)
// in the forms the served models call it:
//
//   * the DiT form: non-causal, no window, Hq == Hkv, q_offset 0, Sq ==
//     Sk, head width 32/64/128 (also whisper's encoder, Sq = Sk = 1500);
//   * the general form, causal (LM prefill) or not (the encoder-decoder's
//     cross-attention: decoder queries over encoder keys, Sq != Sk): an
//     optional sliding window (keep k_pos > q_pos - window), GQA (query
//     head h reads KV head h / rep, as the TPU kernel's BlockSpec index
//     map does; the repeat is never materialized), Sq != Sk, q_offset as
//     an int or a device scalar, head width 16/32/64/80/128/256.  Causality
//     is a template flag of each tile: the non-causal instances drop the
//     diagonal from the band and the mask, and keep the key tail's mask
//     (k_pos < Sk) on the last tile, which a ragged Sk (1500 = 23 * 64 +
//     28) needs where no causal mask hides the tail.
//
// Every served path calls it in bf16, on the tensor cores:
// flash_dit_wgmma_kernel and flash_lm_wgmma_kernel (one warpgroup tile
// core) at head width 64/128/256, flash_dit_mma_kernel and
// flash_lm_mma_kernel (mma.sync) at 16/32, whose rows are narrower than a
// 128-byte swizzled tile, and at 80 (zamba2-2.7b's shared block), whose
// 160-byte rows fit no 128-byte swizzle atom.  f32 inputs (reduced
// configs, tests) run the
// CUDA-core kernels of the first port, flash_fwd_kernel and
// flash_lm_kernel, described at the end.
//
// What bounds it on this card: bytes.  At the DiT's (B, 256, 12, 64) each
// (batch, head) does 4 S^2 Dh = 16.8 MFLOP on 4 S Dh 2-byte elements of
// q, k, v and o, 128 operations a byte, under the 295 at which the bf16
// tensor cores outrun memory: path A's batch 64 moves 100.7 MB (30 us at
// 3.35 TB/s) for 12.9 GFLOP (13 us at 989 TFLOP/s), the engine's batch 4
// 6.3 MB (1.9 us).  gemma3-1b's prefill (q (1, 640, 4, 256) over a
// (1, 1024, 1, 256) cache, window 512 or global) moves 3.3 MB (1.0 us) for
// 0.8 GFLOP.  So the design keeps the bytes at their minimum and the
// operations on the tensor cores, off the f32 FMAs that bound the first
// port (1.24 ms at batch 64).
//
// Why wgmma.  A first design on mma.sync m16n8k16 (ldmatrix-fed, P in
// registers, the split below) was right but slower than SDPA at batch 64:
// with the P split a 16-row warp issues 96 HMMA per 64-key tile, legacy
// mma.sync runs well below the card's bf16 tensor rate, and ablations on
// the card showed the products alone taking about as long as the copies,
// one after the other.  wgmma runs at the full rate, asynchronously, and
// reads Q, K and V straight from shared memory.
//
// Warpgroup design.  A block holds WG warpgroups of 64 query rows of one
// (batch, head); the TPU kernel's sequential k-block grid axis becomes a
// loop over 64-key tiles inside the block, each K / V tile copied once for
// the whole block.  Q, K and V stay bf16 in shared memory, in 64-column
// blocks of 64 rows x 128 bytes with the 128-byte swizzle that wgmma's
// descriptors read, copied 16 bytes a thread with cp.async into STAGES
// stages, later tiles in flight while this one is computed.  S = Q K^T is
// Dh / 16 m64n64k16 products from shared memory into f32 registers; row
// max, exp2 (log2(e) / sqrt(Dh) folded in) and row sum run on those
// registers, reduced over the 4 lanes of a quad with shuffles; the
// online-softmax state (m, l, acc) is f32.  P never goes to shared memory:
// the accumulator layout of S is the register A-operand layout of P V,
// which is 8 m64nDhk16 products against V read transposed.  P is split P
// = P_hi + P_lo, both bf16, and both halves are multiplied into the same
// f32 accumulator: one bf16 P (a relative error of 2^-9 a weight) puts
// ~1e-4 into o, which near zero is some 13 bf16 ulp of max|o| / 1024; the
// split leaves 2^-17 a weight, and o is rounded once from f32, as the
// plain version rounds it.  The output
// goes back through the warp's rows of the Q tile for 16-byte stores.
// Rows whose base is not 16-byte aligned (a view into a larger buffer)
// are copied element by element instead of by cp.async; the arithmetic is
// the same.  The DiT runs two warpgroups a block (128 rows, so K and V
// cross L2 half as often as with 64) and three stages; prefill one
// warpgroup and two stages (161 KB of shared memory at d_head 256, opted
// in once per instance).
//
// The LM form on either core.  The key loop runs only over the tiles that
// meet the block's causal/window band -- from the lowest query's window
// start to the highest query's position -- which is the TPU kernel's
// pl.when skip: prefill costs O(L min(L, W)), not O(L max_len), although
// the keys run to the end of the preallocated cache.  Tiles wholly inside
// the band skip the element mask; tiles that cross the diagonal, the
// window edge or the end of the keys apply it.  A row with no visible key
// so far keeps m = -inf and takes its exponentials against 0, so it never
// turns into NaN, and a fully masked row gives 0, as the plain version's
// guard.  A non-causal tile's band runs to Sk (only a window cuts its
// start).  whisper-base's cross-attention is bound by bytes: prefill
// (G, L, 8, 64) over (G, 1500, 8, 64) bf16 reads 1500 keys a row group
// for L queries (L = 64: 12.3 MB, 3.7 us at 3.35 TB/s), and its decode
// step, one query over f32 keys (the f32 memory pool: the CUDA-core
// kernel, q upcast by the wrapper), 24.6 MB at batch 4 (7.3 us).  There
// one of a block's 32 rows is live: a simple kernel that is right, not a
// fast one, at Sq = 1.
//
// f32 CUDA-core kernels.  DiT: one block per (q-tile of 64 rows, head,
// batch), four threads a query row, each holding the q row in registers
// and scoring 8 of a 32-key tile, K and V staged as f32 in padded shared
// memory, P through shared memory.  LM: the q tile staged in dynamic
// shared memory too (32 rows), eight threads a row, 16-byte staging, the
// same band skip and guards as above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"
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

template <int DH, bool CAUSAL, bool WINDOW, typename T>
__global__ void __launch_bounds__(kLThreads)
flash_lm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                const int* __restrict__ q_off_ptr, int q_off_val, int Sq,
                int Sk, int Hq, int Hkv, int window, float scale) {
  constexpr int PAD = lm_pad<DH>();
  constexpr int NK = kLBK / kLTPR;             // keys scored per thread
  // output columns per read: 4 where the 8 lanes of a row tile DH by 32,
  // else 2 (16; 80 = 5 chunks of 8 x 2)
  constexpr int VW = DH % 32 == 0 ? 4 : 2;
  constexpr int NCH = DH / (kLTPR * VW);       // column chunks per thread
  static_assert(DH % (kLTPR * VW) == 0, "the row's lanes tile DH");
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
  const int k_end = CAUSAL ? min(Sk, hi_q + 1) : Sk;
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
      bool ok = kp < Sk && row < Sq;
      if (CAUSAL) ok = ok && kp <= q_pos;
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

template <int DH, bool CAUSAL, bool WINDOW, typename T>
int launch_lm(const void* q, const void* k, const void* v, void* o,
              const int* q_off_ptr, int q_off, int B, int Sq, int Sk, int Hq,
              int Hkv, int window, float scale, cudaStream_t s) {
  static bool opted_in = false;   // above 48 KB needs the opt-in, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_lm_kernel<DH, CAUSAL, WINDOW, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lm_smem<DH>());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((Sq + kLBQ - 1) / kLBQ, Hq, B);
  flash_lm_kernel<DH, CAUSAL, WINDOW, T><<<grid, kLThreads, lm_smem<DH>(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, q_off_ptr, q_off, Sq, Sk,
      Hq, Hkv, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL, bool WINDOW>
int launch_lm_dh(const void* q, const void* k, const void* v, void* o,
                 const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                 int Hq, int Hkv, int Dh, int window, float scale,
                 cudaStream_t s) {
#define REPRO_LM(DH)                                                        \
  case DH:                                                                  \
    return launch_lm<DH, CAUSAL, WINDOW, T>(q, k, v, o, q_off_ptr, q_off, B, \
                                            Sq, Sk, Hq, Hkv, window, scale, s);
  switch (Dh) {
    REPRO_LM(16)
    REPRO_LM(32)
    REPRO_LM(64)
    REPRO_LM(80)
    REPRO_LM(128)
    REPRO_LM(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LM
}

template <typename T, bool CAUSAL>
int launch_lm_form(const void* q, const void* k, const void* v, void* o,
                   const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                   int Hq, int Hkv, int Dh, int window, float scale,
                   cudaStream_t s) {
  if (window > 0)
    return launch_lm_dh<T, CAUSAL, true>(q, k, v, o, q_off_ptr, q_off, B, Sq,
                                         Sk, Hq, Hkv, Dh, window, scale, s);
  return launch_lm_dh<T, CAUSAL, false>(q, k, v, o, q_off_ptr, q_off, B, Sq,
                                        Sk, Hq, Hkv, Dh, 0, scale, s);
}

// ---- d_head 16 / 32 / 80 on the tensor cores (mma.sync) -----------------
//
// Rows of 32 or 64 bytes, narrower than wgmma's 128-byte-swizzled tiles,
// or of 160 bytes (d_head 80), which fit no 128-byte swizzle atom: each
// warp owns 16 query rows and issues its own m16n8k16 products.  At 80,
// Q K^T is 5 k-steps of 16 and P V 10 n-tiles of 8, 40 f32 accumulators a
// thread for O; the rows lie 176 bytes apart in shared memory (16 bytes
// of padding), so the 8 rows an ldmatrix reads start in 8 different
// 16-byte bank groups; the Q tile and the two stages of K and V take 55
// KB, above the 48 KB a launch gets without the opt-in.  The 32-byte
// swizzle a wgmma tile of 160-byte rows could use was not taken: this
// tile is the one that already serves 16 and 32, and the shapes it runs
// at (zamba2's prefill, L <= 640 queries over their own keys) move a few
// MB, bound by bytes, not by the tensor cores' rate.

using bf16 = __nv_bfloat16;

constexpr int kMBQ = 64;                  // query rows per block
constexpr int kMBK = 64;                  // keys per tile
constexpr int kMThreads = 32 * kMBQ / 16; // a warp per 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row stride in elements: 16 bytes of padding per row
template <int DH>
__host__ __device__ constexpr int mma_lds() { return DH + 8; }

// the Q tile, then two stages of K and two of V
template <int DH>
constexpr size_t mma_smem() {
  return sizeof(bf16) * (kMBQ + 4 * kMBK) * mma_lds<DH>();
}

// 64 rows of DH (row r at src + r * stride; rows at or past `valid` are
// zero) into shared memory at stride mma_lds, 16 bytes a copy: cp.async
// when the rows are 16-byte aligned, plain loads and stores otherwise
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int valid,
                                          bool aligned, int tid) {
  constexpr int CH = DH / 8;                   // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < kMBK * CH / kMThreads; ++j) {
    const int i = tid + j * kMThreads;
    const int r = i / CH, c = i % CH * 8;
    bf16* d = dst + r * mma_lds<DH>() + c;
    const bf16* s = src + (size_t)r * stride + c;
    if (aligned) {
      cp_async_16(d, r < valid ? s : src, r < valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = r < valid ? s[e] : __float2bfloat16_rn(0.0f);
    }
  }
}

// One block: query rows [q0, q0 + 64) of head h, batch b, against KV head
// h / (Hq / Hkv).  q, o: (B, Sq, Hq, DH); k, v: (B, Sk, Hkv, DH).
template <int DH, bool CAUSAL, bool WINDOW>
__device__ __forceinline__ void flash_mma_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int q_off, int Sq,
    int Sk, int Hq, int Hkv, int window, float scale_log2, bool aligned) {
  constexpr int LDS = mma_lds<DH>();
  constexpr int KD = DH / 16;                  // k-steps of Q K^T
  constexpr int NO = DH / 8;                   // 8-column tiles of O
  constexpr int NS = kMBK / 8;                 // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kMBQ * LDS;                  // two stages
  bf16* Vs = Ks + 2 * kMBK * LDS;              // two stages

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kMBQ;
  const size_t qtok = (size_t)Hq * DH, ktok = (size_t)Hkv * DH;
  const size_t kv0 = (size_t)b * Sk * ktok + (size_t)(h / (Hq / Hkv)) * DH;
  const bf16* kb = k + kv0;
  const bf16* vb = v + kv0;

  // the keys any row of this tile can see: [k_begin, k_end)
  const int lo_q = q_off + q0;
  const int hi_q = q_off + min(q0 + kMBQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (CAUSAL) k_end = min(Sk, hi_q + 1);
  if (WINDOW) k_begin = max(0, lo_q - window + 1) / kMBK * kMBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kMBK - 1) / kMBK
                                      : 0;

  load_tile<DH>(Qs, q + ((size_t)b * Sq + q0) * qtok + (size_t)h * DH, qtok,
                Sq - q0, aligned, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DH>(Ks, kb + (size_t)k_begin * ktok, ktok, Sk - k_begin,
                  aligned, tid);
    load_tile<DH>(Vs, vb + (size_t)k_begin * ktok, ktok, Sk - k_begin,
                  aligned, tid);
  }
  cp_async_commit();

  // this lane's rows are r0 = 16 warp + g and r0 + 8; ldmatrix addresses:
  // Q (A operand) row lane % 16, column 8 (lane / 16); K (B operand of two
  // 8-key tiles) key lane % 8 + 8 (lane / 16), column 8 ((lane / 8) % 2);
  // V (transposed B operand of two 8-column tiles) key lane % 8 + 8
  // ((lane / 8) % 2), column 8 (lane / 16)
  const int qp0 = lo_q + warp * 16 + g, qp1 = qp0 + 8;
  const bf16* q_ld = Qs + (warp * 16 + lane % 16) * LDS + lane / 16 * 8;
  const int k_ld = (lane % 8 + lane / 16 * 8) * LDS + (lane / 8 % 2) * 8;
  const int v_ld = (lane % 8 + lane / 8 % 2 * 8) * LDS + lane / 16 * 8;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  uint32_t qf[KD][4];                          // Q's A fragments

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kMBK;
    const bf16* Kt = Ks + (it & 1) * kMBK * LDS;
    const bf16* Vt = Vs + (it & 1) * kMBK * LDS;
    if (it + 1 < n_tiles) {                    // next tile, other stage
      const int k1 = k0 + kMBK, nxt = ((it + 1) & 1) * kMBK * LDS;
      load_tile<DH>(Ks + nxt, kb + (size_t)k1 * ktok, ktok, Sk - k1,
                    aligned, tid);
      load_tile<DH>(Vs + nxt, vb + (size_t)k1 * ktok, ktok, Sk - k1,
                    aligned, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                           // this tile (and Q) landed
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_ld + kk * 16);
    }

    // S = Q K^T: 16 rows x 64 keys per warp, f32
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + k_ld + np * 16 * LDS + kk * 16);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // the element mask, only on tiles that cross an edge of the band
    const bool edge = k0 + kMBK > Sk || (CAUSAL && k0 + kMBK - 1 > lo_q) ||
                      (WINDOW && k0 <= hi_q - window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + n * 8 + 2 * t + (i & 1);
          const int qp = i < 2 ? qp0 : qp1;
          bool ok = kp < Sk;
          if (CAUSAL) ok = ok && kp <= qp;
          if (WINDOW) ok = ok && kp > qp - window;
          if (!ok) s[n][i] = -INFINITY;
        }
    }

    // online softmax over rows g (i = 0, 1) and g + 8 (i = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mu = mx == -INFINITY ? 0.0f : mx * scale_log2;
      const float alpha = exp2f(m[r] * scale_log2 - mu);  // nothing seen: 0
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 2 * r; j < 2 * r + 2; ++j) {
          s[n][j] = exp2f(fmaf(s[n][j], scale_log2, -mu));  // masked: 0
          sum += s[n][j];
        }
      l[r] = l[r] * alpha + sum;               // this lane's share of the row
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P = P_hi + P_lo from the score registers, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + v_ld + kk * 16 * LDS + dp * 16);
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();                           // stage free for tile it + 2
  }
  cp_async_wait<0>();                          // (no tile: Q's copy)
  __syncthreads();

  // o = acc / l, through the warp's own rows of Qs, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
  }
  bf16* Os = Qs + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(&Os[g * LDS + n * 8 + 2 * t]) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&Os[(g + 8) * LDS + n * 8 + 2 * t]) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CH = DH / 8;
#pragma unroll
  for (int j = 0; j < 16 * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH * 8;
    const int row = q0 + warp * 16 + r;
    if (row < Sq) {
      bf16* dst = o + ((size_t)b * Sq + row) * qtok + (size_t)h * DH + c;
      const bf16* src = Os + r * LDS + c;
      if (aligned) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMThreads, 4)
flash_dit_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                     int H, float scale_log2, bool aligned) {
  flash_mma_tile<DH, false, false>(q, k, v, o, 0, S, S, H, H, 0, scale_log2,
                                   aligned);
}

template <int DH, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(kMThreads, 4)
flash_lm_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    const int* __restrict__ q_off_ptr, int q_off_val, int Sq,
                    int Sk, int Hq, int Hkv, int window, float scale_log2,
                    bool aligned) {
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  flash_mma_tile<DH, CAUSAL, WINDOW>(q, k, v, o, q_off, Sq, Sk, Hq, Hkv,
                                     window, scale_log2, aligned);
}

// ---- d_head 64 / 128 / 256 on the warpgroup tensor cores (wgmma) --------
//
// WG warpgroups a block, 64 query rows each; K / V tiles of 64 keys in
// STAGES stages shared by them.  A 64-row tile of DH columns lies in shared
// memory as DH / 64 blocks of 64 columns, each 64 rows of 128 bytes,
// 128-byte swizzled (the layout wgmma's descriptors read).  S = Q K^T is
// DH / 16 m64n64k16 products from shared memory; O += P V is 8 m64nDHk16
// products (P_hi and P_lo of 4 16-key steps, from registers) against V
// read transposed.
template <int DH, int WG, int STAGES, int MIN_BLOCKS>
struct WgCfg {
  static constexpr int kDH = DH, kWG = WG, kStages = STAGES;
  static constexpr int kMinBlocks = MIN_BLOCKS;
  static constexpr int kThreads = 128 * WG, kBQ = 64 * WG;
  static constexpr int kBlock = 64 * 128;      // bytes of a 64 x 64 block
  static constexpr int kTile = kBlock * DH / 64;  // a 64-row tile
  // 1024 bytes to align the tiles, Q tiles, then K and V stages
  static constexpr size_t kSmem = 1024 + (size_t)kTile * (WG + 2 * STAGES);
};

// the instances the forms launch, by d_head
template <int DH> struct DitWgCfg { using type = WgCfg<DH, 1, 2, 1>; };
template <> struct DitWgCfg<64> { using type = WgCfg<64, 2, 3, 2>; };
template <int DH> struct LmWgCfg { using type = WgCfg<DH, 1, 2, 1>; };

// byte of element chunk C (8 bf16) of row r in a 64-row swizzled tile
__device__ __forceinline__ int sw128(int r, int C) {
  return (C / 8) * (64 * 128) + r * 128 + (((C % 8) ^ (r & 7)) << 4);
}

// rows [0, ROWS) of DH bf16 (row r at src + r * stride; rows at or past
// `valid` zero) into ROWS / 64 swizzled tiles; cp.async when aligned, else
// loads and stores
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_sw128(unsigned char* dst,
                                           const bf16* src, size_t stride,
                                           int valid, bool aligned,
                                           int tid) {
  constexpr int CH = DH / 8;                   // 16-byte chunks per row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CH, c = i % CH;
    unsigned char* d = dst + r / 64 * (64 * 2 * DH) + sw128(r % 64, c);
    const bf16* s = src + (size_t)r * stride + c * 8;
    if (aligned) {
      cp_async_16(d, r < valid ? s : src, r < valid);
    } else {
      bf16* e = reinterpret_cast<bf16*>(d);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        e[x] = r < valid ? s[x] : __float2bfloat16_rn(0.0f);
    }
  }
}

// the compiler may neither move uses of these registers across this point
// nor reuse them for other values: an asynchronous wgmma owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// One block: query rows [q0, q0 + 64 WG) of head h, batch b, against KV
// head h / (Hq / Hkv).  q, o: (B, Sq, Hq, DH); k, v: (B, Sk, Hkv, DH).
template <class C, bool CAUSAL, bool WINDOW>
__device__ __forceinline__ void flash_wgmma_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int q_off, int Sq,
    int Sk, int Hq, int Hkv, int window, float scale_log2, bool aligned) {
  constexpr int DH = C::kDH, NST = C::kStages, NT = C::kThreads;
  constexpr int BQ = C::kBQ, TILE = C::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* Ks = Qs + C::kWG * TILE;      // NST stages
  unsigned char* Vs = Ks + NST * TILE;         // NST stages

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wr = warp % 4 * 16;  // warpgroup, warp's row
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const size_t qtok = (size_t)Hq * DH, ktok = (size_t)Hkv * DH;
  const size_t kv0 = (size_t)b * Sk * ktok + (size_t)(h / (Hq / Hkv)) * DH;

  // the keys any row of this tile can see: [k_begin, k_end)
  const int lo_q = q_off + q0;
  const int hi_q = q_off + min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (CAUSAL) k_end = min(Sk, hi_q + 1);
  if (WINDOW) k_begin = max(0, lo_q - window + 1) / kMBK * kMBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kMBK - 1) / kMBK
                                      : 0;

  // one commit group per tile (Q rides with tile 0), empty past the end
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int kj = k_begin + j * kMBK;
      const size_t at = kv0 + (size_t)kj * ktok;
      load_sw128<DH, kMBK, NT>(Ks + j % NST * TILE, k + at, ktok, Sk - kj,
                               aligned, tid);
      load_sw128<DH, kMBK, NT>(Vs + j % NST * TILE, v + at, ktok, Sk - kj,
                               aligned, tid);
    }
    cp_async_commit();
  };
  load_sw128<DH, BQ, NT>(Qs, q + ((size_t)b * Sq + q0) * qtok +
                         (size_t)h * DH, qtok, Sq - q0, aligned, tid);
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) load_kv(j);

  const uint64_t dq = wgmma_desc(Qs + wg * TILE);
  const int qp0 = lo_q + wg * 64 + wr + g;     // and qp0 + 8
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kMBK;
    load_kv(it + NST - 1);                     // into the stage freed last
    cp_async_wait<NST - 1>();
    fence_async_smem();                        // tile it visible to wgmma
    __syncthreads();
    const uint64_t dk = wgmma_desc(Ks + it % NST * TILE);
    const uint64_t dv = wgmma_desc_mn(Vs + it % NST * TILE, C::kBlock);

    // S = Q K^T, 64 rows x 64 keys a warpgroup: k-step kk reads 32 bytes
    // at column block kk / 4, byte 32 (kk % 4) of each row (descriptor
    // addresses count 16 bytes)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = kk / 4 * (C::kBlock / 16) + kk % 4 * 2;
      wgmma_ss(s, dq + off, dk + off, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the element mask, only on tiles that cross an edge of the band
    const bool edge = k0 + kMBK > Sk || (CAUSAL && k0 + kMBK - 1 > lo_q) ||
                      (WINDOW && k0 <= hi_q - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + i / 4 * 8 + 2 * t + (i & 1);
        const int qp = qp0 + (i & 2 ? 8 : 0);
        bool ok = kp < Sk;
        if (CAUSAL) ok = ok && kp <= qp;
        if (WINDOW) ok = ok && kp > qp - window;
        if (!ok) s[i] = -INFINITY;
      }
    }

    // online softmax over rows g (i % 4 = 0, 1) and g + 8 (i % 4 = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mu = mx == -INFINITY ? 0.0f : mx * scale_log2;
      const float alpha = exp2f(m[r] * scale_log2 - mu);  // nothing seen: 0
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 4 * n + 2 * r; j < 4 * n + 2 * r + 2; ++j) {
          s[j] = exp2f(fmaf(s[j], scale_log2, -mu));       // masked: 0
          sum += s[j];
        }
      l[r] = l[r] * alpha + sum;               // this lane's share of the row
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        acc[4 * n + 2 * r] *= alpha;
        acc[4 * n + 2 * r + 1] *= alpha;
      }
    }

    // O += P V: P = P_hi + P_lo in the A-fragment layout, 16 keys a step
    // (V's 16 rows of step kk start 2048 bytes further)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* e = &s[8 * kk + 4 * (i / 2) + 2 * (i % 2)];
        split_bf16(e[0], e[1], ph[kk][i], pl[kk][i]);
      }
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DH>(acc, ph[kk], dv + 2048 / 16 * kk);
      wgmma_rs<DH>(acc, pl[kk], dv + 2048 / 16 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    __syncthreads();                           // its stage free again
  }
  cp_async_wait<0>();                          // (no tile: Q's copy)
  __syncthreads();

  // o = acc / l, through the warp's own rows of its Q tile (same layout),
  // then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
  }
  unsigned char* Ot = Qs + wg * TILE;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(Ot + sw128(wr + g + 8 * r, n) + 4 * t) =
          pack_bf16(acc[4 * n + 2 * r] * inv[r],
                    acc[4 * n + 2 * r + 1] * inv[r]);
  __syncwarp();
  constexpr int CH = DH / 8;
#pragma unroll
  for (int j = 0; j < 16 * CH / 32; ++j) {
    const int i = lane + 32 * j, row = wr + i / CH, c = i % CH;
    const int qrow = q0 + wg * 64 + row;
    if (qrow < Sq) {
      bf16* dst = o + ((size_t)b * Sq + qrow) * qtok + (size_t)h * DH + c * 8;
      const unsigned char* src = Ot + sw128(row, c);
      if (aligned) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x)
          dst[x] = reinterpret_cast<const bf16*>(src)[x];
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(DitWgCfg<DH>::type::kThreads,
                                  DitWgCfg<DH>::type::kMinBlocks)
flash_dit_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int S, int H, float scale_log2, bool aligned) {
  flash_wgmma_tile<typename DitWgCfg<DH>::type, false, false>(
      q, k, v, o, 0, S, S, H, H, 0, scale_log2, aligned);
}

template <int DH, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(LmWgCfg<DH>::type::kThreads,
                                  LmWgCfg<DH>::type::kMinBlocks)
flash_lm_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      const int* __restrict__ q_off_ptr, int q_off_val,
                      int Sq, int Sk, int Hq, int Hkv, int window,
                      float scale_log2, bool aligned) {
  const int q_off = q_off_ptr != nullptr ? *q_off_ptr : q_off_val;
  flash_wgmma_tile<typename LmWgCfg<DH>::type, CAUSAL, WINDOW>(
      q, k, v, o, q_off, Sq, Sk, Hq, Hkv, window, scale_log2, aligned);
}

// above 48 KB of dynamic shared memory needs the opt-in, once an instance
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((size_t)a | (size_t)b | (size_t)c | (size_t)d) & 15) == 0;
}

template <int DH>
int launch_dit_wgmma(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, float scale, cudaStream_t s) {
  using C = typename DitWgCfg<DH>::type;
  static bool opted_in = false;
  const cudaError_t e = opt_in(flash_dit_wgmma_kernel<DH>, C::kSmem,
                               opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + C::kBQ - 1) / C::kBQ, H, B);
  flash_dit_wgmma_kernel<DH><<<grid, C::kThreads, C::kSmem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H,
      scale * kLog2e, aligned16(q, k, v, o));
  return (int)cudaGetLastError();
}

template <int DH, bool CAUSAL, bool WINDOW>
int launch_lm_wgmma(const void* q, const void* k, const void* v, void* o,
                    const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                    int Hq, int Hkv, int window, float scale,
                    cudaStream_t s) {
  using C = typename LmWgCfg<DH>::type;
  static bool opted_in = false;
  const cudaError_t e = opt_in(flash_lm_wgmma_kernel<DH, CAUSAL, WINDOW>,
                               C::kSmem, opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + C::kBQ - 1) / C::kBQ, Hq, B);
  flash_lm_wgmma_kernel<DH, CAUSAL, WINDOW><<<grid, C::kThreads, C::kSmem,
                                              s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, q_off_ptr,
      q_off, Sq, Sk, Hq, Hkv, window, scale * kLog2e, aligned16(q, k, v, o));
  return (int)cudaGetLastError();
}

// the DiT form's d_head 32: under 48 KB of shared memory, no opt-in
static_assert(mma_smem<32>() <= 48 * 1024, "mma.sync tiles fit 48 KB");

template <int DH>
int launch_dit_mma(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, float scale, cudaStream_t s) {
  const dim3 grid((S + kMBQ - 1) / kMBQ, H, B);
  flash_dit_mma_kernel<DH><<<grid, kMThreads, mma_smem<DH>(), s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H,
      scale * kLog2e, aligned16(q, k, v, o));
  return (int)cudaGetLastError();
}

template <int DH, bool CAUSAL, bool WINDOW>
int launch_lm_mma(const void* q, const void* k, const void* v, void* o,
                  const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                  int Hq, int Hkv, int window, float scale, cudaStream_t s) {
  if (mma_smem<DH>() > 48 * 1024) {          // d_head 80: the opt-in, once
    static bool opted_in = false;
    const cudaError_t e = opt_in(flash_lm_mma_kernel<DH, CAUSAL, WINDOW>,
                                 mma_smem<DH>(), opted_in);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kMBQ - 1) / kMBQ, Hq, B);
  flash_lm_mma_kernel<DH, CAUSAL, WINDOW><<<grid, kMThreads, mma_smem<DH>(),
                                            s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, q_off_ptr,
      q_off, Sq, Sk, Hq, Hkv, window, scale * kLog2e,
      aligned16(q, k, v, o));
  return (int)cudaGetLastError();
}

template <bool CAUSAL, bool WINDOW>
int launch_lm_mma_dh(const void* q, const void* k, const void* v, void* o,
                     const int* q_off_ptr, int q_off, int B, int Sq, int Sk,
                     int Hq, int Hkv, int Dh, int window, float scale,
                     cudaStream_t s) {
#define REPRO_LM_MMA(DH)                                                     \
  case DH:                                                                   \
    return launch_lm_mma<DH, CAUSAL, WINDOW>(q, k, v, o, q_off_ptr, q_off, B, \
                                             Sq, Sk, Hq, Hkv, window, scale, s);
#define REPRO_LM_WGMMA(DH)                                                  \
  case DH:                                                                  \
    return launch_lm_wgmma<DH, CAUSAL, WINDOW>(q, k, v, o, q_off_ptr, q_off,  \
                                               B, Sq, Sk, Hq, Hkv, window,    \
                                               scale, s);
  switch (Dh) {
    REPRO_LM_MMA(16)
    REPRO_LM_MMA(32)
    REPRO_LM_WGMMA(64)
    REPRO_LM_MMA(80)
    REPRO_LM_WGMMA(128)
    REPRO_LM_WGMMA(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LM_MMA
#undef REPRO_LM_WGMMA
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (Dh) {                                // bf16: the tensor cores
    case 32: return launch_dit_mma<32>(q, k, v, o, B, S, H, scale, s);
    case 64: return launch_dit_wgmma<64>(q, k, v, o, B, S, H, scale, s);
    case 128: return launch_dit_wgmma<128>(q, k, v, o, B, S, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The general form: causal (LM prefill) or not (cross-attention: keys of
// another sequence, Sq != Sk).  q, o: (B, Sq, Hq, Dh); k, v: (B, Sk, Hkv,
// Dh), contiguous, Hkv dividing Hq; q_offset read from the device scalar
// q_off_ptr when it is not null, else q_off (it places the causal mask and
// the window); window <= 0 means none; causal 0 or 1; dtype 0 = f32, 1 =
// bf16.
int repro_flash_attention_lm(const void* q, const void* k, const void* v,
                             void* o, const void* q_off_ptr, int q_off, int B,
                             int Sq, int Sk, int Hq, int Hkv, int Dh,
                             int window, int causal, int dtype, float scale,
                             void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qp = (const int*)q_off_ptr;
  const int w = window > 0 ? window : 0;
  if (dtype == 0)
    return causal
        ? launch_lm_form<float, true>(q, k, v, o, qp, q_off, B, Sq, Sk, Hq,
                                      Hkv, Dh, w, scale, s)
        : launch_lm_form<float, false>(q, k, v, o, qp, q_off, B, Sq, Sk, Hq,
                                       Hkv, Dh, w, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // bf16: the tensor cores
  if (causal)
    return w ? launch_lm_mma_dh<true, true>(q, k, v, o, qp, q_off, B, Sq, Sk,
                                            Hq, Hkv, Dh, w, scale, s)
             : launch_lm_mma_dh<true, false>(q, k, v, o, qp, q_off, B, Sq, Sk,
                                             Hq, Hkv, Dh, 0, scale, s);
  return w ? launch_lm_mma_dh<false, true>(q, k, v, o, qp, q_off, B, Sq, Sk,
                                           Hq, Hkv, Dh, w, scale, s)
           : launch_lm_mma_dh<false, false>(q, k, v, o, qp, q_off, B, Sq, Sk,
                                            Hq, Hkv, Dh, 0, scale, s);
}

}  // extern "C"
