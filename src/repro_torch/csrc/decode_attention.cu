// Decode attention — one query token per row against a KV cache — for
// Hopper (sm_90a), in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/decode_attention/kernel.py  decode_attention  (body _decode_kernel)
// q (B, Hq, Dh), k/v (B, S, Hkv, Dh), cache_len (B,) int32: row b attends
// the keys in [max(0, cache_len[b] - window), min(cache_len[b], S)) (no
// lower edge without a window); GQA maps query head h*rep + r to KV head h
// (rep = Hq / Hkv); f32 online softmax; a fully masked row gives 0; the
// output has q's type.
//
// What bounds it on this card: latency, not bytes.  Every live key and
// value row is read once and used for rep query rows (2 * rep * Dh
// operations per element read), far below the ~20 operations per byte at
// which f32 FMAs outrun 3.35 TB/s.  At the served shape (gemma3-1b: B = 4,
// Hkv = 1, rep = 4, Dh = 256, bf16, ~100-700 live keys) a call moves at
// most ~1.4 MB, a fraction of a microsecond of traffic: what sets its time
// is how many SMs share the work, how soon their loads are in flight, how
// many instructions each SM issues, how many barriers the merges cross,
// and how many launches a call takes.  zamba2-2.7b's shared block (B = 4,
// Hkv = 32, rep = 1, Dh = 80, bf16) reads 32 heads of K/V: at cache_len
// 640 some 26 MB a call (7.8 us at 3.35 TB/s), where the bytes bound.
//
// Design.  The TPU walks the cache's blocks one after another on one core
// and carries (m, l, acc) in VMEM.  Here one thread-block cluster of nb
// blocks (nb <= 16, chosen by the wrapper from S alone, so the grid never
// depends on cache_len, a device tensor) serves one (b, kv head, group of
// up to 4 query rows).  Each block reads cache_len[b] and takes an even
// share of the live band, and each of its warps an even share of the
// block's, so every warp works and a window leaves no dead blocks.  A warp
// copies its own keys (16-byte cp.async, kept in the cache's own dtype;
// element copies when a pointer is not 16-byte aligned, into the same
// layout, so the numbers are the same) in steps of WK keys, all of a
// step's loads in flight at once, and needs no block barrier until its
// keys are done.  A step's products:
//   * bf16, on the tensor cores (4 warps, WK = 16): S^T = K Q^T and
//     O^T += V^T P^T with mma.sync m16n8k16, the keys and the head
//     dimension on the 16-row side and the 4 query rows (padded to 8) on
//     the 8-column side, so no product is padded 4-fold; f32 accumulators;
//     P split into bf16 hi + lo halves (one bf16 P is not enough for the
//     2-ulp check); K and V rows padded by 16 bytes in shared memory so
//     ldmatrix reads no bank twice;
//   * f32, on the CUDA cores (8 warps, WK <= 8): lane (key slot, c0) sums
//     its 16-byte chunks of its slot's keys for the 4 rows, the LPK lanes
//     of a key group reduce their values with about one shuffle per value
//     (each lane keeping half of what it holds at every level), and each
//     lane accumulates its slot's keys into 4 rows x CPL x VEC independent
//     accumulators for its chunks of the output.
// Either way the softmax is online per warp, its max the same in every
// lane of a row.  The warps' partials are merged in shared memory into
// the block's (m, l, acc), every warp weighing the warps itself (no
// barrier waits on one warp).  Block u of the cluster finishes elements
// [u E, (u + 1) E) of the row group (E = 4 Dh / nb): every block pushes
// its partial of those elements, and its m and l, into block u's shared
// memory (distributed shared memory stores), so after one cluster barrier
// each block merges its elements, in rank order, from its own shared
// memory and writes them; no block reads another's memory, so none waits
// for its peers to leave.  One launch, no partials in global memory, no
// scratch buffers.  The GQA repeat is never materialized: the rows of a
// group read one K/V copy.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "tile_io.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 4;           // query rows of one KV head per cluster
constexpr int kMaxBlocks = 16;     // blocks per cluster (above 8: non-portable)
constexpr int kMaxRep = 16;

static_assert(kMaxBlocks * kRows == 64, "the cluster merge takes two per lane");

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Per (Dh, dtype): warps, keys a warp takes per step, copy stages, shared
// memory.  The f32 lane layout: lane (kslot, c0) holds 16-byte chunks c0,
// c0 + LPK, ... of the U keys of key slot kslot, for both products.  LPK,
// the lanes of a key, is the largest power of two that divides the NG
// chunks of a row, at most 32: the group reduce is a butterfly, and every
// lane of a warp has a key slot.  At Dh 16-256 that is min(NG, 32); at Dh
// 80 (NG 20) it is 4, so a warp holds 8 key slots of 5 chunks a lane.
template <int DH, typename T>
struct Cfg {
  static constexpr bool MMA = std::is_same<T, bf16>::value;
  static constexpr int ROW = DH * (int)sizeof(T);      // bytes per key row
  static constexpr int VEC = 16 / (int)sizeof(T);      // elements per chunk
  static constexpr int NG = DH / VEC;                  // chunks per row
  static constexpr int NW = MMA ? 4 : 8;               // warps per block
  static constexpr int NT = 32 * NW;
  static constexpr int LPK = cmin(NG & -NG, 32);       // lanes per key (f32)
  static constexpr int KPW = 32 / LPK;                 // key slots per warp
  static constexpr int CPL = NG / LPK;                 // chunks per lane
  static constexpr int STAGES = ROW <= 256 ? 2 : 1;    // copy stages a warp
  // keys per warp step: 16 for mma; else at most 8, and a ring <= 64 KB
  static constexpr int WK =
      MMA ? 16 : cmax(KPW, cmin(8, 4096 / (ROW * STAGES)));
  static constexpr int U = WK / KPW;                   // keys per key slot
  static constexpr int V = kRows * U;                  // dot products a lane
  static constexpr int R = cmax(1, V / LPK);           // ... after the reduce
  static constexpr int LDS = MMA ? DH + 8 : DH;        // row stride in smem
  static constexpr int WTILE = WK * LDS;               // elements of K or V
  static constexpr size_t RING = sizeof(T) * NW * STAGES * 2 * WTILE;
  static constexpr size_t WACC = sizeof(float) * NW * kRows * DH;
  static constexpr size_t BIG = RING > WACC ? RING : WACC;
  // floats after BIG: per warp scratch (mma: P^T, 16 keys x 8 rows, and
  // q's kRows rows in bf16, LDS apart; f32: scores and p, WK x kRows
  // each), the warps' m and l (NW x kRows each) and each warp's copy of
  // their weights (NW x 32), what the cluster's blocks push here (their
  // partials of this block's elements, kRows x DH in all, and their m and
  // l, kMaxBlocks x kRows each), and each warp's copy of the cluster's
  // weights and L (kMaxBlocks x kRows + kRows); every region a multiple of
  // 16 bytes
  static constexpr int SCRATCH = MMA ? 16 * 8 + kRows * LDS / 2
                                     : 2 * WK * kRows;
  static constexpr int SMALL = NW * SCRATCH + 2 * NW * kRows + NW * 32
                               + kRows * DH + 2 * kMaxBlocks * kRows
                               + NW * (kMaxBlocks * kRows + kRows);
  static constexpr size_t SMEM = BIG + sizeof(float) * SMALL;
  static_assert(NW * kRows <= 32, "the block merge takes a lane per (warp, row)");
  static_assert(NG % LPK == 0 && 32 % LPK == 0, "key slots tile the warp");
};

// one 16-byte chunk as f32
__device__ __forceinline__ void to_floats(const uint4& x, const float*,
                                          float (&f)[4]) {
  f[0] = __uint_as_float(x.x); f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z); f[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void to_floats(const uint4& x, const bf16*,
                                          float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[N]) {
  to_floats(*reinterpret_cast<const uint4*>(p), p, f);
}

// a[i] without a dynamic index (which would put a in local memory)
__device__ __forceinline__ float pick(const float (&a)[kRows], int i) {
  float x = a[0];
#pragma unroll
  for (int r = 1; r < kRows; ++r) x = i == r ? a[r] : x;
  return x;
}

// x[V] summed over the LPK lanes of this lane's key group, with V - 1
// shuffles when V >= LPK: at each level a lane keeps half of its values
// and trades the other half with its partner (then plain butterfly levels
// once one value is left).  On return x[0..R) hold the sums of values
// (lane % LPK) * V / LPK + [0, R).  Each sum is a pairwise tree over the
// group's lanes, pairs differing in the highest lane bit first.
template <int O, int N, int V>
__device__ __forceinline__ void group_reduce(float (&x)[V], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? x[i] : x[i + N / 2];
        const float keep = up ? x[i + N / 2] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      group_reduce<O / 2, N / 2, V>(x, lane);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], O);
      group_reduce<O / 2, 1, V>(x, lane);
    }
  }
}

// What a warp's loop needs: its keys [w0, w1), its ring, its scratch.
template <typename T>
struct WarpJob {
  const T* kb;          // key 0 of (b, kv head); rows `stride` apart
  const T* vb;
  size_t stride;
  int w0, w1;
  T* ring;              // this warp's STAGES x (K, V) tiles
  float* scratch;       // this warp's Cfg::SCRATCH floats
  bool vec;             // 16-byte copies (k and v 16-byte aligned)
};

// Step s's K rows, then its V rows, into stage s % STAGES, one commit
// group each (empty past the last step, so the count in flight is fixed).
// The mma path copies all WK rows, zero-filling those past the warp's
// keys (its products read every row; a stale row could hold a NaN).
template <int DH, typename T>
__device__ __forceinline__ void issue(const WarpJob<T>& j, int s, int lane) {
  using C = Cfg<DH, T>;
  T* kt = j.ring + (s % C::STAGES) * 2 * C::WTILE;
  const int j0 = j.w0 + s * C::WK;
  const int nk = min(C::WK, j.w1 - j0);
  const int rows = C::MMA ? C::WK : nk;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    if (nk > 0) {
      T* dst = kt + part * C::WTILE;
      const T* src = (part ? j.vb : j.kb) + j0 * j.stride;
      if (j.vec) {
        for (int i = lane; i < rows * C::NG; i += 32) {
          const int r = i / C::NG, c = i % C::NG;
          cp_async_16(dst + r * C::LDS + c * C::VEC,
                      r < nk ? src + r * j.stride + c * C::VEC : src,
                      r < nk);
        }
      } else {
        for (int i = lane; i < rows * DH; i += 32) {
          const int r = i / DH, d = i % DH;
          dst[r * C::LDS + d] = r < nk ? src[r * j.stride + d] : T(0.0f);
        }
      }
    }
    cp_async_commit();
  }
}

// ---- bf16: the tensor-core step -----------------------------------------
// Lane = 4 g + t.  S^T (16 keys x 8 rows) = K (16 x Dh) Q^T: A fragments
// from K rows by ldmatrix, B fragments of Q^T (rows g < 4) in registers,
// C: keys g, g + 8 x rows 2t, 2t + 1.  O^T (Dh x 8 rows) += V^T P^T: A
// from V rows by transposed ldmatrix, B = P^T through the warp's scratch,
// C per 16-row tile of Dh: dims g, g + 8 x rows 2t, 2t + 1.  Rows 4..7 are
// padding (q 0): their values are finite and never stored.
template <int DH>
struct MmaWarp {
  using C = Cfg<DH, bf16>;
  static constexpr int KD = DH / 16;                    // k-steps, m-tiles
  uint32_t qb[KD][2];                                   // Q^T B fragments

  // q's rows into the warp's scratch (rows past `rows` 0), one commit
  // group ahead of the K/V copies: the first step's wait covers it
  __device__ __forceinline__ void load_q(const bf16* qg, int rows, int lane,
                                         float* scratch) {
    bf16* qs = reinterpret_cast<bf16*>(scratch + 16 * 8);
    if (((uintptr_t)qg & 15) == 0) {
      for (int i = lane; i < kRows * C::NG; i += 32) {
        const int r = i / C::NG, c = i % C::NG;
        cp_async_16(qs + r * C::LDS + c * 8, r < rows ? qg + r * DH + c * 8
                                                      : qg, r < rows);
      }
    } else {
      for (int i = lane; i < kRows * DH; i += 32) {
        const int r = i / DH, d = i % DH;
        qs[r * C::LDS + d] = r < rows ? qg[r * DH + d] : bf16(0.0f);
      }
    }
    cp_async_commit();
  }

  // Q^T's B fragments (row g < kRows; else 0) from the warp's scratch
  __device__ __forceinline__ void q_frags(const float* scratch, int lane) {
    const bf16* qs = reinterpret_cast<const bf16*>(scratch + 16 * 8);
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qb[kk][half] = g < kRows ? *reinterpret_cast<const uint32_t*>(
                                       qs + g * C::LDS + kk * 16 + half * 8
                                       + 2 * t)
                                 : 0u;
  }

  // the warp's keys; returns its partial: m, l per row (rows 2t, 2t + 1 in
  // lanes t < 2, the same across g) and acc (dims g, g + 8 of each tile)
  __device__ __forceinline__ void run(const WarpJob<bf16>& j, int lane,
                                      float scale, float (&m)[2],
                                      float (&l)[2], float (&acc)[KD][4]) {
    const int g = lane / 4, t = lane % 4;
    const int n_steps = (j.w1 - j.w0 + C::WK - 1) / C::WK;
    // ldmatrix row addresses: K (A, non-transposed) key lane % 16, dims +
    // 8 (lane / 16); V (A, transposed) key lane % 8 + 8 (lane / 16), dims
    // + 8 ((lane / 8) % 2)
    const int k_ld = (lane % 16) * C::LDS + (lane / 16) * 8;
    const int v_ld = (lane % 8 + (lane / 16) * 8) * C::LDS + (lane / 8 % 2) * 8;
    float* pw = j.scratch;                              // P^T, 16 x 8
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) issue<DH>(j, s, lane);
    for (int s = 0; s < n_steps; ++s) {
      const bf16* kt = j.ring + (s % C::STAGES) * 2 * C::WTILE;
      const bf16* vt = kt + C::WTILE;
      const int nk = min(C::WK, j.w1 - (j.w0 + s * C::WK));
      cp_async_wait<2 * C::STAGES - 1>();               // K (and q) in
      __syncwarp();
      if (s == 0) q_frags(j.scratch, lane);
      // S^T in two chains (even and odd k-steps), then summed
      float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + k_ld + kk * 16);
        mma_bf16(c[kk & 1], a, qb[kk][0], qb[kk][1]);
      }
      // scores: sc[i] for key g (i < 2) or g + 8 (i >= 2), row 2t + i % 2
      float sc[4], mx[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = g + (i / 2) * 8;
        sc[i] = key < nk ? (c[0][i] + c[1][i]) * scale : -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(sc[r], sc[2 + r]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mx[r]);            // finite: nk >= 1
        alpha[r] = expf(m[r] - mn);                     // 0 on the first step
        m[r] = mn;
      }
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = expf(sc[i] - m[i % 2]);                  // masked key: 0
        pw[(g + (i / 2) * 8) * 8 + 2 * t + i % 2] = p[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = fmaf(l[r], alpha[r], p[r] + p[2 + r]);
#pragma unroll
        for (int mt = 0; mt < KD; ++mt) {
          acc[mt][r] *= alpha[r];
          acc[mt][2 + r] *= alpha[r];
        }
      }
      cp_async_wait<2 * C::STAGES - 2>();               // V is in
      __syncwarp();
      // P^T's B fragments: keys 2t, 2t + 1 (b0) and 8 + 2t, 9 + 2t (b1) of
      // row g, each split into bf16 hi + lo
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = half * 8 + 2 * t;
        split_bf16(pw[key * 8 + g], pw[(key + 1) * 8 + g], bh[half],
                   bl[half]);
      }
#pragma unroll
      for (int mt = 0; mt < KD; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + v_ld + mt * 16);
        mma_bf16(acc[mt], a, bh[0], bh[1]);
        mma_bf16(acc[mt], a, bl[0], bl[1]);
      }
      __syncwarp();                                     // stage, pw free
      issue<DH>(j, s + C::STAGES, lane);
    }
    // l: the row's sum over the 8 lanes g of its t
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
  }

  // the partial of rows 0..3 into the block's merge arrays
  __device__ __forceinline__ void store(int warp, int lane, const float (&m)[2],
                                        const float (&l)[2],
                                        const float (&acc)[KD][4],
                                        float* wacc, float* wm, float* wl) {
    const int g = lane / 4, t = lane % 4;
    if (t >= 2) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* row = wacc + (warp * kRows + 2 * t + r) * DH;
#pragma unroll
      for (int mt = 0; mt < KD; ++mt) {
        row[mt * 16 + g] = acc[mt][r];
        row[mt * 16 + g + 8] = acc[mt][2 + r];
      }
      if (g == 0) {
        wm[warp * kRows + 2 * t + r] = m[r];
        wl[warp * kRows + 2 * t + r] = l[r];
      }
    }
  }
};

// ---- f32: the CUDA-core step --------------------------------------------
template <int DH, typename T>
struct FmaWarp {
  using C = Cfg<DH, T>;
  float qr[kRows][C::CPL][C::VEC];                      // q's chunks

  __device__ __forceinline__ void load_q(const T* qg, int rows, int lane,
                                         float*) {
    const int c0 = lane % C::LPK;
    const bool qvec = ((uintptr_t)qg & 15) == 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < C::CPL; ++i) {
        const T* src = qg + r * DH + (c0 + i * C::LPK) * C::VEC;
        if (r >= rows) {
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) qr[r][i][e] = 0.0f;
        } else if (qvec) {
          load_vec(src, qr[r][i]);
        } else {
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) qr[r][i][e] = to_f32(src[e]);
        }
      }
  }

  // the warp's keys; returns its partial (m the same in every lane; l and
  // acc summed over the key slots in every lane)
  __device__ __forceinline__ void run(const WarpJob<T>& j, int lane,
                                      float scale, float (&m)[kRows],
                                      float (&l)[kRows],
                                      float (&acc)[kRows][C::CPL][C::VEC]) {
    const int kslot = lane / C::LPK, c0 = lane % C::LPK;
    const int n_steps = (j.w1 - j.w0 + C::WK - 1) / C::WK;
    float* wps = j.scratch;                             // (WK, kRows)
    float* wpp = wps + C::WK * kRows;
    const int base = c0 * C::V / C::LPK;                // first reduced value
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) issue<DH>(j, s, lane);
    for (int s = 0; s < n_steps; ++s) {
      const T* kt = j.ring + (s % C::STAGES) * 2 * C::WTILE;
      const T* vt = kt + C::WTILE;
      const int nk = min(C::WK, j.w1 - (j.w0 + s * C::WK));
      cp_async_wait<2 * C::STAGES - 1>();               // K is in
      __syncwarp();
      // scores: this lane's chunks of its slot's U keys, summed over the
      // key group
      float x[C::V];
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) x[u * kRows + r] = 0.0f;
        if (kslot * C::U + u < nk) {
#pragma unroll
          for (int i = 0; i < C::CPL; ++i) {
            float kf[C::VEC];
            load_vec(kt + (kslot * C::U + u) * DH + (c0 + i * C::LPK) * C::VEC,
                     kf);
#pragma unroll
            for (int e = 0; e < C::VEC; ++e)
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                x[u * kRows + r] = fmaf(qr[r][i][e], kf[e], x[u * kRows + r]);
          }
        }
      }
      group_reduce<C::LPK / 2, C::V, C::V>(x, lane);
      float sc[C::R];
#pragma unroll
      for (int i = 0; i < C::R; ++i) {
        const int val = base + i, jj = kslot * C::U + val / kRows;
        sc[i] = jj < nk ? x[i] * scale : -INFINITY;
        wps[kslot * C::V + val] = sc[i];
      }
      __syncwarp();
      // the step's max per row, the same in every lane
      float mx[kRows], alpha[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) mx[r] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < C::WK; ++jj)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          mx[r] = fmaxf(mx[r], wps[jj * kRows + r]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float mn = fmaxf(m[r], mx[r]);            // finite: nk >= 1
        alpha[r] = expf(m[r] - mn);                     // 0 on the first step
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < C::R; ++i) {
        const int val = base + i;
        wpp[kslot * C::V + val] = expf(sc[i] - pick(m, val % kRows));
      }
      cp_async_wait<2 * C::STAGES - 2>();               // V is in
      __syncwarp();
      // P V over this slot's keys into kRows x CPL x VEC accumulators
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        l[r] *= alpha[r];
#pragma unroll
        for (int i = 0; i < C::CPL; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) acc[r][i][e] *= alpha[r];
      }
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
        const int jj = kslot * C::U + u;
        if (jj < nk) {
          float p[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) p[r] = wpp[jj * kRows + r];
#pragma unroll
          for (int r = 0; r < kRows; ++r) l[r] += p[r];
#pragma unroll
          for (int i = 0; i < C::CPL; ++i) {
            float vf[C::VEC];
            load_vec(vt + jj * DH + (c0 + i * C::LPK) * C::VEC, vf);
#pragma unroll
            for (int e = 0; e < C::VEC; ++e)
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                acc[r][i][e] = fmaf(p[r], vf[e], acc[r][i][e]);
          }
        }
      }
      __syncwarp();                                     // the stage is free
      issue<DH>(j, s + C::STAGES, lane);
    }
    // the key slots summed (pairs differing in the lowest slot bit first)
#pragma unroll
    for (int off = C::LPK; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
        for (int i = 0; i < C::CPL; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            acc[r][i][e] += __shfl_xor_sync(0xffffffffu, acc[r][i][e], off);
      }
  }

  __device__ __forceinline__ void store(int warp, int lane,
                                        const float (&m)[kRows],
                                        const float (&l)[kRows],
                                        const float (&acc)[kRows][C::CPL][C::VEC],
                                        float* wacc, float* wm, float* wl) {
    const int kslot = lane / C::LPK, c0 = lane % C::LPK;
    if (kslot == 0)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < C::CPL; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            wacc[(warp * kRows + r) * DH + (c0 + i * C::LPK) * C::VEC + e] =
                acc[r][i][e];
    if (lane < kRows) {
      wm[warp * kRows + lane] = pick(m, lane);
      wl[warp * kRows + lane] = pick(l, lane);
    }
  }
};

// grid (nb, Hkv * ceil(rep / kRows), B), cluster (nb, 1, 1), Cfg::NW
// warps; nb divides 16 and so kRows * DH (4 * 80 = 320 = 16 * 20: every
// block finishes a multiple of 4 elements, as the float4 pushes need).
template <int DH, typename T>
__global__ void __launch_bounds__(Cfg<DH, T>::NT)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ cache_len,
                        T* __restrict__ o, int S, int Hkv, int rep,
                        int window, float scale) {
  using C = Cfg<DH, T>;
  constexpr int NW = C::NW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wacc = reinterpret_cast<float*>(smem);       // the ring, reused
  float* scr = reinterpret_cast<float*>(smem + C::BIG);  // (NW, SCRATCH)
  float* wm = scr + NW * C::SCRATCH;                    // (NW, kRows)
  float* wl = wm + NW * kRows;
  float* wwt = wl + NW * kRows;                         // (NW, 32)
  float* racc = wwt + NW * 32;                          // (nb, E) pushed here
  float* rm = racc + kRows * DH;                        // (kMaxBlocks, kRows)
  float* rl = rm + kMaxBlocks * kRows;
  float* cw = rl + kMaxBlocks * kRows;  // (NW, kMaxBlocks x kRows + kRows)

  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ngrp = (rep + kRows - 1) / kRows;
  const int h = blockIdx.y / ngrp, g = blockIdx.y % ngrp, b = blockIdx.z;
  const int rows = min(kRows, rep - g * kRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // cache_len[b], then q (the f32 path: this lane's chunks, straight into
  // registers; the mma path: the rows, into the warp's scratch): these
  // loads are in flight together
  const int len = __ldg(cache_len + b);
  std::conditional_t<C::MMA, MmaWarp<DH>, FmaWarp<DH, T>> path;
  path.load_q(q + ((size_t)b * Hkv * rep + (size_t)h * rep + g * kRows) * DH,
              rows, lane, scr + warp * C::SCRATCH);

  // the live band [lo, hi); this block's even share of it, and this
  // warp's even share [w0, w1) of the block's
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int n = max(0, hi - lo);
  const int lg_nb = __ffs(nb) - 1;                      // nb = 2^lg_nb
  const int k0 = lo + ((n * rank) >> lg_nb);            // n * 16 < 2^31
  const int nbk = lo + ((n * (rank + 1)) >> lg_nb) - k0;
  WarpJob<T> job;
  job.stride = (size_t)Hkv * DH;
  job.kb = k + ((size_t)b * S * Hkv + h) * DH;
  job.vb = v + ((size_t)b * S * Hkv + h) * DH;
  job.w0 = k0 + nbk * warp / NW;
  job.w1 = k0 + nbk * (warp + 1) / NW;
  job.ring = reinterpret_cast<T*>(smem) + warp * C::STAGES * 2 * C::WTILE;
  job.scratch = scr + warp * C::SCRATCH;
  job.vec = (((uintptr_t)k | (uintptr_t)v) & 15) == 0;

  if constexpr (C::MMA) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float acc[MmaWarp<DH>::KD][4] = {};
    path.run(job, lane, scale, m, l, acc);
    cp_async_wait<0>();
    __syncthreads();                                    // the ring is free
    path.store(warp, lane, m, l, acc, wacc, wm, wl);
  } else {
    float m[kRows], l[kRows], acc[kRows][C::CPL][C::VEC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < C::CPL; ++i)
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) acc[r][i][e] = 0.0f;
    }
    path.run(job, lane, scale, m, l, acc);
    cp_async_wait<0>();
    __syncthreads();                                    // the ring is free
    path.store(warp, lane, m, l, acc, wacc, wm, wl);
  }
  __syncthreads();                                      // partials are in

  // the block's partial.  Every warp weighs the warps itself (lane = w *
  // kRows + r; L summed pairwise, pairs differing in the lowest warp bit
  // first), so no barrier waits on one warp; each thread then merges its
  // elements in warp order.  Block u of the cluster finishes elements
  // [u E, (u + 1) E) of the row group: the partial of each element, and
  // the block's m and l (from warp 0), are pushed into the shared memory
  // of the block that finishes it.
  const int E = kRows * DH / nb;
  float* ww = wwt + warp * 32;                          // this warp's copy
  {
    constexpr int NL = NW * kRows;                      // lanes w * kRows + r
    const float mw = lane < NL ? wm[lane] : -INFINITY;
    float M = mw;
#pragma unroll
    for (int off = kRows; off < NL; off <<= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float wt = M > -INFINITY ? expf(mw - M) : 0.0f;
    ww[lane] = wt;
    if (warp == 0) {
      float L = (lane < NL ? wl[lane] : 0.0f) * wt;
#pragma unroll
      for (int off = kRows; off < NL; off <<= 1)
        L += __shfl_xor_sync(0xffffffffu, L, off);
      // lane = u * kRows + r pushes row r's (M, L) to blocks u and u + 8
      const float Mr = __shfl_sync(0xffffffffu, M, lane % kRows);
      const float Lr = __shfl_sync(0xffffffffu, L, lane % kRows);
#pragma unroll
      for (int u = lane / kRows; u < nb; u += 32 / kRows) {
        *cluster.map_shared_rank(rm + rank * kRows + lane % kRows, u) = Mr;
        *cluster.map_shared_rank(rl + rank * kRows + lane % kRows, u) = Lr;
      }
    }
    __syncwarp();
  }
  for (int el = 4 * tid; el < kRows * DH; el += 4 * C::NT) {
    const int r = el / DH;                // 4 elements of one row, one owner
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(wacc + w * kRows * DH
                                                        + el);
      const float wt = ww[w * kRows + r];
      a = make_float4(fmaf(x.x, wt, a.x), fmaf(x.y, wt, a.y),
                      fmaf(x.z, wt, a.z), fmaf(x.w, wt, a.w));
    }
    *reinterpret_cast<float4*>(
        cluster.map_shared_rank(racc + rank * E + el % E, el / E)) = a;
  }
  cluster.sync();                     // every block's pushes have landed

  // this block's elements, merged over the blocks in rank order from its
  // own shared memory.  Each warp with elements weighs the blocks itself
  // (lane = u * kRows + r for blocks u and u + 8; L summed as lb wb + la wa
  // per lane, then pairwise, pairs differing in the lowest block bit
  // first).
  if (warp * 32 < E) {
    float* cwv = cw + warp * (kMaxBlocks * kRows + kRows);  // this warp's
    const int r = lane % kRows, ua = lane / kRows, ub = ua + 8;
    const float ma = ua < nb ? rm[ua * kRows + r] : -INFINITY;
    const float mb = ub < nb ? rm[ub * kRows + r] : -INFINITY;
    const float la = ua < nb ? rl[ua * kRows + r] : 0.0f;
    const float lb = ub < nb ? rl[ub * kRows + r] : 0.0f;
    float M = fmaxf(ma, mb);
#pragma unroll
    for (int off = kRows; off < 32; off <<= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float wa = M > -INFINITY ? expf(ma - M) : 0.0f;
    const float wb = M > -INFINITY ? expf(mb - M) : 0.0f;
    float L = fmaf(lb, wb, la * wa);
#pragma unroll
    for (int off = kRows; off < 32; off <<= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    cwv[ua * kRows + r] = wa;
    cwv[ub * kRows + r] = wb;
    if (lane < kRows) cwv[kMaxBlocks * kRows + lane] = L;   // 0: no live key
    __syncwarp();
    for (int i = tid; i < E; i += C::NT) {
      const int el = rank * E + i, r2 = el / DH, d = el % DH;
      float a = 0.0f;
#pragma unroll
      for (int u = 0; u < kMaxBlocks; ++u)
        if (u < nb) a = fmaf(racc[u * E + i], cwv[u * kRows + r2], a);
      const float Lr = cwv[kMaxBlocks * kRows + r2];
      if (r2 < rows)
        store(&o[((size_t)b * Hkv * rep + (size_t)h * rep + g * kRows + r2)
                 * DH + d], Lr > 0.0f ? a / Lr : 0.0f);
    }
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           void* o, int B, int S, int Hkv, int rep, int window, float scale,
           int nb, cudaStream_t st) {
  using C = Cfg<DH, T>;
  auto* kern = decode_attention_kernel<DH, T>;
  static bool ready = false;       // the attributes are set once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, Hkv * ((rep + kRows - 1) / kRows), B);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k,
                                     (const T*)v, cache_len, (T*)o, S, Hkv,
                                     rep, window, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* cl,
              void* o, int B, int S, int Hkv, int rep, int Dh, int window,
              float scale, int nb, cudaStream_t st) {
  switch (Dh) {
#define REPRO_DH_CASE(N) \
    case N: return launch<N, T>(q, k, v, cl, o, B, S, Hkv, rep, window, \
                                scale, nb, st);
    REPRO_DH_CASE(16)
    REPRO_DH_CASE(32)
    REPRO_DH_CASE(64)
    REPRO_DH_CASE(80)
    REPRO_DH_CASE(128)
    REPRO_DH_CASE(256)
#undef REPRO_DH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q (B, Hkv*rep, Dh) and o (same shape, q's dtype), k/v (B, S, Hkv, Dh),
// contiguous; cache_len (B,) int32; window <= 0 means none; dtype 0 = f32,
// 1 = bf16; nb, the blocks of a cluster, in 1, 2, 4, 8, 16; S < 2^27.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const void* cache_len, void* o, int B, int S,
                           int Hkv, int rep, int Dh, int window, int dtype,
                           float scale, int nb, void* stream) {
  if (rep < 1 || rep > kMaxRep || nb < 1 || nb > kMaxBlocks ||
      (nb & (nb - 1)) != 0 || B < 1 || S < 1 || S >= (1 << 27) || Hkv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* cl = (const int*)cache_len;
  if (dtype == 0)
    return launch_dh<float>(q, k, v, cl, o, B, S, Hkv, rep, Dh, window,
                            scale, nb, st);
  if (dtype == 1)
    return launch_dh<bf16>(q, k, v, cl, o, B, S, Hkv, rep, Dh, window, scale,
                           nb, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
