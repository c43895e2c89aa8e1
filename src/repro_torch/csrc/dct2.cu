// The orthonormal 2-D DCT of BDM's frequency basis and the fused BDM
// gDDIM update, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/dct2/kernel.py  dct2           (body _dct_kernel)
//   kernels/dct2/kernel.py  bdm_ei_update  (body _bdm_kernel)
//
// dct2 computes Y = C_h X C_w^T (or its inverse X = C_h^T Y C_w) for every
// (b, channel) tile of a channels-last (B, H, W, Ch) f32 image batch.
// bdm_ei_update computes IDCT(psi * DCT(u) + sum_j C_j * DCT(eps_j)) per
// tile, psi and C_j per frequency and shared by the channels.
//
// What bounds them on this card: bytes in principle, latency in practice.
// A dct2 call at B = 4, 32 x 32 x 3 moves 2 x 48 KB and does ~1.6 MFLOP of
// f32 products (~0.03 us of traffic at 3.35 TB/s, ~0.02 us of f32 work at
// 67 TFLOP/s), so what sets its time is how many blocks share the work
// and how long each thread's chain of dependent loads and multiply-adds
// is.  Each transform stays ONE launch that reads every input element once
// and writes every output element once: the TPU version transposes to
// (B, Ch, H, W) on the host and back (two more passes, two more launches);
// here a block reads its tile straight from the channels-last layout with
// stride Ch and writes it back the same way.  bdm_ei_update reads q + 1
// tiles and writes one, (q + 2) |u| bytes in all.
//
// dct2.  The wrapper passes the two matrices of the direction asked for,
// A = C_h and B^T = C_w^T forward, A = C_h^T and B^T = C_w inverse (f32
// copies of the host float64 matrix, cached on the device), so one kernel
// computes Y = A X B^T.  One block per (b, channel, band of output rows):
// 8 bands (fewer when H < 8), 96 blocks at B = 4 for 132 SMs.  A block
// copies its band's rows of A, all of B^T and the whole tile into shared
// memory with asynchronous copies, all in flight at once (16 bytes a copy
// for the matrices), then computes T = A[band] X and Y[band] = T B^T, one
// output per thread and step, lanes along the output row (so the matrix
// and tile reads are consecutive or broadcast: no bank conflicts, no
// padding).  Each output's sum runs in four independent
// accumulators (term i into accumulator i mod 4, then (a0 + a1) + (a2 +
// a3)), so no output waits on one 32-long chain.  No block waits on
// another.
//
// bdm_ei_update.  One block per (b, channel) tile, 256 threads; both DCT
// matrices (rows padded to n + 1 floats so that a warp walking a column
// hits distinct banks) and the tile live in shared memory, and each
// product runs one output element per thread in the plain version's order
// (the H axis first, then W).
//
// Both stay in f32 fused multiply-adds on the CUDA cores: TF32 keeps about
// three decimal digits, and that error would land in every canonicalize
// of the serving state.  H and W may be any size up to 64 (the 8 x 8
// reduced config and the 32 x 32 CIFAR frame are the ones served); above
// 48 KB the shared memory is requested as dynamic shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;     // bdm_ei_update
constexpr int kMaxN = 64;
constexpr int kBands = 8;         // dct2: blocks per tile
constexpr int kBandThreads = 128;

struct Smem {
  float* ch;    // C_h, rows padded to H + 1
  float* cw;    // C_w, rows padded to W + 1
  float* x;     // the tile being transformed, (H, W) row-major
  float* t;     // after the H-axis product
  float* y;     // bdm_ei_update's frequency-space sum
};

__device__ __forceinline__ Smem carve(float* sm, int H, int W) {
  Smem s;
  s.ch = sm;
  s.cw = s.ch + H * (H + 1);
  s.x = s.cw + W * (W + 1);
  s.t = s.x + H * W;
  s.y = s.t + H * W;
  return s;
}

__device__ __forceinline__ void load_mats(const float* ch, const float* cw,
                                          Smem s, int H, int W) {
  for (int e = threadIdx.x; e < H * H; e += blockDim.x)
    s.ch[(e / H) * (H + 1) + e % H] = ch[e];
  for (int e = threadIdx.x; e < W * W; e += blockDim.x)
    s.cw[(e / W) * (W + 1) + e % W] = cw[e];
}

// tile (b, c) of a channels-last (., H, W, Ch) array -> dst (H, W)
__device__ __forceinline__ void load_tile(const float* src, float* dst,
                                          int HW, int Ch) {
  for (int e = threadIdx.x; e < HW; e += blockDim.x)
    dst[e] = src[(size_t)e * Ch];
}

// t[h][j] = sum_i A[h][i] x[i][j]; A = C_h (forward) or C_h^T (inverse)
__device__ __forceinline__ void along_h(const float* ch, const float* x,
                                        float* t, int H, int W,
                                        bool inverse) {
  for (int e = threadIdx.x; e < H * W; e += blockDim.x) {
    const int h = e / W, j = e - h * W;
    float acc = 0.0f;
    for (int i = 0; i < H; ++i) {
      const float a = inverse ? ch[i * (H + 1) + h] : ch[h * (H + 1) + i];
      acc = fmaf(a, x[i * W + j], acc);
    }
    t[e] = acc;
  }
}

// element e = (h, w) of sum_j t[h][j] B[w][j]; B = C_w (forward) or
// C_w^T (inverse)
__device__ __forceinline__ float along_w(const float* cw, const float* t,
                                         int e, int W, bool inverse) {
  const int h = e / W, w = e - h * W;
  float acc = 0.0f;
  for (int j = 0; j < W; ++j) {
    const float b = inverse ? cw[j * (W + 1) + w] : cw[w * (W + 1) + j];
    acc = fmaf(t[h * W + j], b, acc);
  }
  return acc;
}

// 4 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// dst[e] = src[e * stride] for e < n, global to shared memory, without
// waiting: 16 bytes a copy for contiguous floats when src is 16-byte
// aligned and n a multiple of 4 (dst always is: see dct2_kernel)
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           size_t stride, int n) {
  if (stride == 1 && (((uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      cp_async_16(dst + 4 * e, src + 4 * e, true);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cp_async_4(dst + e, src + e * stride);
  }
}

// out[r][c] = sum_i a[r * n + i] * m[i * cols + c] for the rows x cols
// outputs, term i into accumulator i mod 4, summed (a0 + a1) + (a2 + a3);
// f(e, value) receives output e = r * cols + c
template <typename F>
__device__ __forceinline__ void product4(const float* a, const float* m,
                                         int rows, int n, int cols, F f) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    const float* ar = a + r * n;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int i = 0;
    for (; i + 4 <= n; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(ar[i + u], m[(i + u) * cols + c], acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)           // the tail: i is a multiple of 4
      if (i + u < n) acc[u] = fmaf(ar[i + u], m[(i + u) * cols + c], acc[u]);
    f(e, (acc[0] + acc[1]) + (acc[2] + acc[3]));
  }
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// rows per band: H over min(H, kBands) bands, rounded up
__host__ __device__ __forceinline__ int band_rows(int H) {
  const int bands = H < kBands ? H : kBands;
  return (H + bands - 1) / bands;
}

// grid (B * Ch, ceil(H / band_rows(H))), kBandThreads threads: Y[band] =
// A[band] X B^T for tile blockIdx.x, band blockIdx.y
__global__ void __launch_bounds__(kBandThreads)
dct2_kernel(const float* x, float* y, const float* a, const float* bt,
            int H, int W, int Ch) {
  extern __shared__ float sm[];
  const int R = band_rows(H);
  const int h0 = blockIdx.y * R, rows = min(R, H - h0);
  const int b = blockIdx.x / Ch, c = blockIdx.x - b * Ch;
  const size_t off = (size_t)b * H * W * Ch + c;
  float* as = sm;                         // (rows, H): A's band rows
  float* bs = as + round4(R * H);         // (W, W): B^T
  float* xs = bs + round4(W * W);         // (H, W): the tile
  float* ts = xs + H * W;                 // (rows, W): A[band] X
  copy_async(as, a + (size_t)h0 * H, 1, rows * H);
  copy_async(bs, bt, 1, W * W);
  copy_async(xs, x + off, Ch, H * W);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  product4(as, xs, rows, H, W, [&](int e, float t) { ts[e] = t; });
  __syncthreads();
  float* yb = y + off + (size_t)h0 * W * Ch;
  product4(ts, bs, rows, W, W,
           [&](int e, float t) { yb[(size_t)e * Ch] = t; });
}

__global__ void __launch_bounds__(kThreads)
bdm_ei_update_kernel(const float* u, const float* eps, const float* psi,
                     const float* C, float* out, const float* ch,
                     const float* cw, int B, int H, int W, int Ch, int q) {
  extern __shared__ float sm[];
  const Smem s = carve(sm, H, W);
  const int HW = H * W;
  const int b = blockIdx.x / Ch, c = blockIdx.x - b * Ch;
  const size_t off = (size_t)b * HW * Ch + c;
  load_mats(ch, cw, s, H, W);
  load_tile(u + off, s.x, HW, Ch);
  __syncthreads();
  along_h(s.ch, s.x, s.t, H, W, false);
  __syncthreads();
  for (int e = threadIdx.x; e < HW; e += blockDim.x)
    s.y[e] = __fmul_rn(along_w(s.cw, s.t, e, W, false), psi[e]);
  for (int j = 0; j < q; ++j) {
    // the sync after this load also orders the previous along_w's reads
    // of t before along_h overwrites it
    load_tile(eps + (size_t)j * B * HW * Ch + off, s.x, HW, Ch);
    __syncthreads();
    along_h(s.ch, s.x, s.t, H, W, false);
    __syncthreads();
    for (int e = threadIdx.x; e < HW; e += blockDim.x)
      s.y[e] = __fadd_rn(s.y[e], __fmul_rn(along_w(s.cw, s.t, e, W, false),
                                           C[(size_t)j * HW + e]));
  }
  __syncthreads();
  along_h(s.ch, s.y, s.t, H, W, true);
  __syncthreads();
  for (int e = threadIdx.x; e < HW; e += blockDim.x)
    out[off + (size_t)e * Ch] = along_w(s.cw, s.t, e, W, true);
}

size_t smem_bytes(int H, int W, int tiles) {
  return sizeof(float) * ((size_t)H * (H + 1) + (size_t)W * (W + 1)
                          + (size_t)tiles * H * W);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_shape(int B, int H, int W, int Ch) {
  return B < 1 || Ch < 1 || H < 1 || W < 1 || H > kMaxN || W > kMaxN;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// y = a x bt per (b, channel) tile of (B, H, W, Ch) f32: a (H, H) and bt
// (W, W) row-major (C_h, C_w^T forward; C_h^T, C_w inverse)
int repro_dct2(const float* x, float* y, const float* a, const float* bt,
               int B, int H, int W, int Ch, void* stream) {
  if (bad_shape(B, H, W, Ch)) return (int)cudaErrorInvalidValue;
  const int R = band_rows(H);
  const size_t bytes = sizeof(float) * (round4(R * H) + round4(W * W)
                                        + H * W + R * W);
  cudaError_t err = allow_smem(dct2_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Ch, (H + R - 1) / R);
  dct2_kernel<<<grid, kBandThreads, bytes, (cudaStream_t)stream>>>(
      x, y, a, bt, H, W, Ch);
  return (int)cudaGetLastError();
}

int repro_bdm_ei_update(const float* u, const float* eps, const float* psi,
                        const float* C, float* out, const float* ch,
                        const float* cw, int B, int H, int W, int Ch, int q,
                        void* stream) {
  if (bad_shape(B, H, W, Ch) || q < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(H, W, 3);
  cudaError_t err = allow_smem(bdm_ei_update_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  bdm_ei_update_kernel<<<B * Ch, kThreads, bytes, (cudaStream_t)stream>>>(
      u, eps, psi, C, out, ch, cw, B, H, W, Ch, q);
  return (int)cudaGetLastError();
}

}  // extern "C"
