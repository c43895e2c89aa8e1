// The gDDIM exponential-integrator update and the factored coefficient
// apply, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/ei_update/kernel.py  ei_update       (body _ei_kernel)
//   kernels/ei_update/kernel.py  apply_factored  (body _factored_kernel)
//
// ei_update computes, for a packed state u (B, k, D) and an eps history
// (q, B, k, D),
//     out[b, c, d] = sum_c' psi[c, c'] u[b, c', d]
//                  + sum_j sum_c' C[j, c, c'] eps[j, b, c', d],
// with one (k, k) psi and q (k, k) blocks C shared by the whole batch: the
// state update of the lockstep gDDIM sampler (predictor, corrector and the
// stochastic step are all this form).  apply_factored computes
//     out[b, c, d] = sum_c' (blk[b, c, c'] * diag[b, d]) z[b, c', d],
// a per-example block factor times a per-example diagonal row: one factor
// apply of the pre-fusion serving step.
//
// What bounds them on this card.  ei_update: bytes.  It does k (q + 1) k
// multiply-adds per element and must read u and the q eps rows and write
// the output, (q + 2) |u| bytes: at the sampler's shapes (n = 64,
// k <= 2, D = 3072, f32, q <= 3) 3-8 MB, 1-2.5 us at 3.35 TB/s, against
// some 10^6 operations.  apply_factored: the launch.  It reads z and diag
// and writes the output, 2 |z| + |diag| bytes (~0.1 MB at B = 4, a few
// hundredths of a microsecond), so its time is an empty launch's plus one
// round trip to memory: on an H100 it runs within 1.16x of PyTorch's fill
// of a one-element tensor, and a design with 4 elements a thread, 16-byte
// loads and a quarter of the blocks measured no faster; only fewer
// launches move it.  The design does what the TPU kernel does for its VMEM
// pass: ONE launch in which every input element is read once and every
// output element written once (the unfused chain of q + 1 broadcast
// multiply-adds would make q + 1 passes over the state).
//
// Design.  One thread per (b, d), 256 threads a block, neighbouring threads
// on neighbouring d, so each warp's loads and stores of a channel row are
// whole 128-byte lines; the thread computes all k channel rows in f32
// registers (k is a template parameter, 1 or 2; q <= 4 a runtime bound on
// an unrolled loop).  ei_update's coefficients, at most 4 + 16 floats, are
// passed by value as a kernel argument (the constant bank: one broadcast
// read per warp, no per-thread global load); apply_factored's per-example
// blocks are the same address for every thread of a block, read through
// the read-only cache as broadcasts.  The arithmetic is the plain
// version's (kernels/ei_update/ref.py) term for term, left to right, with
// __fmul_rn / __fadd_rn so that nvcc does not contract it into fused
// multiply-adds: f32 results are bitwise equal to the plain version's,
// bf16 ones too (loaded as f32, rounded once to nearest even).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 2;
constexpr int kMaxQ = 4;

struct Coeffs {
  float psi[kMaxK * kMaxK];          // (k, k) row-major
  float C[kMaxQ * kMaxK * kMaxK];    // (q, k, k) row-major
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
ei_update_kernel(const T* __restrict__ u, const T* __restrict__ eps,
                 T* __restrict__ out, const Coeffs co, int B, int D, int q) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * D) return;
  const int b = (int)(i / D), d = (int)(i - (long long)b * D);
  const size_t base = (size_t)b * K * D + d;
  const size_t step = (size_t)B * K * D;          // one eps_hist row j
  float x[K], acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) x[c] = to_f32(u[base + (size_t)c * D]);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float r = __fmul_rn(co.psi[c * K], x[0]);
#pragma unroll
    for (int c2 = 1; c2 < K; ++c2)
      r = __fadd_rn(r, __fmul_rn(co.psi[c * K + c2], x[c2]));
    acc[c] = r;
  }
#pragma unroll
  for (int j = 0; j < kMaxQ; ++j) {
    if (j >= q) break;
#pragma unroll
    for (int c2 = 0; c2 < K; ++c2)
      x[c2] = to_f32(eps[j * step + base + (size_t)c2 * D]);
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int c2 = 0; c2 < K; ++c2)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(co.C[(j * K + c) * K + c2],
                                             x[c2]));
  }
#pragma unroll
  for (int c = 0; c < K; ++c) store(out + base + (size_t)c * D, acc[c]);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
apply_factored_kernel(const float* __restrict__ blk,
                      const float* __restrict__ diag,
                      const float* __restrict__ z, float* __restrict__ out,
                      int D) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const float* bb = blk + (size_t)b * K * K;
  const float dv = diag[(size_t)b * D + d];
  const size_t base = (size_t)b * K * D + d;
  float x[K];
#pragma unroll
  for (int c = 0; c < K; ++c) x[c] = z[base + (size_t)c * D];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float r = __fmul_rn(__fmul_rn(__ldg(bb + c * K), dv), x[0]);
#pragma unroll
    for (int c2 = 1; c2 < K; ++c2)
      r = __fadd_rn(r, __fmul_rn(__fmul_rn(__ldg(bb + c * K + c2), dv),
                                 x[c2]));
    out[base + (size_t)c * D] = r;
  }
}

template <typename T>
cudaError_t launch_ei(const void* u, const void* eps, void* out,
                      const Coeffs& co, int B, int k, int D, int q,
                      cudaStream_t s) {
  const long long n = (long long)B * D;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const T* up = static_cast<const T*>(u);
  const T* ep = static_cast<const T*>(eps);
  T* op = static_cast<T*>(out);
  if (k == 1)
    ei_update_kernel<T, 1><<<grid, kThreads, 0, s>>>(up, ep, op, co, B, D, q);
  else
    ei_update_kernel<T, 2><<<grid, kThreads, 0, s>>>(up, ep, op, co, B, D, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// u, eps, out: device pointers, (B, k, D), (q, B, k, D), (B, k, D) of one
// dtype (0 = f32, 1 = bf16); psi (k * k) and C (q * k * k) f32 on the HOST,
// copied into the launch's arguments.
int repro_ei_update(const void* u, const void* eps, void* out,
                    const float* psi, const float* C, int B, int k, int D,
                    int q, int dtype, void* stream) {
  if (B < 1 || D < 1 || k < 1 || k > kMaxK || q < 0 || q > kMaxQ ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Coeffs co = {};
  for (int e = 0; e < k * k; ++e) co.psi[e] = psi[e];
  for (int e = 0; e < q * k * k; ++e) co.C[e] = C[e];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)launch_ei<__nv_bfloat16>(u, eps, out, co, B, k, D, q, s);
  return (int)launch_ei<float>(u, eps, out, co, B, k, D, q, s);
}

// blk (B, k, k), diag (B, D), z and out (B, k, D): f32 device pointers.
int repro_apply_factored(const float* blk, const float* diag, const float* z,
                         float* out, int B, int k, int D, void* stream) {
  if (B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    apply_factored_kernel<1><<<grid, kThreads, 0, s>>>(blk, diag, z, out, D);
  else if (k == 2)
    apply_factored_kernel<2><<<grid, kThreads, 0, s>>>(blk, diag, z, out, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
