// The gDDIM exponential-integrator update and the factored coefficient
// apply, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/ei_update/kernel.py  ei_update       (body _ei_kernel)
//   kernels/ei_update/kernel.py  apply_factored  (body _factored_kernel)
//
// ei_update computes, for a packed state u (B, k, D) and an eps history of
// q rows eps_j, each (B, k, D),
//     out[b, c, d] = sum_c' psi[c, c'] u[b, c', d]
//                  + sum_j sum_c' C[j, c, c'] eps_j[b, c', d],
// with one (k, k) psi and q (k, k) blocks C shared by the whole batch: the
// state update of the lockstep gDDIM sampler (predictor, corrector and the
// stochastic step are all this form).  apply_factored computes
//     out[b, c, d] = sum_c' (blk[b, c, c'] * diag[b, d]) z[b, c', d],
// a per-example block factor times a per-example diagonal row: one factor
// apply of the pre-fusion serving step.
//
// What bounds them on this card.  ei_update: bytes, and the launch.  It
// does k (q + 1) k multiply-adds per element and must read u and the q eps
// rows and write the output, (q + 2) |u| bytes: at the sampler's shapes
// (n = 64, k <= 2, D = 3072, f32, q <= 3) 3-8 MB, 1-2.5 us at 3.35 TB/s,
// against some 10^6 operations, and the rows were just written, so they
// sit in the 50 MB L2.  A kernel that sends its loads one after another
// pays one round trip per row; one that sends them together pays one.
// apply_factored: the launch.  It reads z and diag and writes the output,
// 2 |z| + |diag| bytes (~0.1 MB at B = 4, a few hundredths of a
// microsecond), so its time is an empty launch's plus one round trip to
// memory: on an H100 it runs within 1.16x of PyTorch's fill of a
// one-element tensor, and a design with 4 elements a thread, 16-byte loads
// and a quarter of the blocks measured no faster; only fewer launches move
// it.  Both do what the TPU kernel does for its VMEM pass: ONE launch in
// which every input element is read once and every output element written
// once (the unfused chain of q + 1 broadcast multiply-adds would make
// q + 1 passes over the state).
//
// ei_update's design.
//   * The history is read where it lies: the q rows are q device pointers
//     passed by value in the launch's argument struct (with psi and C, at
//     most 4 + 16 floats), so the caller stacks nothing (a stack would be
//     one more kernel, moving 2 q |u| bytes) and no pointer costs a load.
//   * q is fixed when the kernel is compiled (an instance for each q in
//     0..4, as the TPU kernel fixes it at trace time), so no branch guards
//     a load: a thread issues all (q + 1) k of its loads, each independent,
//     before the first product that uses one, and waits for memory once.
//     The PTX has them in that order, but ptxas sinks the later loads of
//     the k = 2 instances (q >= 2) below the first multiply; a block-scope
//     fence after the loads keeps them ahead (cuobjdump -sass: every LDG
//     before the first FMUL in every instance; scripts/compare_calls.py ei).
//   * D is the first parameter, so that what the addresses need (D, u,
//     out, the row pointers) shares the first line of the constant bank.
//   * 16-byte accesses: a thread takes E consecutive d of one example (4
//     for f32, 8 for bf16) for all k channel rows, each access one 16-byte
//     load or store (two a thread measured slower on an H100).  That
//     instance runs when u, out and every row are 16-byte aligned and E
//     divides D; any other shape runs the scalar instance (E = 1) of the
//     same template.  The wrapper chooses by shape and alignment alone.
//   * Grid (B, D / E / threads), 256 threads a block (192 blocks at path
//     A's n 64, D 3072, f32): no division by D in a thread, and the batch
//     on grid.x takes any B (grid.y bounds D / E / threads to 65535).
// What is left is the bytes through L2 and the launch: at path A's shapes
// (q 2, f32) the kernel runs as fast as PyTorch's vectorised addcmul over
// the same four streams at k 1 and within 7% of it at k 2
// (scripts/compare_calls.py ei), about 0.6 us above an empty launch at k 1.
// apply_factored's design: one thread per (b, d), 256 threads a block,
// neighbouring threads on neighbouring d; its per-example blocks are the
// same address for every thread of a block, read through the read-only
// cache as broadcasts.
//
// The arithmetic of both is the plain version's (kernels/ei_update/ref.py)
// term for term, left to right, with __fmul_rn / __fadd_rn so that nvcc
// does not contract it into fused multiply-adds: f32 results are bitwise
// equal to the plain version's, bf16 ones too (loaded as f32, rounded once
// to nearest even), in every instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // apply_factored's block; ei_update's most
constexpr int kMaxK = 2;
constexpr int kMaxQ = 4;

struct EiArgs {
  const void* eps[kMaxQ];            // the q history rows, (B, k, D) each
  float psi[kMaxK * kMaxK];          // (k, k) row-major
  float C[kMaxQ * kMaxK * kMaxK];    // (q, k, k) row-major
};

// E consecutive elements of one row as a thread holds them: the four
// 32-bit words of one 16-byte load (E * sizeof(T) == 16), or the one
// element (E = 1; a bf16 in the low half of its word).
template <typename T, int E>
struct Slice {
  static constexpr bool kVector = E * sizeof(T) == 16;
  static_assert(kVector || E == 1, "E elements must fill one 16-byte word");
  unsigned w[kVector ? 4 : 1];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kVector) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (sizeof(T) == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  // element e as f32 (bf16 -> f32 is exact: its bits in the high half)
  __device__ __forceinline__ float operator[](int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {
      const unsigned x = w[e >> 1];
      return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
    }
  }
};

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T, int E>
__device__ __forceinline__ void store_slice(T* p, const float (&y)[E]) {
  if constexpr (Slice<T, E>::kVector) {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (sizeof(T) == 4)
        w[e] = __float_as_uint(y[e]);
      else if (e & 1)
        w[e >> 1] |= bf16_bits(y[e]) << 16;
      else
        w[e >> 1] = bf16_bits(y[e]);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float*>(p) = y[0];
  } else {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(y[0]);
  }
}

// out[b, c, d..d+E) = psi u + sum_j C_j eps_j: block (threads), grid
// (B, ceil(D / E / threads)).
template <typename T, int K, int Q, int E>
__global__ void __launch_bounds__(kThreads)
ei_update_kernel(int D, const T* __restrict__ u, T* __restrict__ out,
                 const EiArgs a) {
  const int d = (blockIdx.y * blockDim.x + threadIdx.x) * E;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.x * K * D + d;
  // every load first: (Q + 1) K independent accesses, none behind a branch
  Slice<T, E> x[Q + 1][K];
#pragma unroll
  for (int c = 0; c < K; ++c) x[0][c].load(u + base + (size_t)c * D);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const T* e = static_cast<const T*>(a.eps[j]) + base;
#pragma unroll
    for (int c = 0; c < K; ++c) x[j + 1][c].load(e + (size_t)c * D);
  }
  // keeps ptxas from sinking the later loads below the first product (it
  // does so in the k = 2 instances without it)
  __threadfence_block();
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float y[E];
#pragma unroll
    for (int v = 0; v < E; ++v) {
      float r = __fmul_rn(a.psi[c * K], x[0][0][v]);
#pragma unroll
      for (int c2 = 1; c2 < K; ++c2)
        r = __fadd_rn(r, __fmul_rn(a.psi[c * K + c2], x[0][c2][v]));
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int c2 = 0; c2 < K; ++c2)
          r = __fadd_rn(r, __fmul_rn(a.C[(j * K + c) * K + c2],
                                     x[j + 1][c2][v]));
      y[v] = r;
    }
    store_slice<T, E>(out + base + (size_t)c * D, y);
  }
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

// blocks along d: grid.y of the ei_update launch
inline int d_blocks(int D, int elems, int threads) {
  return (D / elems + threads - 1) / threads;
}

template <typename T, int K, int Q, int E>
cudaError_t launch_ei(const EiArgs& a, const void* u, void* out, int B,
                      int D, int threads, cudaStream_t s) {
  const dim3 grid((unsigned)B, (unsigned)d_blocks(D, E, threads));
  ei_update_kernel<T, K, Q, E><<<grid, threads, 0, s>>>(
      D, static_cast<const T*>(u), static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <typename T, int K, int Q>
cudaError_t launch_ei_e(const EiArgs& a, const void* u, void* out, int B,
                        int D, int elems, int threads, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);       // one 16-byte access
  if (elems == 1) return launch_ei<T, K, Q, 1>(a, u, out, B, D, threads, s);
  if (elems == V) return launch_ei<T, K, Q, V>(a, u, out, B, D, threads, s);
  return cudaErrorInvalidValue;
}

template <typename T, int K>
cudaError_t launch_ei_q(const EiArgs& a, const void* u, void* out, int B,
                        int D, int q, int elems, int threads, cudaStream_t s) {
  switch (q) {
    case 0: return launch_ei_e<T, K, 0>(a, u, out, B, D, elems, threads, s);
    case 1: return launch_ei_e<T, K, 1>(a, u, out, B, D, elems, threads, s);
    case 2: return launch_ei_e<T, K, 2>(a, u, out, B, D, elems, threads, s);
    case 3: return launch_ei_e<T, K, 3>(a, u, out, B, D, elems, threads, s);
    case 4: return launch_ei_e<T, K, 4>(a, u, out, B, D, elems, threads, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_ei_k(const EiArgs& a, const void* u, void* out, int B,
                        int k, int D, int q, int elems, int threads,
                        cudaStream_t s) {
  if (k == 1)
    return launch_ei_q<T, 1>(a, u, out, B, D, q, elems, threads, s);
  return launch_ei_q<T, 2>(a, u, out, B, D, q, elems, threads, s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// u, out: device pointers, (B, k, D); eps: a HOST array of q device
// pointers, each a (B, k, D) row; all of one dtype (0 = f32, 1 = bf16).
// psi (k * k) and C (q * k * k) f32 on the HOST.  Pointers, psi and C are
// copied into the launch's arguments.  elems: d a thread, 1 or (when every
// pointer is 16-byte aligned and elems divides D) 16 / sizeof(T); threads:
// a block, a multiple of 32 up to 256.  Any B >= 1; D / elems / threads
// (rounded up) at most 65535.
int repro_ei_update(const void* u, const void* const* eps, void* out,
                    const float* psi, const float* C, int B, int k, int D,
                    int q, int dtype, int elems, int threads, void* stream) {
  if (B < 1 || D < 1 || k < 1 || k > kMaxK || q < 0 || q > kMaxQ ||
      (dtype != 0 && dtype != 1) || elems < 1 || D % elems != 0 ||
      threads < 32 || threads > kThreads || threads % 32 != 0 ||
      d_blocks(D, elems, threads) > 65535)
    return (int)cudaErrorInvalidValue;
  EiArgs a = {};
  for (int j = 0; j < q; ++j) a.eps[j] = eps[j];
  for (int e = 0; e < k * k; ++e) a.psi[e] = psi[e];
  for (int e = 0; e < q * k * k; ++e) a.C[e] = C[e];
  if (elems > 1) {
    bool aligned = ((size_t)u | (size_t)out) % 16 == 0;
    for (int j = 0; j < q; ++j) aligned = aligned && (size_t)eps[j] % 16 == 0;
    if (!aligned) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)launch_ei_k<__nv_bfloat16>(a, u, out, B, k, D, q, elems,
                                           threads, s);
  return (int)launch_ei_k<float>(a, u, out, B, k, D, q, elems, threads, s);
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
