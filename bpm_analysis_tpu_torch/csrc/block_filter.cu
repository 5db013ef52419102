// The blocked IIR filter (scipy lfilter per row) — CUDA kernel for Hopper (sm_90a).
//
// The counterpart of ops/filter.lfilter_plain, the port's fixed-order form of
// bpm_analysis_tpu/ops/filter.py:136's blocked lfilter (an XLA computation in the
// JAX package, not a Pallas kernel).  The recurrence s[n] = A s[n-1] + B x[n]
// is split into length-L blocks: each block's carry contribution
// C[k] = X[k] @ U, the carry scan S0[k+1] = S0[k] @ A_L^T + C[k] from the
// row's initial state, and each output y[i] = (b0 x[i] + S0[k] @ G^T[:, i])
// + sum_d h[d] x[i-1-d] inside its block.
//
// Every product is a sum in the plain version's fixed order: the terms of
// X @ U, S0 @ A_L^T and S0 @ G^T in ascending index, the Toeplitz lags d in
// ascending order from 0, each multiply and add separate (--fmad=false), so
// the kernel is bit-equal to the plain version and each row's output is a
// function of that row alone, whatever the batch.
//
// What bounds it on this card: operations.  Memory traffic is the row in
// and out once (16 x 181,230 float32: 23 MB, 7 us at 3.35 TB/s); the work
// is ~L + 4m + 1 unfused operations a sample (the in-block Toeplitz sum
// averages (L-1)/2 multiply-add pairs), ~0.8 G operations a batch.  The
// carry scan is a chain of nb steps on one thread per row (708 steps of a
// 2m-operation chain at L = 256, ~10 us), beside which the other phases
// are wide.
//
// Design, a first simple version: one 256-thread block per row; the tables
// (U, G^T, the lags h, A_L^T) in shared memory; phase 1, a thread per
// block computes C[k]; phase 2, thread 0 runs the carry scan, replacing
// C[k] by the carry-in S0[k] in place; phase 3, a thread per output sample
// computes y[i].  Templated on the scalar type.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_filter_kernel(const T* __restrict__ x, const T* __restrict__ zi,
                    const T* __restrict__ tables, T* __restrict__ carry,
                    T* __restrict__ y, int n, int L, int nb, int m, T b0) {
  extern __shared__ unsigned char smem_raw[];
  T* U = reinterpret_cast<T*>(smem_raw);   // (L, m)
  T* GT = U + L * m;                        // (m, L)
  T* h = GT + m * L;                        // (L): h[0 .. L-2]
  T* A_LT = h + L;                          // (m, m)
  const int total = 2 * L * m + L + m * m;
  for (int i = threadIdx.x; i < total; i += blockDim.x) U[i] = tables[i];
  __syncthreads();

  const int r = blockIdx.x;
  const T* xr = x + (size_t)r * n;
  T* C = carry + (size_t)r * nb * m;

  // Phase 1: C[k] = X[k] @ U, terms in ascending i (the padded tail is 0).
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    T acc[kMaxM];
    const int base = k * L;
    const T x0 = base < n ? xr[base] : T(0);
#pragma unroll
    for (int j = 0; j < kMaxM; ++j)
      if (j < m) acc[j] = x0 * U[j];
    for (int i = 1; i < L; ++i) {
      const T xi = base + i < n ? xr[base + i] : T(0);
#pragma unroll
      for (int j = 0; j < kMaxM; ++j)
        if (j < m) acc[j] = acc[j] + xi * U[i * m + j];
    }
#pragma unroll
    for (int j = 0; j < kMaxM; ++j)
      if (j < m) C[k * m + j] = acc[j];
  }
  __syncthreads();

  // Phase 2: the carry scan; C[k] becomes the carry-in of block k.
  if (threadIdx.x == 0) {
    T s[kMaxM];
#pragma unroll
    for (int j = 0; j < kMaxM; ++j)
      if (j < m) s[j] = zi[(size_t)r * m + j];
    for (int k = 0; k < nb; ++k) {
      T ns[kMaxM];
#pragma unroll
      for (int j = 0; j < kMaxM; ++j) {
        if (j < m) {
          T acc = s[0] * A_LT[j];
          for (int q = 1; q < m; ++q) acc = acc + s[q] * A_LT[q * m + j];
          ns[j] = acc + C[k * m + j];
          C[k * m + j] = s[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxM; ++j)
        if (j < m) s[j] = ns[j];
    }
  }
  __syncthreads();

  // Phase 3: y[i] = (b0 x[i] + S0[k] @ G^T[:, i]) + sum_d h[d] x[i-1-d].
  T* yr = y + (size_t)r * n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int k = idx / L;
    const int i = idx - k * L;
    const T* S0 = C + k * m;
    T p = S0[0] * GT[i];
    for (int q = 1; q < m; ++q) p = p + S0[q] * GT[q * L + i];
    T t = T(0);
    for (int d = 0; d < i; ++d) t = t + xr[idx - 1 - d] * h[d];
    yr[idx] = (b0 * xr[idx] + p) + t;
  }
}

template <typename T>
int launch(const T* x, const T* zi, const T* tables, T* carry, T* y, int bsz, int n, int L,
           int m, T b0, void* stream) {
  const int nb = (n + L - 1) / L;
  const size_t smem = (size_t)(2 * L * m + L + m * m) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      block_filter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_filter_kernel<T><<<bsz, kThreads, smem, (cudaStream_t)stream>>>(
      x, zi, tables, carry, y, n, L, nb, m, b0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_filter_f32(const float* x, const float* zi, const float* tables,
                                float* carry, float* y, int bsz, int n, int L, int m,
                                float b0, void* stream) {
  return launch<float>(x, zi, tables, carry, y, bsz, n, L, m, b0, stream);
}

extern "C" int block_filter_f64(const double* x, const double* zi, const double* tables,
                                double* carry, double* y, int bsz, int n, int L, int m,
                                double b0, void* stream) {
  return launch<double>(x, zi, tables, carry, y, bsz, n, L, m, b0, stream);
}

extern "C" const char* block_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
