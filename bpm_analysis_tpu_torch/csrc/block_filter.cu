// The blocked IIR filter (scipy lfilter per row) — CUDA kernels for Hopper (sm_90a).
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
// the kernels are bit-equal to the plain version and each row's output is a
// function of that row alone, whatever the batch.  The three phases are also
// entry points of their own (the BlockFilter pieces that the sequence-sharded
// relay of parallel/seqshard.py calls between its exchanges).
//
// What bounds it on this card: operations, and one serial chain.  Memory
// traffic is the row in and out once (16 x 181,230 float32: 23 MB, 7 us at
// 3.35 TB/s); the work is ~L + 4m + 1 unfused operations a sample (the
// in-block Toeplitz sum averages (L-1)/2 multiply-add pairs), ~0.8 G
// operations a batch, ~12 us at the float32 peak.  The carry scan is the only
// serial part: one chain of nb steps a row, each step m + 1 dependent
// operations (a product's multiply, its m - 1 adds, + C[k]): 708 steps at the
// engine shapes, ~7 us at 4 cycles an operation, 8,494 on a two-hour row.
//
// Design: three launches a call, each with the whole card.
//   * Contributions: a grid over (tile of kTile L-blocks, row).  The tile of
//     x is staged in shared memory with 16-byte loads, neighbouring threads on
//     neighbouring addresses, each L-row padded by one element so that the
//     threads' column walks hit distinct banks; U is staged beside it.  Each
//     thread keeps one block's m accumulators in registers (templated on m).
//   * Carry scan: one warp a row.  Lane 0 runs the chain with A_L^T and the
//     state in registers (templated on m); the warp loads the next chunk of
//     C into registers while lane 0 walks the current one from shared
//     memory, then stores it there.  Lane 0 writes each carry-in S0[k]; the
//     exit state goes out at the end.  May run in place (S0 over C).
//   * Apply: a grid over (L-block, row).  The block's x (behind kR zeros),
//     the lags h (zero past L - 2) and S0[k] are staged in shared memory.
//     Each thread computes kR consecutive outputs over a sliding window of x
//     in registers: one shared load of h[d] (the same word for the whole
//     warp) and one of x feed kR chains.  A
//     thread runs every chain to the lag count of its last output; the terms
//     past an output's own lags multiply a zero of the padding, and adding
//     0 * h to a sum that started at +0 leaves it unchanged (such a sum is
//     never -0), so each output's sum is its ascending sum bit for bit.
// Templated on the scalar type.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 64;      // L-blocks per contributions CTA, one a thread
constexpr int kChunk = 64;     // carry steps per staged chunk of C
constexpr int kR = 4;          // outputs per apply thread

// The table layout the wrapper writes: U (L, m), G^T (m, L), h (L; h[L-1] = 0),
// A_L^T (m, m).
template <typename T> struct Tables {
  const T *U, *GT, *h, *A_LT;
  __device__ Tables(const T* t, int L, int m)
      : U(t), GT(t + L * m), h(t + 2 * L * m), A_LT(t + 2 * L * m + L) {}
};

// xs[i + i / L] = (i < valid ? src[i] : 0) for i in [0, len): the tile's
// L-rows, each padded by one element.  Scalar loads up to src's first 16-byte
// boundary and after its last full 16-byte word, 16-byte loads between (one
// division by L per 16 bytes: the word's elements wrap into the next row at
// most once).
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int valid, int len,
                                           T* xs, int L) {
  constexpr int V = 16 / sizeof(T);
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = min(valid, (V - mis) % V);
  const int nvec = (valid - head) / V;
  const int tail = head + nvec * V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) xs[i + i / L] = src[i];
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const uint4 w = __ldg(vsrc + v);
    T e[V];
    memcpy(e, &w, sizeof(w));
    const int i = head + v * V;
    const int row = i / L, col = i - row * L;
#pragma unroll
    for (int q = 0; q < V; ++q) xs[i + q + row + (col + q >= L ? 1 : 0)] = e[q];
  }
  for (int i = tail + threadIdx.x; i < len; i += blockDim.x)
    xs[i + i / L] = i < valid ? src[i] : T(0);
}

// Phase 1: C[k] = X[k] @ U, terms in ascending i (the padded tail is 0).
template <typename T, int M>
__global__ void __launch_bounds__(kTile)
contributions_kernel(const T* __restrict__ x, const T* __restrict__ tables,
                     T* __restrict__ C, int n, int L, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Us = reinterpret_cast<T*>(smem_raw);   // (L, M)
  T* xs = Us + L * M;                       // kTile rows of L + 1
  const Tables<T> tb(tables, L, M);
  const int r = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int nblk = min(kTile, nb - k0);
  for (int i = threadIdx.x; i < L * M; i += blockDim.x) Us[i] = tb.U[i];
  const int g0 = k0 * L;
  stage_tile(x + (size_t)r * n + g0, min(nblk * L, n - g0), nblk * L, xs, L);
  __syncthreads();
  if (threadIdx.x >= nblk) return;

  const T* row = xs + threadIdx.x * (L + 1);
  T acc[M];
  const T x0 = row[0];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = x0 * Us[j];
#pragma unroll 4
  for (int i = 1; i < L; ++i) {
    const T xi = row[i];
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = acc[j] + xi * Us[i * M + j];
  }
  T* out = C + ((size_t)r * nb + k0 + threadIdx.x) * M;
#pragma unroll
  for (int j = 0; j < M; ++j) out[j] = acc[j];
}

// Phase 2: the carry scan; S0[k] is the state entering block k.
template <typename T, int M>
__global__ void __launch_bounds__(32)
carry_kernel(const T* C, const T* __restrict__ s_in, const T* __restrict__ tables, T* S0,
             T* __restrict__ s_out, int nb, int L) {
  __shared__ T buf[2][kChunk * M];
  constexpr int kPer = kChunk * M / 32;      // values a lane stages per chunk
  const Tables<T> tb(tables, L, M);
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const T* Cr = C + (size_t)r * nb * M;
  T* Sr = S0 + (size_t)r * nb * M;
  const int total = nb * M;
  const int nchunk = (nb + kChunk - 1) / kChunk;

  T a[M][M], s[M];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    s[q] = s_in[(size_t)r * M + q];
#pragma unroll
    for (int j = 0; j < M; ++j) a[q][j] = tb.A_LT[q * M + j];
  }
  T reg[kPer];
  auto load = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = c * kChunk * M + i * 32 + lane;
      reg[i] = v < total ? Cr[v] : T(0);
    }
  };
  auto store = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) buf[c & 1][i * 32 + lane] = reg[i];
  };
  load(0);
  store(0);
  __syncwarp();
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) load(c + 1);   // in flight while lane 0 runs chunk c
    if (lane == 0) {
      const T* cb = buf[c & 1];
      const int k0 = c * kChunk;
      const int steps = min(kChunk, nb - k0);
#pragma unroll 4
      for (int u = 0; u < steps; ++u) {
        T ns[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          T acc = s[0] * a[0][j];
#pragma unroll
          for (int q = 1; q < M; ++q) acc = acc + s[q] * a[q][j];
          ns[j] = acc + cb[u * M + j];
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          Sr[(size_t)(k0 + u) * M + j] = s[j];
          s[j] = ns[j];
        }
      }
    }
    __syncwarp();
    if (c + 1 < nchunk) store(c + 1);
    __syncwarp();
  }
  if (lane == 0 && s_out != nullptr) {
#pragma unroll
    for (int j = 0; j < M; ++j) s_out[(size_t)r * M + j] = s[j];
  }
}

// Phase 3: y[i] = (b0 x[i] + S0[k] @ G^T[:, i]) + sum_d h[d] x[i-1-d].
template <typename T>
__global__ void apply_kernel(const T* __restrict__ x, const T* __restrict__ S0,
                             const T* __restrict__ tables, T* __restrict__ y, int n, int L,
                             int nb, int m, T b0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // kR zeros, L samples (0 past n), kR zeros
  T* hs = xs + L + 2 * kR;                  // h[0 .. L-2], then zeros to L + kR
  T* ss = hs + L + kR;                      // S0[k]
  const Tables<T> tb(tables, L, m);
  const int k = blockIdx.x, r = blockIdx.y;
  const int base = k * L;
  const int valid = min(L, n - base);
  const T* xr = x + (size_t)r * n + base;
  for (int i = threadIdx.x; i < L + 2 * kR; i += blockDim.x) {
    const int j = i - kR;
    xs[i] = (j >= 0 && j < valid) ? xr[j] : T(0);
  }
  for (int i = threadIdx.x; i < L + kR; i += blockDim.x) hs[i] = i < L - 1 ? tb.h[i] : T(0);
  if (threadIdx.x < m) ss[threadIdx.x] = S0[((size_t)r * nb + k) * m + threadIdx.x];
  __syncthreads();
  const int i0 = threadIdx.x * kR;
  if (i0 >= valid) return;

  const T* X = xs + kR;                     // X[-kR .. -1] = 0
  T w[kR], t[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    w[q] = X[i0 + q - 1];                   // w[q] = X[i0 + q - 1 - d]
    t[q] = T(0);
  }
  const int nd = i0 + kR - 1;               // the lags of output i0 + kR - 1
#pragma unroll 4
  for (int d = 0; d < nd; ++d) {
    const T hd = hs[d];
#pragma unroll
    for (int q = 0; q < kR; ++q) t[q] = t[q] + w[q] * hd;
#pragma unroll
    for (int q = kR - 1; q > 0; --q) w[q] = w[q - 1];
    w[0] = X[i0 - 2 - d];
  }
  T* yr = y + (size_t)r * n + base;
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int i = i0 + q;
    if (i < valid) {
      T p = ss[0] * tb.GT[i];
      for (int j = 1; j < m; ++j) p = p + ss[j] * tb.GT[j * L + i];
      yr[i] = (b0 * X[i] + p) + t[q];
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int contributions(const T* x, const T* tables, T* C, int bsz, int n, int L, int m,
                  cudaStream_t stream) {
  const int nb = (n + L - 1) / L;
  const size_t smem = (size_t)(kTile * (L + 1) + L * m) * sizeof(T);
  const dim3 grid((nb + kTile - 1) / kTile, bsz);
#define CONTRIBUTIONS_CASE(M)                                                           \
  case M:                                                                               \
    if (int err = set_smem((const void*)contributions_kernel<T, M>, smem)) return err;  \
    contributions_kernel<T, M><<<grid, kTile, smem, stream>>>(x, tables, C, n, L, nb);  \
    break;
  switch (m) {
    CONTRIBUTIONS_CASE(1) CONTRIBUTIONS_CASE(2) CONTRIBUTIONS_CASE(3) CONTRIBUTIONS_CASE(4)
    CONTRIBUTIONS_CASE(5) CONTRIBUTIONS_CASE(6) CONTRIBUTIONS_CASE(7) CONTRIBUTIONS_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CONTRIBUTIONS_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int carry(const T* C, const T* s_in, const T* tables, T* S0, T* s_out, int bsz, int nb,
          int L, int m, cudaStream_t stream) {
#define CARRY_CASE(M)                                                                   \
  case M:                                                                               \
    carry_kernel<T, M><<<bsz, 32, 0, stream>>>(C, s_in, tables, S0, s_out, nb, L);      \
    break;
  switch (m) {
    CARRY_CASE(1) CARRY_CASE(2) CARRY_CASE(3) CARRY_CASE(4)
    CARRY_CASE(5) CARRY_CASE(6) CARRY_CASE(7) CARRY_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CARRY_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const T* x, const T* S0, const T* tables, T* y, int bsz, int n, int L, int m,
          T b0, cudaStream_t stream) {
  const int nb = (n + L - 1) / L;
  const size_t smem = (size_t)(2 * L + 3 * kR + m) * sizeof(T);
  const int threads = ((L + kR - 1) / kR + 31) / 32 * 32;
  const dim3 grid(nb, bsz);
  apply_kernel<T><<<grid, threads, smem, stream>>>(x, S0, tables, y, n, L, nb, m, b0);
  return (int)cudaGetLastError();
}

template <typename T>
int lfilter(const T* x, const T* zi, const T* tables, T* carry_buf, T* y, int bsz, int n,
            int L, int m, T b0, cudaStream_t stream) {
  const int nb = (n + L - 1) / L;
  if (int err = contributions<T>(x, tables, carry_buf, bsz, n, L, m, stream)) return err;
  if (int err = carry<T>(carry_buf, zi, tables, carry_buf, nullptr, bsz, nb, L, m, stream))
    return err;
  return apply<T>(x, carry_buf, tables, y, bsz, n, L, m, b0, stream);
}

}  // namespace

#define BLOCK_FILTER_ENTRIES(T, SUFFIX)                                                    \
  extern "C" int block_filter_##SUFFIX(const T* x, const T* zi, const T* tables,           \
                                       T* carry_buf, T* y, int bsz, int n, int L, int m,   \
                                       T b0, void* stream) {                               \
    return lfilter<T>(x, zi, tables, carry_buf, y, bsz, n, L, m, b0,                       \
                      (cudaStream_t)stream);                                               \
  }                                                                                        \
  extern "C" int block_filter_contributions_##SUFFIX(const T* x, const T* tables, T* C,    \
                                                     int bsz, int n, int L, int m,         \
                                                     void* stream) {                       \
    return contributions<T>(x, tables, C, bsz, n, L, m, (cudaStream_t)stream);             \
  }                                                                                        \
  extern "C" int block_filter_carry_##SUFFIX(const T* C, const T* s_in, const T* tables,   \
                                             T* S0, T* s_out, int bsz, int nb, int L,      \
                                             int m, void* stream) {                        \
    return carry<T>(C, s_in, tables, S0, s_out, bsz, nb, L, m, (cudaStream_t)stream);      \
  }                                                                                        \
  extern "C" int block_filter_apply_##SUFFIX(const T* x, const T* S0, const T* tables,     \
                                             T* y, int bsz, int n, int L, int m, T b0,     \
                                             void* stream) {                               \
    return apply<T>(x, S0, tables, y, bsz, n, L, m, b0, (cudaStream_t)stream);             \
  }

BLOCK_FILTER_ENTRIES(float, f32)
BLOCK_FILTER_ENTRIES(double, f64)

extern "C" const char* block_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
