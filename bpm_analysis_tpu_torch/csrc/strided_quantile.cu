// Strided rolling-quantile anchors of a dense series — CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bpm_analysis_tpu/ops/pallas/quantile_kernel.py
// (_kernel, called through strided_quantile_anchors_pallas).  For each row b
// of a (B, n) float32 series and each anchor a (position a*stride) it computes
// the pandas centered rolling quantile q over the window
// [a*stride - left, a*stride + right] (window = left + right + 1), with
// min_periods:
//
//   * Keys are the raw float32 bits.  A sample is valid when its bits, read
//     as unsigned, are below 0x7F800000 (+inf): NaN, +inf, negative values
//     and -0.0 are missing, as in the TPU kernel (quantile_kernel.py:82), and
//     so is everything outside [0, n).  The input must therefore be
//     non-negative (envelope-derived series are); the wrapper does not scan
//     values.  (The "xla" path ops/quantile.rolling_quantile_centered_strided
//     counts +inf as valid; envelope-derived series never hold it.)
//   * pos = q * float(max(count - 1, 0)) in float32, k_lo = floor(pos),
//     frac = pos - k_lo.  A 32-plane radix select on the keys finds v_lo, the
//     k_lo-th smallest valid value.  The next order statistic v_hi is v_lo
//     itself when #valid <= v_lo reaches k_lo + 2, else the smallest valid
//     key above it (+inf if none).
//   * The result is v_lo + frac * (v_hi - v_lo) when frac > 0, else v_lo, as
//     a separate multiply and add (no contraction: the build passes
//     --fmad=false and the code uses __fmul_rn/__fadd_rn); NaN when
//     count < min_periods or count == 0.
// With that the kernel equals its plain version
// (ops/cuda/quantile_kernel.plain_anchors) bit for bit.
//
// What bounds it on this card: the least work of the function, not of this
// kernel's algorithm.  A select over each anchor's window keys needs, with a
// histogram of 8-bit digits in 4 rounds, per in-row key and round a digit
// extraction, a compare with the prefix chosen so far and a histogram
// increment (3 operations), plus once per key the clamp of missing keys to
// one sentinel (1): 13 operations per key; per anchor, each round scans 256
// bins (an add and a compare each), 2048 operations, and the next order
// statistic falls out of the last round's histogram.  At the engine
// configuration (16 rows x 2832 anchors, 1.36e8 in-row keys) that is 1.86e9
// operations.  H100 SXM issues at most one warp instruction per scheduler
// per clock, 4 x 32 = 128 lane operations per SM per clock, whichever pipe
// takes them (int32 adds and moves also go as IMAD to the FMA pipe beside
// the 64 int32 lanes): 132 SMs x 128 x 1.98 GHz = 33.5e12 operations/s, so
// ~0.056 ms per launch.  Device memory traffic is small: the series is read
// once (11.6 MB, 3.5 us at 3.35 TB/s), and each block's window is served
// from L2, since neighbouring anchors' windows overlap by 98%.  A design
// that reuses neighbouring windows' selections could go below this bound.
//
// Design (simple first): one block per (anchor, row), blockDim threads
// (128 unless the window needs more, in whole warps up to 1024), each thread
// holding kKeysPerThread = 24 window keys in registers (thread t holds
// offsets t, t + blockDim, ...: the loads are coalesced).  Each of the 32
// planes is a per-thread count plus a block reduction: warp shuffles, one
// partial per warp in shared memory (double-buffered, so one __syncthreads
// per round).  The valid count, the count at v_lo and the next-key min
// reduce the same way.  That is about 8x the bound's operations per key (32
// planes x 3 + 7 = 103 against 13), mostly on the 64-lane int32 pipe at half
// the issue rate: ~16x the bound's time before any latency is counted.
// The TPU kernel's anchor groups (a mod 128/stride), 128-shifted static
// slices, 8-row tiles and 1024-aligned DMA padding existed only because
// Mosaic rejects unaligned dynamic loads; none of it is carried over, and
// any stride works.  Staging an anchor tile's keys once in shared memory and
// the histogram select with 8-bit digits are left for a later version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kInfBits = 0x7F800000u;   // +inf; keys >= are missing
constexpr uint32_t kMissing = 0xFFFFFFFFu;   // what a missing key is held as
// 24 keys per thread: a 128-thread block holds the engine's 3020-key window,
// and 1024 threads hold windows up to 24,576 keys.
constexpr int kKeysPerThread = 24;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_min(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Block-wide sum (is_min false) or min of v, returned to every thread.
// ``buf`` alternates between the two halves of ``red`` from one round to the
// next: a warp that runs ahead into round r+1 writes the other half while
// slower warps still read round r's partials.
__device__ __forceinline__ uint32_t block_reduce(uint32_t v, bool is_min,
                                                 uint32_t (*red)[32], int buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = is_min ? warp_min(v) : warp_sum(v);
  if (lane == 0) red[buf][warp] = v;
  __syncthreads();
  uint32_t r = red[buf][0];
  for (int w = 1; w < nwarps; ++w) r = is_min ? min(r, red[buf][w]) : r + red[buf][w];
  return r;
}

__global__ void strided_quantile_kernel(const float* __restrict__ x,
                                        float* __restrict__ out, int n,
                                        int window, int left, int stride,
                                        int n_anchor, float q, int min_periods) {
  __shared__ uint32_t red[2][32];
  const int a = blockIdx.x;
  const int b = blockIdx.y;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long start = (long long)a * stride - left;
  const float* row = x + (size_t)b * n;

  uint32_t key[kKeysPerThread];
  uint32_t local = 0;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int off = tid + i * T;
    const long long p = start + off;
    uint32_t k = kMissing;
    if (off < window && p >= 0 && p < n) {
      const uint32_t bits = __float_as_uint(__ldg(row + p));
      if (bits < kInfBits) k = bits;
    }
    key[i] = k;
    local += (k != kMissing);
  }
  int round = 0;
  const int count = (int)block_reduce(local, false, red, round++ & 1);

  float result = __int_as_float(0x7FC00000);   // NaN
  if (count > 0 && count >= min_periods) {     // uniform across the block
    const float pos = __fmul_rn(q, (float)(count - 1));
    const float kf = floorf(pos);
    const int k_lo = (int)kf;
    const float frac = __fsub_rn(pos, kf);

    // Radix select, most significant plane first.  While plane `bit` is
    // decided the prefix's bit is 0, so a key is a still-matching key with
    // a 0 there exactly when key >> bit == prefix >> bit; missing keys (all
    // ones) never match.
    uint32_t prefix = 0u;
    int k = k_lo;
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t pb = prefix >> bit;
      uint32_t c = 0;
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) c += ((key[i] >> bit) == pb);
      const int c0 = (int)block_reduce(c, false, red, round++ & 1);
      if (k >= c0) {
        k -= c0;
        prefix |= 1u << bit;
      }
    }

    // The next order statistic: the count of valid keys <= v_lo (missing
    // keys are above every valid prefix) and the smallest key above it.
    uint32_t le = 0, above = kMissing;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      le += (key[i] <= prefix);
      if (key[i] > prefix) above = min(above, key[i]);
    }
    const int cnt_le = (int)block_reduce(le, false, red, round++ & 1);
    const uint32_t nxt = min(block_reduce(above, true, red, round++ & 1), kInfBits);

    const float v_lo = __uint_as_float(prefix);
    const float v_hi = (cnt_le >= k_lo + 2) ? v_lo : __uint_as_float(nxt);
    result = (frac > 0.0f) ? __fadd_rn(v_lo, __fmul_rn(frac, __fsub_rn(v_hi, v_lo)))
                           : v_lo;
  }
  if (tid == 0) out[(size_t)b * n_anchor + a] = result;
}

}  // namespace

extern "C" int strided_quantile_anchors(const float* x, float* out, int batch,
                                        int n, int window, int left, int stride,
                                        int n_anchor, float q, int min_periods,
                                        void* stream) {
  if (window > kMaxThreads * kKeysPerThread) return (int)cudaErrorInvalidValue;
  // As many whole warps as the window needs, at least 4.
  const int warps = (window + 32 * kKeysPerThread - 1) / (32 * kKeysPerThread);
  const int threads = warps < 4 ? 128 : warps * 32;
  dim3 grid(n_anchor, batch);
  strided_quantile_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      x, out, n, window, left, stride, n_anchor, q, min_periods);
  return (int)cudaGetLastError();
}

extern "C" const char* strided_quantile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
