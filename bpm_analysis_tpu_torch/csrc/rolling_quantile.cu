// Exact centered rolling quantile of each row of a (B, n) batch — CUDA kernel
// for Hopper (sm_90a).
//
// Replaces an XLA computation of the JAX package, not a Pallas kernel:
// bpm_analysis_tpu/ops/quantile.py rolling_quantile_centered, a wavelet tree
// over each row's value ranks.  Its eager PyTorch form
// (ops/quantile.rolling_quantile_centered_plain) builds 18 levels of
// (B, n + 1) int64 prefix counts and walks them twice, ~3,200 launches a
// call, each a pass over the whole batch.  For every output i of row b it
// computes, in the row's dtype T, pandas'
// rolling(window, min_periods, center=True).quantile(q):
//
//   * the window [i - left, i + right] cut at the row's ends, left =
//     window / 2, right = (window - 1) / 2; NaN is missing and ranks as
//     +inf, ties (-0.0 and +0.0 among them) in position order, as the plain
//     version's stable argsort orders them;
//   * cnt = the window's valid count, pos = q * T(max(cnt - 1, 0)),
//     k_lo = floor(pos), k_hi = min(k_lo + 1, max(cnt - 1, 0)),
//     frac = pos - T(k_lo), with q already rounded to T by the caller;
//   * v_lo, v_hi = the k_lo-th and k_hi-th smallest of the window in that
//     order, out = v_lo + frac * (v_hi - v_lo) when frac > 0 as a separate
//     subtract, multiply and add (the build passes --fmad=false and the code
//     uses the _rn intrinsics), else v_lo;
//   * NaN where cnt < min_periods.
// A selection is exact whatever algorithm finds it and the float operations
// are the plain version's, so the kernel equals it bit for bit.
//
// What bounds it on this card: the least work reads each row once and
// writes each output once, 2 * B * n * sizeof(T) bytes: 742 MB at the exact
// cell's (256, 181,200) float64, 0.22 ms at 3.35 TB/s.  In practice the
// sort below bounds it: ~P/2 * log2(P) * (log2(P) + 1) / 2 compare-exchanges
// a block.
//
// Design: tile-local order statistics.
//   * A job is a (row, tile of `tile` consecutive outputs).  The tile's
//     windows only look at the union of their positions, at most
//     tile + window - 1 <= P = 2^log_union of them, so no structure over
//     the whole row is built: the row is read about
//     (tile + window - 1) / tile times and written once.
//   * A union of up to 8,192 positions lives in shared memory, one block a
//     job, 16-bit indices.  A larger one (a window above 7,937 samples, or
//     a whole row past 8,192 when the window covers it) lives in a global
//     scratch region of its block, 32-bit indices, and each block loops
//     over jobs; the caller sizes the scratch and the grid.  The code is
//     one for both.
//   * The union is loaded once (coalesced), NaN replaced by +inf, and
//     padded to P with +inf at positions past the union; a prefix count
//     of the valid values gives each window's cnt.
//   * A bitonic sort of the (value, position) pairs orders the union by
//     float comparison, then position: the strides below 8 run in
//     registers on 8 consecutive elements a thread, the larger ones in
//     memory, whose arrays are padded by one element every 8 so that a
//     warp's 8-element loads fall in distinct shared-memory banks.
//   * A wavelet matrix over the local ranks (log2 P bit planes, each with
//     32-bit words and a prefix count of ones a word) answers a window's
//     k-th smallest in log2 P steps of two popcounts: a thread takes one
//     output at a time, selects v_lo (and v_hi only when frac > 0) and
//     writes the output once.
//   * The wrapper (ops/cuda/rolling_quantile_kernel.py) chooses P and the
//     tile from the window, the batch, the row length and the SM count.
//   * Templated on float and double.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPer = 8;                  // consecutive elements a thread sorts in registers
constexpr int kMaxThreads = 1024;
constexpr int kMinLogUnion = 8;          // one warp
constexpr int kMaxSharedLogUnion = 13;   // kPer * 1024 threads, in shared memory
constexpr int kMaxLogUnion = 30;         // in global scratch
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float of(int i) { return __int2float_rn(i); }
  __device__ static int floor_int(float v) { return (int)floorf(v); }
};

template <>
struct Num<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double of(int i) { return __int2double_rn(i); }
  __device__ static int floor_int(double v) { return (int)floor(v); }
};

// Byte offsets of a block's arrays for a union of P positions with indices
// of `idx` bytes: in shared memory at the largest shared union, 8192
// positions, 145,008 bytes in float64 and 108,144 in float32, within the
// 232,448 a block may use, so the thread count and not the dtype sets the
// limit.
struct Layout {
  size_t vals, pos, seq, vpre, bits, pre, total;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int log_union, size_t elem, size_t idx) {
  const size_t P = size_t(1) << log_union;
  const size_t padded = P + P / kPer;
  const size_t words = P / 32 + 1;
  Layout l;
  size_t o = 0;
  l.vals = o;    o = align16(o + padded * elem);                // values, sorted in place
  l.pos = o;     o = align16(o + padded * idx);                 // positions; the build's 2nd buffer
  l.seq = o;     o = align16(o + P * idx);                      // local rank by position
  l.vpre = o;    o = align16(o + (P + 1) * idx);                // valid count before a position
  l.bits = o;    o = align16(o + log_union * words * 4);        // bit planes
  l.pre = o;     o = align16(o + log_union * words * idx);      // ones before each word
  l.total = o;
  return l;
}

// Index of element i in a padded array: one spare slot after every kPer.
__device__ __forceinline__ int ix(int i) { return i + i / kPer; }

// (value, position) order: float comparison, then position.
template <typename T>
__device__ __forceinline__ bool before(T av, int ap, T bv, int bp) {
  return av < bv || (av == bv && ap < bp);
}

// Exclusive scan of one int a thread over the block; ``total`` the sum.
// Every thread of the block calls it; it ends after a barrier, so that
// ``scratch`` may be reused at once.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before_warp = 0, sum = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    const int s = scratch[w];
    if (w < warp) before_warp += s;
    sum += s;
  }
  __syncthreads();
  *total = sum;
  return before_warp + incl - v;
}

// Ones of bit plane (bw, pw) before position i (i <= P).
template <typename Idx>
__device__ __forceinline__ int rank1(const uint32_t* bw, const Idx* pw, int i) {
  const int w = i >> 5;
  return (int)pw[w] + __popc(bw[w] & ((1u << (i & 31)) - 1u));
}

// The k-th smallest of local positions [lo, hi) by (value, position): one
// step a bit plane, top bit first, with the rank's bits chosen on the way.
template <typename T, typename Idx>
__device__ __forceinline__ T kth(const T* vals, const uint32_t* bits, const Idx* pre, int L,
                                 int lo, int hi, int k) {
  const int P = 1 << L;
  const int words = P / 32 + 1;
  int r = 0;
  for (int d = 0; d < L; ++d) {
    const uint32_t* bw = bits + (size_t)d * words;
    const Idx* pw = pre + (size_t)d * words;
    const int olo = rank1(bw, pw, lo), ohi = rank1(bw, pw, hi);
    const int z = (hi - lo) - (ohi - olo);
    if (k < z) {
      lo -= olo;
      hi -= ohi;
    } else {
      const int zeros = P - (int)pw[P >> 5];
      k -= z;
      lo = zeros + olo;
      hi = zeros + ohi;
      r |= 1 << (L - 1 - d);
    }
  }
  return vals[ix(r)];
}

// kShared: the arrays in dynamic shared memory with 16-bit indices, one job
// a block; else in the block's region of `scratch` with 32-bit indices.
template <typename T, typename Idx, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
rolling_quantile_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int left,
                        int right, T q, int min_periods, int tile, int tiles, long long jobs,
                        int log_union, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[kMaxThreads / 32];
  const Layout lay = layout(log_union, sizeof(T), sizeof(Idx));
  unsigned char* base = kShared ? smem : scratch + (size_t)blockIdx.x * lay.total;
  T* vals = reinterpret_cast<T*>(base + lay.vals);
  Idx* pos = reinterpret_cast<Idx*>(base + lay.pos);
  Idx* seq = reinterpret_cast<Idx*>(base + lay.seq);
  Idx* vpre = reinterpret_cast<Idx*>(base + lay.vpre);
  uint32_t* bits = reinterpret_cast<uint32_t*>(base + lay.bits);
  Idx* pre = reinterpret_cast<Idx*>(base + lay.pre);

  const int L = log_union;
  const int P = 1 << L;
  const int W = P >> 5;                         // words of a bit plane
  const int words = W + 1;
  const int t = threadIdx.x;
  const int nt = blockDim.x;                    // min(1024, P / kPer): divides P
  const int lane = t & 31;
  // Positions a thread counts, words a thread counts, and the stride of
  // its 8-element groups: known at compile time in shared memory, where
  // nt = P / kPer.
  const int chunk = kShared ? kPer : P / nt;
  const int wper = kShared ? 1 : (W + nt - 1) / nt;
  const int group_step = kShared ? P : nt * kPer;

  for (long long job = blockIdx.x; job < jobs; job += gridDim.x) {
    const long long b = job / tiles;
    const size_t row0 = (size_t)b * n;
    const int o0 = (int)(job - b * tiles) * tile;
    const int o1 = min(n, o0 + tile);
    const int g0 = max(0, o0 - left);           // the union [g0, g1) of the tile's windows
    const int g1 = min(n, o1 + right);
    const int U = g1 - g0;

    // ---- load: NaN ranks as +inf; positions past the union are +inf too,
    // after every position of the union ----
    for (int i = t; i < P; i += nt) {
      T v = T(INFINITY);
      Idx ok = 0;
      if (i < U) {
        const T a = x[row0 + g0 + i];
        if (a == a) {
          v = a;
          ok = 1;
        }
      }
      vals[ix(i)] = v;
      pos[ix(i)] = (Idx)i;
      vpre[i] = ok;
    }
    __syncthreads();

    // ---- valid counts before each position: thread t owns
    // [t * chunk, t * chunk + chunk) ----
    {
      const int a0 = t * chunk;
      int own = 0;
      for (int e = 0; e < chunk; ++e) own += vpre[a0 + e];
      int total;
      int acc = block_exclusive_scan(own, warp_sums, &total);
      for (int e = 0; e < chunk; ++e) {
        const int c = vpre[a0 + e];
        vpre[a0 + e] = (Idx)acc;
        acc += c;
      }
      if (t == 0) vpre[P] = (Idx)total;
    }

    // ---- bitonic sort of (value, position), ascending ----
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j >= kPer; j >>= 1) {
        for (int c = t; c < P / 2; c += nt) {
          const int i = ((c & ~(j - 1)) << 1) | (c & (j - 1));
          const int pi = ix(i), pl = ix(i | j);
          const T vi = vals[pi], vl = vals[pl];
          const int ai = (int)pos[pi], al = (int)pos[pl];
          if (before(vl, al, vi, ai) == ((i & k) == 0)) {
            vals[pi] = vl;
            vals[pl] = vi;
            pos[pi] = (Idx)al;
            pos[pl] = (Idx)ai;
          }
        }
        __syncthreads();
      }
      for (int base8 = t * kPer; base8 < P; base8 += group_step) {
        T v[kPer];
        int a[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          v[e] = vals[ix(base8 + e)];
          a[e] = (int)pos[ix(base8 + e)];
        }
#pragma unroll
        for (int j = kPer >> 1; j > 0; j >>= 1) {
          if (j < k) {
#pragma unroll
            for (int e = 0; e < kPer; ++e) {
              if (e & j) continue;
              const bool up = ((base8 + e) & k) == 0;
              if (before(v[e | j], a[e | j], v[e], a[e]) == up) {
                const T tv = v[e];
                v[e] = v[e | j];
                v[e | j] = tv;
                const int ta = a[e];
                a[e] = a[e | j];
                a[e | j] = ta;
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          vals[ix(base8 + e)] = v[e];
          pos[ix(base8 + e)] = (Idx)a[e];
        }
      }
      __syncthreads();
    }

    // ---- local rank of each position ----
    for (int r = t; r < P; r += nt) seq[pos[ix(r)]] = (Idx)r;
    __syncthreads();

    // ---- wavelet matrix over the ranks, top bit first: level d's sequence
    // is level d-1's stably partitioned by its bit, zeros first ----
    Idx* cur = seq;
    Idx* nxt = pos;
    for (int d = 0; d < L; ++d) {
      const int sh = L - 1 - d;
      uint32_t* bw = bits + (size_t)d * words;
      Idx* pw = pre + (size_t)d * words;
      for (int i = t; i < P; i += nt) {         // nt divides P: whole warps
        const unsigned m = __ballot_sync(kFull, (cur[i] >> sh) & 1);
        if (lane == 0) bw[i >> 5] = m;
      }
      if (t == 0) bw[W] = 0;
      __syncthreads();
      const int w0 = min(W, t * wper), w1 = min(W, w0 + wper);
      int own = 0;
      for (int w = w0; w < w1; ++w) own += __popc(bw[w]);
      int total;
      int acc = block_exclusive_scan(own, warp_sums, &total);
      for (int w = w0; w < w1; ++w) {
        pw[w] = (Idx)acc;
        acc += __popc(bw[w]);
      }
      if (t == 0) pw[W] = (Idx)total;
      __syncthreads();
      if (d == L - 1) break;
      const int zeros = P - total;
      for (int i = t; i < P; i += nt) {
        const int w = i >> 5;
        const uint32_t m = bw[w];
        const int ones = (int)pw[w] + __popc(m & ((1u << (i & 31)) - 1u));
        nxt[((m >> (i & 31)) & 1u) ? zeros + ones : i - ones] = cur[i];
      }
      __syncthreads();
      Idx* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();

    // ---- one output a thread at a time ----
    for (int o = o0 + t; o < o1; o += nt) {
      const int lo = max(0, o - left) - g0;
      const int hi = min(n, o + right + 1) - g0;
      const int cnt = (int)vpre[hi] - (int)vpre[lo];
      const int last = max(cnt - 1, 0);
      const T p = Num<T>::mul(q, Num<T>::of(last));
      const int k_lo = Num<T>::floor_int(p);
      const T frac = Num<T>::sub(p, Num<T>::of(k_lo));
      const T v_lo = kth(vals, bits, pre, L, lo, hi, k_lo);
      T res = v_lo;
      if (frac > T(0)) {
        const T v_hi = kth(vals, bits, pre, L, lo, hi, min(k_lo + 1, last));
        res = Num<T>::add(v_lo, Num<T>::mul(frac, Num<T>::sub(v_hi, v_lo)));
      }
      out[row0 + o] = cnt >= min_periods ? res : T(NAN);
    }
    __syncthreads();                            // the next job reuses the arrays
  }
}

template <typename T, typename Idx, bool kShared>
cudaError_t start(const T* x, T* out, int n, int window, T q, int min_periods, int tile,
                  int tiles, long long jobs, int log_union, int blocks, void* scratch,
                  cudaStream_t stream) {
  const size_t smem = kShared ? layout(log_union, sizeof(T), sizeof(Idx)).total : 0;
  if (kShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        rolling_quantile_kernel<T, Idx, kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = min(kMaxThreads, (1 << log_union) / kPer);
  rolling_quantile_kernel<T, Idx, kShared><<<blocks, threads, smem, stream>>>(
      x, out, n, window / 2, (window - 1) / 2, q, min_periods, tile, tiles, jobs, log_union,
      static_cast<unsigned char*>(scratch));
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, T* out, int batch, int n, int window, T q, int min_periods, int tile,
           int log_union, int blocks, void* scratch, void* stream) {
  const long long span = (long long)tile + window - 1;   // the widest union of a tile
  const bool shared = log_union <= kMaxSharedLogUnion;
  if (batch < 1 || n < 1 || window < 1 || tile < 1 || log_union < kMinLogUnion ||
      log_union > kMaxLogUnion || (long long)n + window >= (1LL << 31) ||
      (span < n ? span : (long long)n) > (1LL << log_union)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (n + tile - 1) / tile;
  const long long jobs = (long long)batch * tiles;
  if (blocks < 1 || blocks > jobs || (!shared && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      shared ? start<T, uint16_t, true>(x, out, n, window, q, min_periods, tile, tiles, jobs,
                                        log_union, blocks, nullptr, s)
             : start<T, uint32_t, false>(x, out, n, window, q, min_periods, tile, tiles, jobs,
                                         log_union, blocks, scratch, s);
  return (int)err;
}

}  // namespace

// Bytes of global scratch a block needs at a union of 2^log_union positions
// of `elem`-byte values: 0 where the union fits in shared memory.
extern "C" long long rolling_quantile_scratch_bytes(int log_union, int elem) {
  if (log_union <= kMaxSharedLogUnion) return 0;
  return (long long)layout(log_union, (size_t)elem, sizeof(uint32_t)).total;
}

extern "C" int rolling_quantile_f32(const float* x, float* out, int batch, int n, int window,
                                    float q, int min_periods, int tile, int log_union,
                                    int blocks, void* scratch, void* stream) {
  return launch<float>(x, out, batch, n, window, q, min_periods, tile, log_union, blocks,
                       scratch, stream);
}

extern "C" int rolling_quantile_f64(const double* x, double* out, int batch, int n,
                                    int window, double q, int min_periods, int tile,
                                    int log_union, int blocks, void* scratch, void* stream) {
  return launch<double>(x, out, batch, n, window, q, min_periods, tile, log_union, blocks,
                        scratch, stream);
}

extern "C" const char* rolling_quantile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
