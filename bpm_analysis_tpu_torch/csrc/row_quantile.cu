// Exact quantile of each row of a (B, n) batch — CUDA kernel for Hopper
// (sm_90a).
//
// Replaces an XLA computation of the JAX package, not a Pallas kernel:
// bpm_analysis_tpu/ops/quantile.py:146 quantile_exact and its radix
// bisection select_kth (:112), whose eager PyTorch form
// (ops/quantile.quantile_exact_plain) ran 8 rounds of about 20 launches a
// call with a 16-bin int64 scatter_add_ that serialised every key of a row
// on 16 addresses.  For each row b it computes, in the row's dtype T:
//
//   * n = the row's valid count (the mask, or x == x without one);
//   * pos = q * T(max(n - 1, 0)), k_lo = min(max(floor(pos), 0), max(n - 1, 0)),
//     frac = pos - T(k_lo), with q already rounded to T by the caller;
//   * v_lo = the k_lo-th smallest valid element by the sortable key (flip
//     every bit of a negative float, the sign bit of a non-negative one);
//   * when frac > 0: v_hi = v_lo if k_lo + 1 >= n, or if the valid elements
//     with x <= v_lo (a float comparison, so -0.0 and +0.0 tie) number at
//     least k_lo + 2; else the smallest valid x > v_lo (+inf if none);
//     out = v_lo + frac * (v_hi - v_lo) as a separate subtract, multiply and
//     add (the build passes --fmad=false and the code uses the _rn
//     intrinsics); else out = v_lo;
//   * NaN for a row with no valid element.
// A selection is exact whatever algorithm finds it and the float operations
// are the plain version's, so the kernel equals it bit for bit.
//
// What bounds it on this card: bytes.  The least work reads each row once:
// B * n * (sizeof(T) + 1 byte of mask), 464 MB at the fleet's
// (512, 181,200) float32, 0.139 ms at 3.35 TB/s.  The operations are a few
// integer instructions a key a pass (~10 a key, 0.03 ms a pass at the issue
// limit of 132 SMs x 128 lanes x 1.98 GHz).
//
// Design:
//   * Radix select over 11-bit digits of the key: 3 passes for float32
//     (11, 11, 10 bits) and 6 for float64, then, only when frac > 0 and
//     k_lo + 1 < n, one pass for the count of x <= v_lo and the smallest
//     x > v_lo.  Keys are made from x as each pass reads it and never
//     written out; a pass counts the digits of the keys whose higher bits
//     match the prefix chosen so far.  The row is too large for shared
//     memory (725 KB at the fleet's shape), so each pass re-reads it.
//   * Counts live in a 2048-bin shared-memory histogram, double-buffered so
//     that one barrier a pass separates the counting from the reading of
//     the totals.  Contention: an envelope is smooth, so the 128 neighbouring
//     keys of a warp's load (4 a lane, 16-byte loads) nearly always share
//     their top digit.  A lane counts its own keys of one digit in a
//     register; when every lane's keys share the warp's first digit, one
//     warp reduction (redux.sync) and one atomic add the warp's count;
//     otherwise each key adds itself (the later passes, whose digits spread
//     over the bins).  No 16-address contention is left, and no global
//     atomic is used.
//   * The shape decides the split: SMs / B blocks share a row, at least 1
//     and at most 8.  At B=512 that is one 512-thread block a row (2 an SM
//     at 64 registers a thread, so two waves); at B=1 a cluster of 8 blocks,
//     each counting a contiguous slice of the row into its own histogram,
//     every block summing the cluster's histograms through distributed
//     shared memory to choose the same digit.  One launch either way.
//   * Templated on float/uint32 and double/uint64.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigit = 11;
constexpr int kBins = 1 << kDigit;
constexpr int kMaxSplit = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kBins == 4 * kThreads, "each thread owns 4 consecutive bins");

template <typename T>
struct Num;

template <>
struct Num<float> {
  using U = uint32_t;
  static constexpr int kWidth = 32;
  static constexpr int kVec = 4;   // elements of one 16-byte load
  __device__ static U bits(float v) { return __float_as_uint(v); }
  __device__ static float value(U u) { return __uint_as_float(u); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float of(long long i) { return __ll2float_rn(i); }
};

template <>
struct Num<double> {
  using U = unsigned long long;
  static constexpr int kWidth = 64;
  static constexpr int kVec = 2;
  __device__ static U bits(double v) { return (U)__double_as_longlong(v); }
  __device__ static double value(U u) { return __longlong_as_double((long long)u); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double of(long long i) { return __ll2double_rn(i); }
};

// Monotone float -> key, and back (ops/quantile._sortable_key / _key_to_float).
template <typename T>
__device__ __forceinline__ typename Num<T>::U key_of(T v) {
  using U = typename Num<T>::U;
  const U sign = U(1) << (Num<T>::kWidth - 1);
  const U b = Num<T>::bits(v);
  return (b & sign) ? ~b : (b ^ sign);
}

template <typename T>
__device__ __forceinline__ T value_of(typename Num<T>::U key) {
  using U = typename Num<T>::U;
  const U sign = U(1) << (Num<T>::kWidth - 1);
  return Num<T>::value((key & sign) ? (key ^ sign) : ~key);
}

// kVec consecutive elements of a row and their validity.
template <typename T>
struct Item {
  T v[Num<T>::kVec];
  bool ok[Num<T>::kVec];
};

// Item i (elements [i*kVec, i*kVec + kVec) of the row); out-of-row elements
// and a negative i are invalid.  ``vector``: the row's x and mask pointers
// are aligned for one 16-byte and one kVec-byte load.
template <typename T>
__device__ __forceinline__ Item<T> load_item(const T* row, const uint8_t* vrow, int n,
                                             bool vector, long long i) {
  constexpr int V = Num<T>::kVec;
  Item<T> it;
  const long long e0 = i * V;
  if (i >= 0 && vector && e0 + V <= n) {
    uint32_t m = 0;
    if constexpr (V == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row) + i);
      it.v[0] = f.x; it.v[1] = f.y; it.v[2] = f.z; it.v[3] = f.w;
      if (vrow) m = __ldg(reinterpret_cast<const unsigned int*>(vrow) + i);
    } else {
      const double2 f = __ldg(reinterpret_cast<const double2*>(row) + i);
      it.v[0] = f.x; it.v[1] = f.y;
      if (vrow) m = __ldg(reinterpret_cast<const unsigned short*>(vrow) + i);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      it.ok[j] = vrow ? ((m >> (8 * j)) & 0xFFu) != 0 : it.v[j] == it.v[j];
    }
    return it;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long e = e0 + j;
    if (i >= 0 && e < n) {
      it.v[j] = row[e];
      it.ok[j] = vrow ? vrow[e] != 0 : it.v[j] == it.v[j];
    } else {
      it.v[j] = T(0);
      it.ok[j] = false;
    }
  }
  return it;
}

__device__ __forceinline__ void row_barrier(int split) {
  if (split > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <typename P>
__device__ __forceinline__ P* of_rank(P* p, int rank, int split) {
  return split > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

// Adds to ``hist`` the digit (key >> shift) & dmask of every valid key of
// one item whose bits above hi_shift equal the prefix's (all keys when
// ``first``).  Called by every lane of a warp together.
template <typename T>
__device__ __forceinline__ void count_item(const Item<T>& it, bool first, int hi_shift,
                                           int shift, typename Num<T>::U prefix,
                                           typename Num<T>::U dmask, uint32_t* hist) {
  constexpr int V = Num<T>::kVec;
  uint32_t d[V];
  bool cand[V];
  uint32_t mine = 0, cnt = 0;
  bool mixed = false;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const auto key = key_of<T>(it.v[j]);
    cand[j] = it.ok[j] && (first || (key >> hi_shift) == (prefix >> hi_shift));
    d[j] = (uint32_t)((key >> shift) & dmask);
    if (cand[j]) {
      if (cnt == 0) mine = d[j];
      if (d[j] == mine) {
        ++cnt;
      } else {
        mixed = true;
      }
    }
  }
  const unsigned any = __ballot_sync(kFull, cnt > 0);
  if (any == 0) return;
  const uint32_t ref = __shfl_sync(kFull, mine, __ffs(any) - 1);
  if (__all_sync(kFull, cnt == 0 || (mine == ref && !mixed))) {
    const uint32_t total = __reduce_add_sync(kFull, cnt);
    if ((threadIdx.x & 31) == 0) atomicAdd(hist + ref, total);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (cand[j]) atomicAdd(hist + d[j], 1u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
row_quantile_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                    T* __restrict__ out, int n, T q, int split) {
  using U = typename Num<T>::U;
  constexpr int V = Num<T>::kVec;
  __shared__ __align__(16) uint32_t hists[2][kBins];
  __shared__ uint32_t warp_sum[kWarps];
  __shared__ uint32_t pick[2];                  // chosen digit, keys below it
  __shared__ uint32_t warp_cnt[kWarps];
  __shared__ T warp_min[kWarps];
  __shared__ uint32_t part_cnt;                 // this block's final-pass partials
  __shared__ T part_min;

  const int rank = blockIdx.x;                  // the block's rank in its row's cluster
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const T* row = x + (size_t)b * n;
  const uint8_t* vrow = valid ? valid + (size_t)b * n : nullptr;
  const bool vector = ((uintptr_t)row % 16 == 0) && (!vrow || (uintptr_t)vrow % V == 0);
  const long long items = ((long long)n + V - 1) / V;
  const long long per = (items + split - 1) / split;
  const long long lo = min(items, (long long)rank * per);
  const long long hi = min(items, lo + per);

  // ---- radix select of the k_lo-th key, 11 bits a pass ----
  U prefix = 0;
  uint32_t n_valid = 0, k = 0;
  long long k_lo = 0;
  T frac = T(0);
  for (int pass = 0, hi_shift = Num<T>::kWidth; hi_shift > 0; ++pass) {
    const int shift = max(hi_shift - kDigit, 0);
    const U dmask = (U(1) << (hi_shift - shift)) - 1;
    uint32_t* hist = hists[pass & 1];
    reinterpret_cast<uint4*>(hist)[t] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (long long base = lo + (t & ~31); base < hi; base += 2 * kThreads) {
      const long long i0 = base + lane, i1 = i0 + kThreads;
      const Item<T> a = load_item(row, vrow, n, vector, i0 < hi ? i0 : -1);
      const Item<T> c = load_item(row, vrow, n, vector, i1 < hi ? i1 : -1);
      count_item(a, pass == 0, hi_shift, shift, prefix, dmask, hist);
      count_item(c, pass == 0, hi_shift, shift, prefix, dmask, hist);
    }
    row_barrier(split);   // every histogram of the row is complete

    // This thread's 4 bins summed over the cluster, and their block scan.
    uint32_t bins[4] = {0, 0, 0, 0};
    for (int r = 0; r < split; ++r) {
      const uint4 h = reinterpret_cast<const uint4*>(of_rank(hist, r, split))[t];
      bins[0] += h.x; bins[1] += h.y; bins[2] += h.z; bins[3] += h.w;
    }
    const uint32_t own = bins[0] + bins[1] + bins[2] + bins[3];
    uint32_t incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t s = warp_sum[w];
      if (w < warp) incl += s;
      total += s;
    }
    if (pass == 0) {   // the valid count, and the rank to select
      n_valid = total;
      if (n_valid == 0) break;
      const long long nm1 = (long long)n_valid - 1;
      const T pos = Num<T>::mul(q, Num<T>::of(nm1));
      k_lo = min(max((long long)floor(pos), 0LL), nm1);
      frac = Num<T>::sub(pos, Num<T>::of(k_lo));
      k = (uint32_t)k_lo;
    }
    const uint32_t excl = incl - own;
    if (excl <= k && k < incl) {
      uint32_t acc = excl, d = 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (acc + bins[j] > k) {
          d = j;
          break;
        }
        acc += bins[j];
      }
      pick[0] = 4 * t + d;
      pick[1] = acc;
    }
    __syncthreads();
    k -= pick[1];
    prefix |= (U)pick[0] << shift;
    hi_shift = shift;
  }

  // ---- v_hi and the interpolation ----
  T result = T(NAN);
  if (n_valid > 0) {
    const T v_lo = value_of<T>(prefix);
    result = v_lo;
    if (frac > T(0)) {
      T v_hi = v_lo;
      if (k_lo + 1 < (long long)n_valid) {
        uint32_t cnt = 0;
        T mn = T(INFINITY);
        for (long long base = lo + (t & ~31); base < hi; base += 2 * kThreads) {
          const long long i0 = base + lane, i1 = i0 + kThreads;
          const Item<T> a = load_item(row, vrow, n, vector, i0 < hi ? i0 : -1);
          const Item<T> c = load_item(row, vrow, n, vector, i1 < hi ? i1 : -1);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            cnt += (a.ok[j] && a.v[j] <= v_lo) + (c.ok[j] && c.v[j] <= v_lo);
            if (a.ok[j] && a.v[j] > v_lo && a.v[j] < mn) mn = a.v[j];
            if (c.ok[j] && c.v[j] > v_lo && c.v[j] < mn) mn = c.v[j];
          }
        }
        cnt = __reduce_add_sync(kFull, cnt);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const T other = __shfl_xor_sync(kFull, mn, o);
          if (other < mn) mn = other;
        }
        if (lane == 0) {
          warp_cnt[warp] = cnt;
          warp_min[warp] = mn;
        }
        __syncthreads();
        if (t == 0) {
          cnt = 0;
          mn = T(INFINITY);
          for (int w = 0; w < kWarps; ++w) {
            cnt += warp_cnt[w];
            if (warp_min[w] < mn) mn = warp_min[w];
          }
          part_cnt = cnt;
          part_min = mn;
        }
        row_barrier(split);   // every block's partials are written
        if (rank == 0 && t == 0) {
          cnt = 0;
          mn = T(INFINITY);
          for (int r = 0; r < split; ++r) {
            cnt += *of_rank(&part_cnt, r, split);
            const T m = *of_rank(&part_min, r, split);
            if (m < mn) mn = m;
          }
          v_hi = (long long)cnt >= k_lo + 2 ? v_lo : mn;
        }
      }
      result = Num<T>::add(v_lo, Num<T>::mul(frac, Num<T>::sub(v_hi, v_lo)));
    }
  }
  if (rank == 0 && t == 0) out[b] = result;
  row_barrier(split);   // no block leaves while another may read its shared memory
}

int split_for(int batch) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return -1;
  }
  return max(1, min(kMaxSplit, sms / max(batch, 1)));
}

template <typename T>
int launch(const T* x, const uint8_t* valid, T* out, int batch, int n, T q, void* stream) {
  if (batch < 1 || batch > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  const int split = split_for(batch);
  if (split < 1) return (int)cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, row_quantile_kernel<T>, x, valid, out, n,
                                             q, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int row_quantile_f32(const float* x, const uint8_t* valid, float* out, int batch,
                                int n, float q, void* stream) {
  return launch<float>(x, valid, out, batch, n, q, stream);
}

extern "C" int row_quantile_f64(const double* x, const uint8_t* valid, double* out, int batch,
                                int n, double q, void* stream) {
  return launch<double>(x, valid, out, batch, n, q, stream);
}

// The blocks that share one row at this batch size on the current card.
extern "C" int row_quantile_split(int batch) { return split_for(batch); }

extern "C" const char* row_quantile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
