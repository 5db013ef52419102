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
//     frac = pos - k_lo.  v_lo is the k_lo-th smallest valid key.  The next
//     order statistic v_hi is v_lo itself when #valid <= v_lo reaches
//     k_lo + 2, else the smallest valid key above it (+inf if none).
//   * The result is v_lo + frac * (v_hi - v_lo) when frac > 0, else v_lo, as
//     a separate multiply and add (no contraction: the build passes
//     --fmad=false and the code uses __fmul_rn/__fadd_rn); NaN when
//     count < min_periods or count == 0.
// With that the kernel equals its plain version
// (ops/cuda/quantile_kernel.plain_anchors) bit for bit: a selection is exact
// whatever algorithm finds it, and the float operations are the same.
//
// What bounds it on this card: the least work of the function.  A select
// over each anchor's window keys needs, with a histogram of 8-bit digits in
// 4 rounds, per in-row key and round a digit extraction, a compare with the
// prefix chosen so far and a histogram increment (3 operations), plus once
// per key the clamp of missing keys to one sentinel (1): 13 operations per
// key; per anchor, each round scans 256 bins (an add and a compare each),
// 2048 operations.  At the engine configuration (16 rows x 2832 anchors,
// 1.36e8 in-row keys) that is 1.86e9 operations.  H100 SXM issues at most
// one warp instruction per scheduler per clock, 4 x 32 = 128 lane
// operations per SM per clock, whichever pipe takes them: 132 SMs x 128 x
// 1.98 GHz = 33.5e12 operations/s, so ~0.056 ms per launch.  Device memory
// traffic is small: the series is read once (11.6 MB, 3.5 us at 3.35 TB/s).
//
// So the design stages each window once for many anchors (neighbouring
// windows overlap by 98%), selects with a histogram of digits as the bound
// assumes, needs no block-wide barrier per round, and makes fewer than 4
// passes over a window's keys where the data lets it:
//
//   * Tiles.  One block per (row, tile of A consecutive anchors), A = 16
//     unless the staged keys would not fit in 200 KB of shared memory (then
//     fewer; at least 1).  The block stages the tile's union window, keys
//     [a0*stride - left, (a0+A-1)*stride + right], once: 3980 keys (16 KB)
//     at the engine shapes, about 1 KB of device traffic per anchor instead
//     of 12 KB.  The copy is cp.async, 4 bytes a key (any stride and any
//     window start, so no wider alignment holds); each thread then maps the
//     keys it copied to the sentinel 0xFFFFFFFF when missing (raw bits >=
//     +inf's), and positions outside [0, n) are written as the sentinel.
//     The staging also finds the tile's range of valid keys' top 16 bits.
//   * One warp per anchor, with a warp-private 512-bin histogram in shared
//     memory (bin d at (d % 16) * 32 + d / 16, so lane l's 16 bins are one
//     conflict-free row each).  A round counts the digits of the window keys
//     that match the prefix so far, finds the bin that holds rank k with a
//     warp prefix scan of the bins (16 a lane), subtracts from k and extends
//     the prefix.  Only __syncwarp and warp shuffles: no __syncthreads after
//     the staging.
//   * The top 16 bits take one round when the tile's valid keys span fewer
//     than 512 of them (envelope-derived series do: their values span a few
//     octaves), with digit (key >> 16) - lo16; else two 8-bit rounds, the
//     first putting the sentinel in bin 255, which no valid key reaches
//     (their top byte is at most 0x7F).  The valid count is the histogram's
//     total (or the window less bin 255).
//   * Bits 15-8 and 7-0: the keys with v_lo's 16-bit prefix are few (a
//     handful at the engine shapes), so the round over bits 15-8 copies them
//     into a warp-private compact list (up to 128 keys; more take full
//     passes), and the last round and the v_hi search read only that list.
//     Per key the kernel then does one digit round and one prefix compare,
//     not four rounds.
//   * Contention.  Envelope values span a narrow range of exponents, so
//     nearly every key of a window falls in one to three bins of an 8-bit
//     top-byte round, and ties (rounded values) put whole windows' matching
//     keys in one bin of the later full-window rounds; a shared-memory
//     atomicAdd per key would serialise a warp on one address there.  Each
//     lane walks a contiguous run of the window (an odd number of keys, so
//     the 32 lanes' loads fall in 32 banks) and, in those rounds, counts
//     runs of equal digits in a register, adding a run to the histogram
//     only when its digit changes: per-lane aggregation, one atomic per run
//     instead of per key, which needs no warp vote per key
//     (__match_any_sync would cost one per key).  The one 16-bit round
//     spreads a window over up to 512 bins, where neighbouring keys rarely
//     share a digit; there every key adds itself, which measured faster on
//     the card than the run bookkeeping.
//   * v_hi.  It is v_lo when round 4's bin still holds rank k_lo + 1; else
//     the next non-empty bin of round 4's histogram; else, when round 3 has
//     a non-empty bin above v_lo's, the smallest key above v_lo in the
//     compact list; only otherwise a min pass over the window's keys.  None
//     of it runs when frac is 0.
//
// The TPU kernel's anchor groups (a mod 128/stride), 128-shifted static
// slices, 8-row tiles and 1024-aligned DMA padding existed only because
// Mosaic rejects unaligned dynamic loads; none of it is carried over, and
// any stride works.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kInfBits = 0x7F800000u;   // +inf; keys >= are missing
constexpr uint32_t kMissing = 0xFFFFFFFFu;   // what a missing key is held as
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kBins = 512;              // histogram bins a warp, 16 a lane
constexpr int kPer = kBins / 32;
constexpr int kCompact = 128;                // keys a warp's compact list holds
constexpr int kMaxTile = 16;                 // anchors (warps) a block
constexpr long long kSmemLimit = 200 * 1024; // of the 227 KB a block may use
constexpr int kMaxWindow = 1024 * 24;        // the wrapper's MAX_WINDOW

// Bin d of a warp's histogram; lane l owns bins kPer*l .. kPer*l + kPer-1,
// one per 32-word row, so a lane's reads of its bins are conflict-free.
__device__ __forceinline__ int slot(uint32_t d) { return (d % kPer) * 32 + d / kPer; }

__device__ __forceinline__ void cp_async4(uint32_t* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void zero_hist(uint32_t* hist, int lane) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPer; ++i) hist[i * 32 + lane] = 0;
  __syncwarp();
}

// Histogram of digit(k) over this lane's window keys [lo, hi); digit(k) >=
// kBins skips a key.  With kRuns, runs of equal digits are counted in a
// register and added once (see the note on contention); else every key
// adds itself.
template <bool kRuns, typename Digit>
__device__ __forceinline__ void count_digits(const uint32_t* wk, int lo, int hi,
                                             Digit digit, uint32_t* hist) {
  uint32_t cur = 0, run = 0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const uint32_t d = digit(wk[i]);
    if (!kRuns) {
      if (d < kBins) atomicAdd(hist + slot(d), 1u);
      continue;
    }
    if (d < kBins) {
      if (d != cur) {
        if (run) atomicAdd(hist + slot(cur), run);
        cur = d;
        run = 0;
      }
      ++run;
    }
  }
  if (run) atomicAdd(hist + slot(cur), run);
  __syncwarp();
}

// The warp's inclusive scan of its lanes' bin sums.
struct Scan {
  uint32_t c[kPer];
  uint32_t own, incl, total;
};

__device__ __forceinline__ Scan scan_hist(const uint32_t* hist, int lane) {
  Scan s;
  s.own = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    s.c[i] = hist[i * 32 + lane];
    s.own += s.c[i];
  }
  s.incl = s.own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, s.incl, o);
    if (lane >= o) s.incl += t;
  }
  s.total = __shfl_sync(kFull, s.incl, 31);
  return s;
}

// The bin that holds rank k (0-based, k < total); k becomes the rank within
// that bin.
__device__ __forceinline__ uint32_t find_bin(const Scan& s, int lane, uint32_t& k) {
  const int src = __ffs(__ballot_sync(kFull, s.incl > k)) - 1;
  uint32_t acc = s.incl - s.own, d = 0;
  if (lane == src) {
    d = kPer * lane + kPer - 1;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (acc + s.c[i] > k) {
        d = kPer * lane + i;
        break;
      }
      acc += s.c[i];
    }
  }
  d = __shfl_sync(kFull, d, src);
  k -= __shfl_sync(kFull, acc, src);
  return d;
}

// The first non-empty bin above d (kBins if none).
__device__ __forceinline__ uint32_t next_bin(const Scan& s, int lane, uint32_t d) {
  uint32_t nb = kBins;
#pragma unroll
  for (int i = kPer - 1; i >= 0; --i) {
    const uint32_t b = kPer * lane + i;
    if (b > d && s.c[i] > 0) nb = b;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) nb = min(nb, __shfl_xor_sync(kFull, nb, o));
  return nb;
}

__device__ __forceinline__ uint32_t warp_min(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kMaxTile * 32)
strided_quantile_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                        int window, int left, int stride, int n_anchor, int tile,
                        float q, int min_periods) {
  extern __shared__ uint32_t smem[];
  uint32_t* range16 = smem;                          // [lo, hi] of valid k >> 16
  uint32_t* fill = smem + 2;                         // compact-list lengths
  uint32_t* hists = fill + tile;
  uint32_t* compact = hists + tile * kBins;
  uint32_t* keys = compact + tile * kCompact;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * tile;
  const int n_here = min(tile, n_anchor - a0);
  const int span = (n_here - 1) * stride + window;
  const long long start = (long long)a0 * stride - left;
  const float* row = x + (size_t)b * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // ---- stage the tile's union window once ----
  if (threadIdx.x == 0) {
    range16[0] = kMissing;
    range16[1] = 0;
  }
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long p = start + i;
    if (p >= 0 && p < n) {
      cp_async4(keys + i, row + p);
    } else {
      keys[i] = kMissing;
    }
  }
  __syncthreads();
  cp_async_wait_all();
  uint32_t lo16 = kMissing, hi16 = 0;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {   // this thread's copies
    uint32_t k = keys[i];
    if (k >= kInfBits) {
      keys[i] = kMissing;
    } else {
      lo16 = min(lo16, k >> 16);
      hi16 = max(hi16, k >> 16);
    }
  }
  lo16 = warp_min(lo16);
  hi16 = warp_max(hi16);
  if (lane == 0) {
    atomicMin(range16, lo16);
    atomicMax(range16 + 1, hi16);
    fill[warp] = 0;
  }
  __syncthreads();

  if (warp >= n_here) return;
  lo16 = range16[0];
  hi16 = range16[1];
  uint32_t* hist = hists + warp * kBins;
  uint32_t* cbuf = compact + warp * kCompact;
  const uint32_t* wk = keys + warp * stride;
  const int chunk = ((window + 31) / 32) | 1;   // odd: 32 lanes, 32 banks
  const int lo = min(lane * chunk, window);
  const int hi = min(lo + chunk, window);

  // ---- the top 16 bits: one round when the tile's keys span < 512 of
  // them, else two 8-bit rounds ----
  const bool fused = lo16 <= hi16 && hi16 - lo16 < kBins;
  zero_hist(hist, lane);
  if (fused) {
    count_digits<false>(wk, lo, hi, [=](uint32_t k) { return (k >> 16) - lo16; }, hist);
  } else {
    // The sentinel's top byte, 255, is above every valid key's (<= 0x7F).
    count_digits<true>(wk, lo, hi, [](uint32_t k) { return k >> 24; }, hist);
  }
  Scan s = scan_hist(hist, lane);
  const int count = fused ? (int)s.total : window - (int)hist[slot(255)];
  float result = __int_as_float(0x7FC00000);   // NaN
  if (count > 0 && count >= min_periods) {     // uniform across the warp
    const float pos = __fmul_rn(q, (float)(count - 1));
    const float kf = floorf(pos);
    const float frac = __fsub_rn(pos, kf);
    uint32_t k = (uint32_t)kf;
    uint32_t p16;
    if (fused) {
      p16 = lo16 + find_bin(s, lane, k);
    } else {
      const uint32_t d1 = find_bin(s, lane, k);
      zero_hist(hist, lane);
      count_digits<true>(wk, lo, hi, [=](uint32_t key) {
        return (key >> 24) == d1 ? (key >> 16) & 0xFFu : kBins;
      }, hist);
      s = scan_hist(hist, lane);
      p16 = (d1 << 8) | find_bin(s, lane, k);
    }
    // Keys with the 16-bit prefix: in the compact list when they fit.
    const uint32_t group = hist[slot(fused ? p16 - lo16 : p16 & 0xFFu)];
    const bool compacted = group <= (uint32_t)kCompact;
    zero_hist(hist, lane);
    if (compacted) {
      for (int i = lo; i < hi; ++i) {
        const uint32_t key = wk[i];
        if ((key >> 16) == p16) cbuf[atomicAdd(fill + warp, 1u)] = key;
      }
      __syncwarp();
      for (uint32_t i = lane; i < group; i += 32) {
        atomicAdd(hist + slot((cbuf[i] >> 8) & 0xFFu), 1u);
      }
      __syncwarp();
    } else {
      count_digits<true>(wk, lo, hi, [=](uint32_t key) {
        return (key >> 16) == p16 ? (key >> 8) & 0xFFu : kBins;
      }, hist);
    }
    s = scan_hist(hist, lane);
    const uint32_t d3 = find_bin(s, lane, k);
    const bool above3 = next_bin(s, lane, d3) < kBins;
    const uint32_t p24 = (p16 << 8) | d3;
    zero_hist(hist, lane);
    if (compacted) {
      for (uint32_t i = lane; i < group; i += 32) {
        const uint32_t key = cbuf[i];
        if ((key >> 8) == p24) atomicAdd(hist + slot(key & 0xFFu), 1u);
      }
      __syncwarp();
    } else {
      count_digits<true>(wk, lo, hi, [=](uint32_t key) {
        return (key >> 8) == p24 ? key & 0xFFu : kBins;
      }, hist);
    }
    s = scan_hist(hist, lane);
    const uint32_t d4 = find_bin(s, lane, k);
    const uint32_t prefix = (p24 << 8) | d4;
    const float v_lo = __uint_as_float(prefix);
    result = v_lo;
    if (frac > 0.0f) {
      // k is v_lo's rank among the keys equal to it (round 4's bin).
      uint32_t nxt;
      const uint32_t d4_next = next_bin(s, lane, d4);
      if (k + 1 < hist[slot(d4)]) {
        nxt = prefix;
      } else if (d4_next < kBins) {
        nxt = (p24 << 8) | d4_next;
      } else {
        // The smallest key above v_lo: within the 16-bit group (the compact
        // list) when round 3 has a bin above v_lo's, else over the window
        // (missing keys are above every valid one).
        uint32_t above = kMissing;
        if (compacted && above3) {
          for (uint32_t i = lane; i < group; i += 32) {
            if (cbuf[i] > prefix) above = min(above, cbuf[i]);
          }
        } else {
          for (int i = lo; i < hi; ++i) {
            if (wk[i] > prefix) above = min(above, wk[i]);
          }
        }
        nxt = min(warp_min(above), kInfBits);
      }
      const float v_hi = __uint_as_float(nxt);
      result = __fadd_rn(v_lo, __fmul_rn(frac, __fsub_rn(v_hi, v_lo)));
    }
  }
  if (lane == 0) out[(size_t)b * n_anchor + a0 + warp] = result;
}

}  // namespace

extern "C" int strided_quantile_anchors(const float* x, float* out, int batch,
                                        int n, int window, int left, int stride,
                                        int n_anchor, float q, int min_periods,
                                        void* stream) {
  if (window < 1 || window > kMaxWindow || stride < 1) return (int)cudaErrorInvalidValue;
  // As many anchors a block as fit, up to 16: per warp a histogram and a
  // compact list, and the tile's union window.
  auto bytes = [&](long long t) {
    return (2 + t * (1 + kBins + kCompact) + (t - 1) * stride + window) * 4;
  };
  int tile = kMaxTile;
  while (tile > 1 && bytes(tile) > kSmemLimit) --tile;
  const size_t smem = (size_t)bytes(tile);
  cudaError_t err = cudaFuncSetAttribute(
      strided_quantile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_anchor + tile - 1) / tile, batch);
  strided_quantile_kernel<<<grid, tile * 32, smem, (cudaStream_t)stream>>>(
      x, out, n, window, left, stride, n_anchor, tile, q, min_periods);
  return (int)cudaGetLastError();
}

extern "C" const char* strided_quantile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
