// The metrics stage — CUDA kernel for Hopper (sm_90a).
//
// Replaces the eager PyTorch of models/analytics.compute_metrics_plain (the
// port of bpm_analysis_tpu/models/analytics.py's compute_metrics, an XLA
// computation): the BPM series with its bounded centered 5 s smoothing, the
// windowed HRV, the summary means, minima and maxima, the BPM curve's peaks
// and troughs for the slope scans (two dense find_peaks with a per-row
// distance), the steepest exertion and recovery slopes, the 1-minute
// heart-rate recovery, and the major incline and decline lists.  The plain
// version issues ~6,500 launches a fleet call, reads a device value on the
// host once a round of the distance suppression (23 rounds a fleet call)
// and copies 2 constants to the card; this kernel is one launch with no
// host round trip.
//
// Design: one 256-thread block per recording.  The beat times, the
// compacted times and instantaneous BPM, the smoothed curve, the HRV
// columns the means read and the slope scans' working lists live in
// shared memory, sized from the capacity (opt-in dynamic shared memory;
// `layout`).  Past what a block's shared memory holds (a capacity above
// ~4,460 slots in float64, ~8,250 in float32, as the overflow retry's
// doubled capacities reach) the arrays of the row's length move to a
// global scratch region of each block, and the blocks loop over the rows;
// the arithmetic is the same.  Every output is the plain version's bits
// on the card:
//
// * The same operations in the same order, each rounded once
//   (--fmad=false keeps a multiply and an add apart).  A division by a
//   Python number on the card is a multiply by the reciprocal the host
//   rounds to the dtype (ATen's div_true_kernel_cuda), so the wrapper hands
//   those reciprocals over (1 / rate, 1 / w, 1 / (w - 1), 1 / 1000);
//   `60 / x` is torch's x.reciprocal() * 60; tensor divisions are div.rn.
// * Sums with a fixed association: the smoothing's window sum adds the
//   window's slots in ascending order from 0 (rolling._window_sum's shifted
//   adds, whose out-of-window terms add 0); series.fixed_order_sum's
//   pairwise tree over the row zero-padded to a power of two is element i
//   plus element i + half, halving (`tree_sum` in shared memory; the HRV's
//   40-interval windows by one warp's shuffles, `warp_tree`).
// * The smoothing window's edges: where the configuration bounds the
//   window's slots (at most 128, fewer than the capacity) by the plain
//   version's compares over m = 1..M; unbounded, by the same compares up
//   to the first that fails, which on sorted times are torch.searchsorted's
//   edges.  Unbounded, the plain version sums a window as a prefix-sum
//   difference whose association the library scan picks from the shape;
//   the kernel keeps the slot-order sum, the plain version's bounded form
//   at M = cap - 1, so there it differs from the plain version by rounding.
// * torch.searchsorted's own binary search (`lower_bound`, `upper_bound`),
//   torch.argmax's first index among equal maxima with NaN the largest
//   (`better`), and the stable ascending sort as a rank count.
// * find_peaks' distance suppression: the plain version iterates parallel
//   rounds to a fixed point with one host read a round; that fixed point is
//   the sequential greedy keep-highest (highest priority first, the later
//   slot first among equal priorities; each kept candidate suppresses the
//   candidates of its window), which one thread walks here in rank order.
//   The windows come from the same float32 positions and binary searches;
//   they are symmetric for integer positions below 2^24.
// * Prominences by a linear scan out of each surviving candidate while the
//   curve stays at or below it, keeping the minimum: the sparse tables'
//   descents and range minima give the same bound and the same minimum.
//
// What bounds it on this card: the dependent chains inside a block (the
// greedy walk, the prominence scans of the tallest peaks, the smoothing's
// window loops), not bytes: a fleet batch reads 3 MB and writes ~12 MB.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWork = 256;      // find_peaks' work capacity: 4 x the slope capacity
constexpr int kSlopes = 64;     // slope_extrema's capacity
constexpr int kListFields = 7;  // a SlopeList's float fields
constexpr int kSlotFields = 8;  // those and the sort key, per start slot
constexpr size_t kMaxShared = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kWork, "one thread a work slot in the compactions");

struct Params {
  int cap, max_slots, hrv_window, hrv_step, hrv_cap, truncated_interp;
  double inv_rate, half_window, min_diff, inv_hrv_window, inv_hrv_window1, inv_1000,
      slope_window, hrr_interval, interp_eps, distance_num, min_duration, min_change,
      prominence;
};

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
  __device__ static float big() { return FLT_MAX; }
};
template <> struct Num<double> {
  __device__ static double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
  __device__ static double nan() { return __longlong_as_double(0x7ff8000000000000LL); }
  __device__ static double big() { return DBL_MAX; }
};

// The width series.fixed_order_sum pads n values to (a power of two).
__host__ __device__ inline int tree_width(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the block's arrays, each 16-byte aligned.  The row's
// arrays, of the capacity's length, from the start of the row region:
// working-dtype t, ct, ci, sm (cap), red (the tree's first level), rm, sd
// (hcap); int32 rs (cap); bytes mask (cap).  The fixed arrays, from the
// start of the fixed region: working-dtype sl (2 x kSlotFields x kSlopes),
// tscr (2 x kWarps); float32 posf, prio (2 x kWork); int32 cand, lo, hi,
// order, surv (2 x kWork), fin (2 x kSlopes), iscr (2 x kThreads + 2 x
// kWarps); bytes flag, keep (2 x kWork).  Shared memory holds the row
// region and then the fixed one where both fit (`row + fixed <=
// kMaxShared`); else the row region is a block's part of global scratch.
struct Layout {
  size_t t, ct, ci, sm, red, rm, sd, rs, mask, row;
  size_t sl, tscr, posf, prio, cand, lo, hi, order, surv, fin, iscr, flag, keep, fixed;
};

__host__ __device__ inline size_t place(size_t* const* slots, const size_t* bytes, int n) {
  size_t o = 0;
  for (int k = 0; k < n; ++k) {
    *slots[k] = o;
    o = align16(o + bytes[k]);
  }
  return o;
}

__host__ __device__ inline Layout layout(int cap, int hcap, int size) {
  Layout L;
  const int wide = tree_width(cap) > tree_width(hcap) ? tree_width(cap) : tree_width(hcap);
  const size_t red = wide > 1 ? (size_t)(wide / 2) : 1;
  size_t* const row[] = {&L.t, &L.ct, &L.ci, &L.sm, &L.red, &L.rm, &L.sd, &L.rs, &L.mask};
  const size_t row_bytes[] = {
      (size_t)size * cap, (size_t)size * cap, (size_t)size * cap, (size_t)size * cap,
      size * red, (size_t)size * hcap, (size_t)size * hcap, 4u * cap, (size_t)cap};
  L.row = place(row, row_bytes, 9);
  size_t* const fixed[] = {&L.sl, &L.tscr, &L.posf, &L.prio, &L.cand, &L.lo, &L.hi,
                           &L.order, &L.surv, &L.fin, &L.iscr, &L.flag, &L.keep};
  const size_t fixed_bytes[] = {
      (size_t)size * 2 * kSlotFields * kSlopes, (size_t)size * 2 * kWarps,
      4u * 2 * kWork, 4u * 2 * kWork,
      4u * 2 * kWork, 4u * 2 * kWork, 4u * 2 * kWork, 4u * 2 * kWork, 4u * 2 * kWork,
      4u * 2 * kSlopes, 4u * (2 * kThreads + 2 * kWarps), 2u * kWork, 2u * kWork};
  L.fixed = place(fixed, fixed_bytes, 13);
  return L;
}

__host__ __device__ inline bool spills(const Layout& L) { return L.row + L.fixed > kMaxShared; }

// torch.searchsorted's binary searches (ATen's cus_lower_bound /
// cus_upper_bound) over at(0..len-1).
template <typename F, typename V>
__device__ int lower_bound(int len, F at, V val) {
  int start = 0, end = len;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(at(mid) >= val)) start = mid + 1;
    else end = mid;
  }
  return start;
}

template <typename F, typename V>
__device__ int upper_bound(int len, F at, V val) {
  int start = 0, end = len;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(at(mid) > val)) start = mid + 1;
    else end = mid;
  }
  return start;
}

// torch's ascending sort order: NaN after every number.
template <typename T>
__device__ bool sort_less(T a, T b) {
  return a < b || (isnan(b) && !isnan(a));
}

// torch.argmax's choice: (a, ia) wins over (b, ib) if a is NaN and b is not,
// if a > b, or if the two are equal (both NaN) and ia is the first index.
template <typename T>
__device__ bool better(T a, int ia, T b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// Exclusive prefix sum of one int a thread over the block; *total gets the
// sum.  scr holds kWarps ints.
__device__ int block_exclusive_sum(int v, int* total, int* scr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scr[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? scr[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) scr[lane] = s;
  }
  __syncthreads();
  const int base = warp ? scr[warp - 1] : 0;
  *total = scr[kWarps - 1];
  __syncthreads();
  return base + x - v;
}

// A reduction of one value a thread with an exact, order-free op (int sums,
// min, max); every thread gets the result.
template <typename V, typename Op>
__device__ V block_reduce(V v, Op op, V* scr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) scr[warp] = v;
  __syncthreads();
  V r = scr[0];
  for (int k = 1; k < kWarps; ++k) r = op(r, scr[k]);
  __syncthreads();
  return r;
}

// torch.argmax over value(0..n-1); every thread gets the index.
template <typename T, typename F>
__device__ int block_argmax(int n, F value, T* tscr, int* iscr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T bv = Num<T>::nan();
  int bi = -1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const T v = value(i);
    if (bi < 0 || better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (oi >= 0 && (bi < 0 || better(ov, oi, bv, bi))) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    tscr[warp] = bv;
    iscr[warp] = bi;
  }
  __syncthreads();
  T rv = tscr[0];
  int ri = iscr[0];
  for (int k = 1; k < kWarps; ++k) {
    if (iscr[k] >= 0 && (ri < 0 || better(tscr[k], iscr[k], rv, ri))) {
      rv = tscr[k];
      ri = iscr[k];
    }
  }
  __syncthreads();
  return ri;
}

// series.fixed_order_sum of x(0..n-1) (n >= 1): the row zero-padded to a
// power of two, element i plus element i + half until one is left.  x(k)
// is only called for k < n; every thread gets the sum.
template <typename T, typename F>
__device__ T tree_sum(int n, F x, T* red) {
  const int width = tree_width(n);
  if (width == 1) return x(0);
  const int half = width >> 1;
  for (int i = threadIdx.x; i < half; i += kThreads)
    red[i] = x(i) + (i + half < n ? x(i + half) : T(0));
  __syncthreads();
  for (int s = half >> 1; s > 0; s >>= 1) {
    for (int i = threadIdx.x; i < s; i += kThreads) red[i] = red[i] + red[i + s];
    __syncthreads();
  }
  const T r = red[0];
  __syncthreads();
  return r;
}

// The same tree over n values by one warp; lane 0 gets the sum.  Past 32
// values lane l first sums its column, x(l + 32k) for k below width / 32,
// in the tree's own order: the levels whose half is 32 or more pair
// elements of one column, k with k + cols / 2, which are the adjacent pairs
// of the column in bit-reversed order, folded here with a stack of partial
// sums.  A width of 64 (the default 40-interval window) is one add.
template <typename T, typename F>
__device__ T warp_tree(int n, F x, int lane) {
  const int width = tree_width(n);
  T a;
  if (width == 64) {
    a = x(lane) + (lane + 32 < n ? x(lane + 32) : T(0));
  } else if (width > 64) {
    const int cols = width >> 5, bits = __ffs(cols) - 1;
    T stack[32];
    for (int m = 0; m < cols; ++m) {
      const int k = (int)(__brev((unsigned)m) >> (32 - bits));
      const int i = lane + 32 * k;
      T v = i < n ? x(i) : T(0);
      int level = 0;
      for (int mm = m; mm & 1; mm >>= 1) v = stack[level++] + v;
      stack[level] = v;
    }
    a = stack[bits];
  } else {
    a = lane < n ? x(lane) : T(0);
  }
  for (int off = (width < 32 ? width : 32) >> 1; off > 0; off >>= 1)
    a = a + __shfl_down_sync(kFull, a, off);
  return a;
}

// One recording: `rows` holds the layout's row region, `fixed` its fixed one.
template <typename T>
__device__ __forceinline__ void metrics_row(
    const int row, const Layout& L, unsigned char* rows, unsigned char* fixed,
    const int32_t* __restrict__ positions, const int32_t* __restrict__ count, const Params& p,
    const int bsz, T* __restrict__ series, T* __restrict__ hrv, T* __restrict__ slopes,
    T* __restrict__ scalars, int32_t* __restrict__ counts, uint8_t* __restrict__ found) {
  const int cap = p.cap, hcap = p.hrv_cap;
  T* s_t = (T*)(rows + L.t);      // beat times of slots 0..cap-1
  T* s_ct = (T*)(rows + L.ct);    // times of the valid diffs, compacted; NaN after
  T* s_ci = (T*)(rows + L.ci);    // their instantaneous BPM; NaN after
  T* s_sm = (T*)(rows + L.sm);    // the smoothed BPM; NaN after
  T* s_red = (T*)(rows + L.red);
  T* s_rm = (T*)(rows + L.rm);    // HRV RMSSDc by window, NaN where not valid
  T* s_sd = (T*)(rows + L.sd);    // HRV SDNN
  int* s_rs = (int*)(rows + L.rs);
  uint8_t* s_mask = (uint8_t*)(rows + L.mask);
  T* s_sl = (T*)(fixed + L.sl);    // [list][field][start slot]
  T* s_tscr = (T*)(fixed + L.tscr);
  float* s_posf = (float*)(fixed + L.posf);   // [kind][slot]: kind 0 peaks, 1 troughs
  float* s_prio = (float*)(fixed + L.prio);
  int* s_cand = (int*)(fixed + L.cand);
  int* s_lo = (int*)(fixed + L.lo);
  int* s_hi = (int*)(fixed + L.hi);
  int* s_order = (int*)(fixed + L.order);
  int* s_surv = (int*)(fixed + L.surv);
  int* s_fin = (int*)(fixed + L.fin);
  int* s_iscr = (int*)(fixed + L.iscr);
  uint8_t* s_flag = (uint8_t*)(fixed + L.flag);
  uint8_t* s_keep = (uint8_t*)(fixed + L.keep);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = count[row];
  const T inf = Num<T>::inf(), nan = Num<T>::nan();
  const int per = (cap + kThreads - 1) / kThreads;   // a thread's chunk of slots
  const int a0 = min(tid * per, cap), a1 = min(a0 + per, cap);

  // --- bpm_series: beat times, the valid diffs compacted in order --------
  for (int i = tid; i < cap; i += kThreads) {
    const int pos = i < cnt ? positions[(size_t)row * cap + i] : INT32_MAX;
    s_t[i] = T(pos) * T(p.inv_rate);
  }
  __syncthreads();
  const T min_diff = T(p.min_diff);
  auto diff_ok = [&](int i) {
    return i < cap - 1 && i < cnt - 1 && s_t[i + 1] - s_t[i] > min_diff;
  };
  int mine = 0;
  for (int i = a0; i < a1; ++i) mine += diff_ok(i);
  int vcount;
  int at = block_exclusive_sum(mine, &vcount, s_iscr);
  for (int i = a0; i < a1; ++i) {
    if (diff_ok(i)) {
      const T d = s_t[i + 1] - s_t[i];
      s_ct[at] = s_t[i + 1];
      s_ci[at] = (T(1) / d) * T(60);
      ++at;
    }
  }
  __syncthreads();
  for (int i = vcount + tid; i < cap; i += kThreads) {
    s_ct[i] = nan;
    s_ci[i] = nan;
  }
  __syncthreads();

  // --- the bounded centered time window (rolling_mean_time_window) -------
  {
    const T half = T(p.half_window), big = Num<T>::big();
    for (int i = tid; i < cap; i += kThreads) {
      T out = nan;
      if (i < vcount) {
        const T ti = s_ct[i];
        const T thi = ti + half, tlo = ti - half;
        int cn = 0, cp = 0;
        if (p.max_slots >= 0) {
          for (int m = 1; m <= p.max_slots; ++m) {
            const int j = i + m, k = i - m;
            if (j < cap) cn += (j < vcount ? s_ct[j] : big) <= thi;
            if (k >= 0) cp += s_ct[k] > tlo;
          }
        } else {   // unbounded: the compares up to the first that fails
          for (int j = i + 1; j < cap && (j < vcount ? s_ct[j] : big) <= thi; ++j) ++cn;
          for (int k = i - 1; k >= 0 && s_ct[k] > tlo; --k) ++cp;
        }
        const int hi = min(max(i + 1 + cn, 0), vcount), lo = min(max(i - cp, 0), vcount);
        T sum = T(0);
        for (int j = lo; j < hi; ++j) sum = sum + s_ci[j];
        const T n = T(hi - lo);
        if (n > T(0)) out = sum / (n < T(1) ? T(1) : n);
      }
      s_sm[i] = out;
    }
  }
  __syncthreads();

  // --- windowed_hrv: one warp a window ------------------------------------
  int nwin = 0;
  {
    const int w = p.hrv_window, step = p.hrv_step;
    const int n_rr = max(cnt - 1, 0);
    const T k1000 = T(1000.0), inv_w = T(p.inv_hrv_window), inv_w1 = T(p.inv_hrv_window1);
    const T inv_1000 = T(p.inv_1000);
    auto rr = [&](int k) {   // rr_ms[clamp(k, 0, cap - 2)]
      k = min(max(k, 0), cap - 2);
      return (s_t[k + 1] - s_t[k]) * k1000;
    };
    const size_t plane = (size_t)bsz * hcap;
    T* out = hrv + (size_t)row * hcap;
    for (int k = warp; k < hcap; k += kWarps) {
      const int start = k * step;
      const bool valid = start + w <= n_rr && cnt >= w;
      nwin += valid && lane == 0;
      if (!valid) {
        if (lane == 0) {
          out[k] = out[plane + k] = out[2 * plane + k] = out[3 * plane + k] = nan;
          s_rm[k] = s_sd[k] = nan;
        }
        continue;
      }
      const T s1 = warp_tree<T>(w, [&](int j) { return rr(start + j); }, lane);
      const T mean = __shfl_sync(kFull, s1, 0) * inv_w;
      const T s2 = warp_tree<T>(w, [&](int j) {
        const T d = rr(start + j) - mean;
        return d * d;
      }, lane);
      const T s3 = warp_tree<T>(w - 1, [&](int j) {
        const T d = rr(start + j + 1) - rr(start + j);
        return d * d;
      }, lane);
      if (lane == 0) {
        const T sdnn = sqrt(s2 * inv_w);
        const T rmssd = sqrt(s3 * inv_w1);
        const T msec = mean * inv_1000;
        const T rmssdc = msec > T(0) ? rmssd / msec : T(0);
        const T wbpm = msec > T(0) ? (T(1) / msec) * T(60) : T(0);
        const T mid = (s_t[min(start, cap - 1)] + s_t[min(start + w, cap - 1)]) * T(0.5);
        out[k] = mid;
        out[plane + k] = rmssdc;
        out[2 * plane + k] = sdnn;
        out[3 * plane + k] = wbpm;
        s_rm[k] = rmssdc;
        s_sd[k] = sdnn;
      }
    }
    nwin = block_reduce(nwin, [](int a, int b) { return a + b; }, s_iscr);
  }

  // --- the summary numbers: nanmean_fixed, nanmin, nanmax -----------------
  auto nanmean = [&](int n, const T* x) {
    const T total = tree_sum(n, [&](int i) { return isnan(x[i]) ? T(0) : x[i]; }, s_red);
    int ok = 0;
    for (int i = tid; i < n; i += kThreads) ok += !isnan(x[i]);
    ok = block_reduce(ok, [](int a, int b) { return a + b; }, s_iscr);
    return total / T(ok);
  };
  T* sc = scalars + row;   // field f at sc[f * bsz]
  {
    const T avg = nanmean(cap, s_sm);
    T mn = inf, mx = -inf;
    int ok = 0;
    for (int i = tid; i < cap; i += kThreads) {
      const T v = s_sm[i];
      if (!isnan(v)) {
        mn = v < mn ? v : mn;
        mx = v > mx ? v : mx;
        ++ok;
      }
    }
    mn = block_reduce(mn, [](T a, T b) { return b < a ? b : a; }, s_tscr);
    mx = block_reduce(mx, [](T a, T b) { return b > a ? b : a; }, s_tscr);
    ok = block_reduce(ok, [](int a, int b) { return a + b; }, s_iscr);
    const T avg_rm = nanmean(hcap, s_rm);
    const T avg_sd = nanmean(hcap, s_sd);
    if (tid == 0) {
      const bool ne = vcount > 0;
      sc[16 * bsz] = ne ? avg : nan;
      sc[17 * bsz] = ne && ok > 0 ? mn : nan;
      sc[18 * bsz] = ne && ok > 0 ? mx : nan;
      sc[19 * bsz] = nwin > 0 ? avg_rm : nan;
      sc[20 * bsz] = nwin > 0 ? avg_sd : nan;
    }
  }

  // --- slope_extrema: the distance, then the curve's plateau maxima -------
  auto tt = [&](int i) { return i < vcount ? s_ct[i] : inf; };   // times, inf after
  int dist;
  {
    const T dtot = tree_sum(cap - 1, [&](int i) {
      if (i >= vcount - 1) return T(0);
      const T d = tt(i + 1) - tt(i);
      return isnan(d) ? T(0) : d;
    }, s_red);
    int ok = 0;
    for (int i = tid; i < cap - 1; i += kThreads) ok += i < vcount - 1 && !isnan(tt(i + 1) - tt(i));
    ok = block_reduce(ok, [](int a, int b) { return a + b; }, s_iscr);
    const T mean_dt = dtot / T(ok);
    const T safe = mean_dt == T(0) ? T(1) : mean_dt;
    dist = isnan(mean_dt) || mean_dt == T(0) ? 5 : (int)((T(1) / safe) * T(p.distance_num));
  }
  const T fill = vcount > 0 ? s_sm[vcount - 1] : nan;
  auto vv = [&](int j) { return j < vcount ? s_sm[j] : fill; };
  int* chunk_last = s_iscr + 2 * kWarps;
  int* chunk_first = chunk_last + kThreads;
  {
    int last = -1, first = cap;
    for (int i = a0; i < a1; ++i)
      if (i == 0 || vv(i) != vv(i - 1)) last = i;
    for (int i = a0; i < a1; ++i) {
      if (i == cap - 1 || vv(i) != vv(i + 1)) {
        first = i;
        break;
      }
    }
    chunk_last[tid] = last;
    chunk_first[tid] = first;
  }
  __syncthreads();
  int nmax = 0, nmin = 0;   // this chunk's maxima and minima
  {
    int rs = -1, re = cap;
    for (int k = tid - 1; k >= 0 && rs < 0; --k) rs = chunk_last[k];
    for (int k = tid + 1; k < kThreads && re == cap; ++k) re = chunk_first[k];
    for (int i = a0; i < a1; ++i) {
      if (i == 0 || vv(i) != vv(i - 1)) rs = i;
      s_rs[i] = rs;
    }
    for (int i = a1 - 1; i >= a0; --i) {
      if (i == cap - 1 || vv(i) != vv(i + 1)) re = i;
      const int r0 = max(s_rs[i], 0), r1 = min(re, cap - 1);
      uint8_t bits = 0;
      if (r0 >= 1 && r1 <= cap - 2 && i == (r0 + r1) / 2) {
        const T xs = vv(r0), xe = vv(r1), xl = vv(r0 - 1), xr = vv(r1 + 1);
        const bool is_max = xl < xs && xr < xe;
        const bool is_min = xl > xs && xr > xe;   // maxima of -x: -a < -b iff a > b
        bits = (uint8_t)(is_max | (is_min << 1));
      }
      s_mask[i] = bits;
      nmax += bits & 1;
      nmin += bits >> 1;
    }
  }
  int ncand[2];
  {
    int ap = block_exclusive_sum(nmax, &ncand[0], s_iscr);
    int at_ = block_exclusive_sum(nmin, &ncand[1], s_iscr);
    for (int i = a0; i < a1; ++i) {
      const int bits = s_mask[i];
      if (bits & 1) {
        if (ap < kWork) s_cand[ap] = i;
        ++ap;
      }
      if (bits & 2) {
        if (at_ < kWork) s_cand[kWork + at_] = i;
        ++at_;
      }
    }
  }
  ncand[0] = min(ncand[0], kWork);
  ncand[1] = min(ncand[1], kWork);
  __syncthreads();

  // --- distance suppression (find_peaks' _select_by_distance) -------------
  auto xk = [&](int kind, int j) {   // the curve (kind 0) or its negation (kind 1)
    const T v = vv(j);
    return kind ? -v : v;
  };
  const float distf = ceilf((float)dist);
  for (int s = tid; s < 2 * kWork; s += kThreads) {
    const int kind = s / kWork, j = s % kWork, K = ncand[kind];
    const int* cand = s_cand + kind * kWork;
    if (j < K) {
      s_posf[s] = (float)cand[j];
      s_prio[s] = (float)xk(kind, cand[j]);
    } else {
      const float top = K > 0 ? (float)cand[K - 1] : -__int_as_float(0x7f800000);
      const float base = top + distf + 1.0f;
      s_posf[s] = base + (float)j * (distf + 1.0f);
      s_prio[s] = -FLT_MAX;
    }
    s_flag[s] = 0;
  }
  __syncthreads();
  for (int s = tid; s < 2 * kWork; s += kThreads) {
    const int kind = s / kWork, j = s % kWork, K = ncand[kind];
    if (j >= K) continue;
    const float* posf = s_posf + kind * kWork;
    const float* prio = s_prio + kind * kWork;
    auto at_pos = [&](int q) { return posf[q]; };
    s_lo[s] = upper_bound(kWork, at_pos, posf[j] - distf);
    s_hi[s] = lower_bound(kWork, at_pos, posf[j] + distf) - 1;
    // Processing order: priority descending, the later slot first among
    // equal priorities (a stable ascending argsort, flipped).
    const float pj = prio[j];
    int rank = 0;
    for (int i = 0; i < K; ++i)
      rank += sort_less(pj, prio[i]) || (i > j && !sort_less(prio[i], pj));
    s_order[kind * kWork + rank] = j;
  }
  __syncthreads();
  if (lane == 0 && warp < 2) {   // warp 0 walks the peaks, warp 1 the troughs
    const int kind = warp, K = ncand[kind];
    uint8_t* flag = s_flag + kind * kWork;   // 1 suppressed, 2 kept
    for (int r = 0; r < K; ++r) {
      const int j = s_order[kind * kWork + r];
      if (flag[j]) continue;
      const int lo = max(s_lo[kind * kWork + j], 0), hi = min(s_hi[kind * kWork + j], kWork - 1);
      for (int q = lo; q <= hi; ++q)
        if (!flag[q]) flag[q] = 1;
      flag[j] = 2;
    }
  }
  __syncthreads();
  int nsurv[2];
  for (int kind = 0; kind < 2; ++kind) {
    const bool kept = s_flag[kind * kWork + tid] == 2;
    const int a = block_exclusive_sum(kept, &nsurv[kind], s_iscr);
    if (kept) s_surv[kind * kWork + a] = s_cand[kind * kWork + tid];
  }
  __syncthreads();

  // --- prominences (dense), the threshold, recompaction to 64 -------------
  {
    const T thr = T(p.prominence);
    for (int s = tid; s < 2 * kWork; s += kThreads) {
      const int kind = s / kWork, j = s % kWork;
      if (j >= nsurv[kind]) continue;
      const int pp = s_surv[s];
      const T v = xk(kind, pp);
      T lmin = v, rmin = v;
      for (int q = pp - 1; q >= 0; --q) {
        const T x = xk(kind, q);
        if (!(x <= v)) break;
        lmin = x < lmin ? x : lmin;
      }
      for (int q = pp + 1; q < cap; ++q) {
        const T x = xk(kind, q);
        if (!(x <= v)) break;
        rmin = x < rmin ? x : rmin;
        if (q >= vcount) break;   // the rest of the row holds the same value
      }
      s_keep[s] = v - (lmin > rmin ? lmin : rmin) >= thr;
    }
  }
  __syncthreads();
  int nfin[2];
  for (int kind = 0; kind < 2; ++kind) {
    const bool kept = tid < nsurv[kind] && s_keep[kind * kWork + tid];
    const int a = block_exclusive_sum(kept, &nfin[kind], s_iscr);
    if (kept && a < kSlopes) s_fin[kind * kSlopes + a] = s_surv[kind * kWork + tid];
    nfin[kind] = min(nfin[kind], kSlopes);
  }
  __syncthreads();

  // --- steepest_slope (exertion, recovery) and hrr ------------------------
  const int imax = block_argmax(cap, [&](int i) { return i < vcount ? s_sm[i] : -inf; },
                                s_tscr, s_iscr);
  {
    const T window = T(p.slope_window);
    for (int dir = 1; dir >= -1; dir -= 2) {
      const int start = dir > 0 ? 0 : imax;
      struct Step { T eff, te, ve, slope, dur; };
      auto step = [&](int i) {
        Step o;
        const T ti = tt(i);
        const int e = lower_bound(cap, tt, ti + window);
        const int ec = min(max(e, 0), cap - 1);
        o.te = tt(ec);
        o.dur = o.te - ti;
        const bool ok = i < vcount && i >= start && e < vcount && o.dur > T(0) &&
                        i < vcount - 1;
        o.ve = s_sm[ec];
        o.slope = (o.ve - s_sm[i]) / (ok ? o.dur : T(1));
        o.eff = ok ? o.slope * T(dir) : -inf;
        return o;
      };
      const int best = block_argmax(cap, [&](int i) {
        return i < vcount && i >= start ? step(i).eff : -inf;
      }, s_tscr, s_iscr);
      if (tid == 0) {
        const Step o = step(best);
        const T t0 = tt(min(start, cap - 1)), last_t = tt(max(vcount - 1, 0));
        const bool long_enough = vcount - start >= 2 && last_t - t0 >= window;
        T* f = sc + (dir > 0 ? 4 : 10) * bsz;
        f[0] = tt(best);
        f[bsz] = o.te;
        f[2 * bsz] = s_sm[best];
        f[3 * bsz] = o.ve;
        f[4 * bsz] = o.slope;
        f[5 * bsz] = o.dur;
        found[(dir > 0 ? 1 : 2) * bsz + row] = long_enough && o.eff > T(0);
      }
    }
  }
  if (tid == 0) {
    auto vneg = [&](int i) { return i < vcount ? s_sm[i] : -inf; };
    const T peak_bpm = vneg(imax), peak_time = tt(imax);
    const T check = peak_time + T(p.hrr_interval);
    const int last_i = max(vcount - 1, 0);
    const T last_t = tt(last_i), last_v = vneg(last_i);
    auto tq = [&](int i) {
      const T x = i < vcount ? s_ct[i] : last_t;
      return p.truncated_interp ? floor(x) : x;
    };
    auto vq = [&](int i) { return i < vcount ? s_sm[i] : last_v; };
    const int q = min(max(upper_bound(cap, tq, check), 1), cap - 1);
    const T f_lo = vq(q - 1), f_hi = vq(q), x_lo = tq(q - 1), x_hi = tq(q);
    const T df = f_hi - f_lo, dx = x_hi - x_lo, delta = check - x_lo;
    const bool dx0 = fabs(dx) <= T(p.interp_eps);
    T f = dx0 ? f_lo : f_lo + (delta / (dx0 ? T(1) : dx)) * df;
    if (check < tq(0)) f = vq(0);
    if (check > tq(cap - 1)) f = vq(cap - 1);
    sc[0] = peak_bpm;
    sc[bsz] = peak_time;
    sc[2 * bsz] = f;
    sc[3 * bsz] = peak_bpm - f;
    found[row] = vcount >= 2 && check <= last_t;
  }

  // --- major_slopes: inclines (troughs to peaks), declines ----------------
  if (tid < 2 * kSlopes) {
    const int list = tid / kSlopes, s = tid % kSlopes;   // list 0 inclines, 1 declines
    const bool decl = list == 1;
    const int* st = s_fin + (decl ? 0 : 1) * kSlopes;
    const int* en = s_fin + (decl ? 1 : 0) * kSlopes;
    const int ns = nfin[decl ? 0 : 1], ne = nfin[decl ? 1 : 0];
    const bool s_valid = s < ns;
    const int s_pos = s_valid ? st[s] : cap;
    auto e_pad = [&](int j) { return j < ne ? en[j] : cap; };
    const int nxt = upper_bound(kSlopes, e_pad, s_pos);
    const int e_pos = e_pad(min(max(nxt, 0), kSlopes - 1));
    const int s_c = min(max(s_pos, 0), cap - 1), e_c = min(max(e_pos, 0), cap - 1);
    const T ts = tt(s_c), te = tt(e_c), vs = s_sm[s_c], ve = s_sm[e_c];
    const T dur = te - ts, change = ve - vs;
    const T mag = decl ? -change : change;
    const bool ok = s_valid && nxt < ne && ne > 0 && ns > 0 && dur >= T(p.min_duration) &&
                    mag >= T(p.min_change) && vcount >= 2;
    const T slope = change / (dur > T(0) ? dur : T(1));
    T* f = s_sl + list * kSlotFields * kSlopes;
    f[0 * kSlopes + s] = ts;
    f[1 * kSlopes + s] = te;
    f[2 * kSlopes + s] = vs;
    f[3 * kSlopes + s] = ve;
    f[4 * kSlopes + s] = dur;
    f[5 * kSlopes + s] = change;
    f[6 * kSlopes + s] = slope;
    f[7 * kSlopes + s] = ok ? (decl ? slope : -slope) : inf;
    s_keep[tid] = ok;
  }
  __syncthreads();
  if (tid < 2 * kSlopes) {
    const int list = tid / kSlopes, s = tid % kSlopes;
    const T* f = s_sl + list * kSlotFields * kSlopes;
    const T* key = f + 7 * kSlopes;
    int n = 0, rank = 0;
    for (int j = 0; j < kSlopes; ++j) {
      n += s_keep[list * kSlopes + j];
      rank += sort_less(key[j], key[s]) || (j < s && !sort_less(key[s], key[j]));
    }
    const size_t plane = (size_t)bsz * kSlopes;
    T* out = slopes + (size_t)list * kListFields * plane + (size_t)row * kSlopes;
    if (rank < n)
      for (int k = 0; k < kListFields; ++k) out[k * plane + rank] = f[k * kSlopes + s];
    if (s >= n)
      for (int k = 0; k < kListFields; ++k) out[k * plane + s] = nan;
    if (s == 0) counts[(2 + list) * bsz + row] = n;
  }

  // --- the series ---------------------------------------------------------
  const size_t plane = (size_t)bsz * cap;
  for (int i = tid; i < cap; i += kThreads) {
    series[(size_t)row * cap + i] = s_ct[i];
    series[plane + (size_t)row * cap + i] = s_sm[i];
    series[2 * plane + (size_t)row * cap + i] = s_ci[i];
  }
  if (tid == 0) {
    counts[row] = vcount;
    counts[bsz + row] = nwin;
  }
}

// Blocks loop over the rows: one block a row where the layout fits shared
// memory; else (kSpill) as many as the scratch holds, each with its part.
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kThreads)
metrics_kernel(const int32_t* __restrict__ positions, const int32_t* __restrict__ count,
               const Params p, const int bsz, T* __restrict__ series, T* __restrict__ hrv,
               T* __restrict__ slopes, T* __restrict__ scalars, int32_t* __restrict__ counts,
               uint8_t* __restrict__ found, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(p.cap, p.hrv_cap, sizeof(T));
  unsigned char* rows = kSpill ? scratch + (size_t)blockIdx.x * L.row : smem;
  unsigned char* fixed = kSpill ? smem : smem + L.row;
  for (int row = blockIdx.x; row < bsz; row += gridDim.x) {
    metrics_row<T>(row, L, rows, fixed, positions, count, p, bsz, series, hrv, slopes, scalars,
                   counts, found);
    __syncthreads();
  }
}

template <typename T, bool kSpill>
int launch_as(const Layout& L, int blocks, const int32_t* positions, const int32_t* count,
              const Params& p, int bsz, T* series, T* hrv, T* slopes, T* scalars,
              int32_t* counts, uint8_t* found, unsigned char* scratch, cudaStream_t stream) {
  const size_t bytes = kSpill ? L.fixed : L.row + L.fixed;
  cudaError_t e = cudaFuncSetAttribute(metrics_kernel<T, kSpill>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  metrics_kernel<T, kSpill><<<blocks, kThreads, bytes, stream>>>(
      positions, count, p, bsz, series, hrv, slopes, scalars, counts, found, scratch);
  return (int)cudaGetLastError();
}

// ints: cap, max_slots (-1: unbounded), hrv_window, hrv_step, hrv_cap,
// truncated_interp; reals: Params' doubles in order.  `scratch` holds
// `blocks` row regions where the layout spills (metrics_scratch_bytes);
// else it is unused and one block takes each row.
template <typename T>
int launch(const int32_t* positions, const int32_t* count, const int* ints, const double* reals,
           int bsz, T* series, T* hrv, T* slopes, T* scalars, int32_t* counts, uint8_t* found,
           unsigned char* scratch, int blocks, void* stream) {
  Params p;
  p.cap = ints[0];
  p.max_slots = ints[1];
  p.hrv_window = ints[2];
  p.hrv_step = ints[3];
  p.hrv_cap = ints[4];
  p.truncated_interp = ints[5];
  p.inv_rate = reals[0];
  p.half_window = reals[1];
  p.min_diff = reals[2];
  p.inv_hrv_window = reals[3];
  p.inv_hrv_window1 = reals[4];
  p.inv_1000 = reals[5];
  p.slope_window = reals[6];
  p.hrr_interval = reals[7];
  p.interp_eps = reals[8];
  p.distance_num = reals[9];
  p.min_duration = reals[10];
  p.min_change = reals[11];
  p.prominence = reals[12];
  if (bsz <= 0 || p.cap < 2 || p.hrv_window < 1 || p.hrv_cap < 1 ||
      p.max_slots >= p.cap)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(p.cap, p.hrv_cap, sizeof(T));
  const cudaStream_t st = (cudaStream_t)stream;
  if (!spills(L))
    return launch_as<T, false>(L, bsz, positions, count, p, bsz, series, hrv, slopes, scalars,
                               counts, found, nullptr, st);
  if (scratch == nullptr || blocks < 1) return (int)cudaErrorInvalidValue;
  return launch_as<T, true>(L, blocks < bsz ? blocks : bsz, positions, count, p, bsz, series,
                            hrv, slopes, scalars, counts, found, scratch, st);
}

}  // namespace

extern "C" int metrics_f32(const int32_t* positions, const int32_t* count, const int* ints,
                           const double* reals, int bsz, float* series, float* hrv,
                           float* slopes, float* scalars, int32_t* counts, uint8_t* found,
                           unsigned char* scratch, int blocks, void* stream) {
  return launch<float>(positions, count, ints, reals, bsz, series, hrv, slopes, scalars, counts,
                       found, scratch, blocks, stream);
}

extern "C" int metrics_f64(const int32_t* positions, const int32_t* count, const int* ints,
                           const double* reals, int bsz, double* series, double* hrv,
                           double* slopes, double* scalars, int32_t* counts, uint8_t* found,
                           unsigned char* scratch, int blocks, void* stream) {
  return launch<double>(positions, count, ints, reals, bsz, series, hrv, slopes, scalars,
                        counts, found, scratch, blocks, stream);
}

// The global scratch of one block, in bytes: its row region where the
// layout spills out of shared memory, else 0.
extern "C" long long metrics_scratch_bytes(int cap, int hrv_cap, int itemsize) {
  const Layout L = layout(cap, hrv_cap, itemsize);
  return spills(L) ? (long long)L.row : 0;
}

extern "C" const char* metrics_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
