// Rhythm correction's greedy scan — CUDA kernel for Hopper (sm_90a).
//
// Replaces the lax.scan of bpm_analysis_tpu/models/corrections.py:92 (stage 4,
// correct_peaks_by_rhythm), which the port's plain version runs as a Python
// loop (models/corrections.rhythm_scan_plain).  For each recording it walks
// the candidate slots left to right, carrying the last kept slot, position
// and amplitude: an active slot (0 < i < count) closer than the row's
// threshold to the last kept peak either replaces it (if louder; the old one
// becomes the slot's victim) or is dropped.  Outputs per slot: written (kept
// when seen) and victim (the slot it unseated, or cap).  The median and the
// compaction around it stay PyTorch.
//
// No division on the chain.  The plain loop's test is f(d) < thr, with d the
// integer distance from the last kept position and f(d) = T(d) / sr in the
// working type T (an IEEE division; the wrapper rounds sr to T as torch
// does).  Positions lie in [0, n] with n < 2^24, so |d| <= D = 2^24 - 1 and
// T(d) is exact; conversion and division by a positive constant both round
// monotonically, so f is non-decreasing in d and
//     f(d) < thr  <=>  d < d*,   d* = min{d in [-D, D] : !(f(d) < thr)},
// d* = D + 1 where no d qualifies.  Warp 0 places d* once a row with the
// plain loop's own division, 32 candidates a round (5 rounds over the 2^25
// values; a bisection would chain 25 divisions).  The thresholds at the
// edges: NaN - no f(d) < NaN holds, d* = -D and nothing conflicts, as in the
// plain loop; +inf - every f(d) is finite and below it, d* = D + 1 and every
// active slot conflicts; -inf - d* = -D; a negative finite thr puts d* below
// 0, so only a slot behind the last kept position can conflict.  A step is
// then an integer subtract and compare, the amplitude compare, the decision
// and the three carry selects.
//
// Independent runs.  Where a row's active positions are non-decreasing, an
// active slot i with pos[i] - pos[i-1] >= d* is always written, unseats
// nothing and resets the carry to (i, pos[i], amp[i]): the last kept slot
// j < i has pos[j] <= pos[i-1], so its distance is at least d* too.  Such
// slots (and slot 0) start runs that depend on nothing before them; on the
// main path's rows nearly every run is one slot long.
//
// Design: one 128-thread block per recording.  The row goes in tiles of
// 2048 slots: positions and amplitudes staged in shared memory by coalesced
// loads, written and victim built in shared memory and stored coalesced.
// In each tile a block vote (__syncthreads_and) says whether the tile's
// active positions are non-decreasing and none lies below the carried last
// kept position.  If so, each thread owns a contiguous chunk of the tile and
// runs every run that starts in it to that run's end, past the chunk if need
// be; thread 0 starts at the tile's first slot from the carry, and the run
// that reaches the tile's end leaves its carry in shared memory for the next
// tile.  If not, thread 0 runs the tile's whole chain with the same step and
// the same integer threshold: the same function, one chain.  Slots at or
// past count get written 0 and victim cap and leave the carry alone.
//
// What bounds it on this card: bytes.  Device memory traffic is positions
// and amplitudes in, one byte and one int out per slot (16 x 1536 slots in
// float32: 0.32 MB, ~0.1 us at 3.35 TB/s).  The dependent chain is one
// division to place d*, then the longest run's steps at 4 operations each
// (subtract, compare, decision, select); at the main path's inputs the
// longest run is a few slots.  The kernel's own floor is one launch, one
// round trip of the staging loads and the 5 search rounds.  An unsorted row
// costs one divisionless chain of count steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;                    // slots staged a pass
constexpr int kPerThread = kTile / kThreads;   // staging loads a thread
constexpr int kSpan = (1 << 24) - 1;           // D: |pos[i] - pos[j]| <= D

// d* of the header note: the least d in [-kSpan, kSpan] with
// !(T(d) / sr < thr), or kSpan + 1.  Called by a whole warp; every lane
// returns it.  Each round, lane j tests the last value of the j-th of 32
// equal parts of [lo, hi); the first part whose last value passes holds d*.
template <typename T>
__device__ int conflict_limit(T thr, T sr, int lane) {
  int lo = -kSpan, hi = kSpan + 1;   // d* in [lo, hi]; hi passes or is kSpan + 1
  while (lo < hi) {
    const int part = (hi - lo + 31) / 32;
    const int last = lo + (lane + 1) * part - 1;
    const bool pass = last >= hi || !(T(last) / sr < thr);
    const unsigned votes = __ballot_sync(0xffffffffu, pass);
    if (votes == 0) return hi;   // lane 31 tested hi - 1 and it failed
    const int j = __ffs(votes) - 1;
    hi = min(lo + (j + 1) * part - 1, hi);
    lo += j * part;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rhythm_scan_kernel(const int32_t* __restrict__ pos, const T* __restrict__ amp,
                   const int32_t* __restrict__ count, const T* __restrict__ threshold,
                   T sr, int cap, uint8_t* __restrict__ written,
                   int32_t* __restrict__ victim) {
  __shared__ int s_pos[kTile];
  __shared__ T s_amp[kTile];
  __shared__ int s_victim[kTile];
  __shared__ uint8_t s_written[kTile];
  __shared__ int s_dstar, s_carry_slot, s_carry_pos;
  __shared__ T s_carry_amp;

  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * cap;
  const int cnt = count[blockIdx.x];
  int last_slot = 0, last_pos = 0;   // thread 0's carry at a tile's start
  T last_amp = T(0);

  for (int t0 = 0; t0 < cap; t0 += kTile) {
    const int nt = min(kTile, cap - t0);
    int p_[kPerThread];
    T a_[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = tid + u * kThreads;
      if (i < nt) {
        p_[u] = pos[row + t0 + i];
        a_[u] = amp[row + t0 + i];
      }
    }
    if (t0 == 0 && tid < 32) {   // while the loads are in flight
      const int d = conflict_limit(threshold[blockIdx.x], sr, tid);
      if (tid == 0) s_dstar = d;
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = tid + u * kThreads;
      if (i < nt) {
        s_pos[i] = p_[u];
        s_amp[i] = a_[u];
      }
    }
    __syncthreads();

    const int dstar = s_dstar;
    const int act_end = min(max(cnt - t0, 0), nt);   // tile slots >= act_end are inactive
    const int per = (nt + kThreads - 1) / kThreads;
    const int a = min(tid * per, nt), b = min(a + per, nt);
    if (tid == 0 && act_end > 0) {
      if (t0 == 0) {
        last_slot = 0;
        last_pos = s_pos[0];
        last_amp = s_amp[0];
      } else {
        last_slot = s_carry_slot;
        last_pos = s_carry_pos;
        last_amp = s_carry_amp;
      }
    }
    bool ok = tid > 0 || act_end == 0 || last_pos <= s_pos[0];
    for (int i = max(a, 1); i < min(b, act_end); ++i) ok = ok && s_pos[i] >= s_pos[i - 1];
    const bool sorted = __syncthreads_and(ok);

    for (int i = max(a, act_end); i < b; ++i) {
      s_written[i] = 0;
      s_victim[i] = cap;
    }
    // This thread's chain: thread 0 from the tile's first slot and the carry
    // (to the tile's active end if the tile is not sorted); another thread,
    // in a sorted tile, from the first run start in its chunk, with the
    // previous slot as the carry (the start is written whatever it holds).
    int i = -1, stop = b;   // i: the chain's first slot, -1 for none
    int c_slot = last_slot, c_pos = last_pos;
    T c_amp = last_amp;
    if (tid == 0) {
      i = 0;
      if (!sorted) stop = nt;
    } else if (sorted) {
      for (int k = a; k < min(b, act_end); ++k) {
        if (s_pos[k] - s_pos[k - 1] >= dstar) {
          i = k;
          c_slot = t0 + k - 1;
          c_pos = s_pos[k - 1];
          c_amp = s_amp[k - 1];
          break;
        }
      }
    }
    if (i >= 0) {
      for (; i < act_end; ++i) {
        const int p = s_pos[i];
        if (i >= stop && p - s_pos[i - 1] >= dstar) break;   // the next run's owner takes it
        const T av = s_amp[i];
        const bool act = t0 + i > 0;
        const bool conflict = act && p - c_pos < dstar;
        const bool replace = conflict && av > c_amp;
        const bool w = act && !(conflict && !replace);
        s_victim[i] = replace ? c_slot : cap;
        s_written[i] = w ? 1 : 0;
        if (w) {
          c_slot = t0 + i;
          c_pos = p;
          c_amp = av;
        }
      }
      if (i == nt) {   // the one chain that reached the tile's end, all active
        s_carry_slot = c_slot;
        s_carry_pos = c_pos;
        s_carry_amp = c_amp;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int k = tid + u * kThreads;
      if (k < nt) {
        written[row + t0 + k] = s_written[k];
        victim[row + t0 + k] = s_victim[k];
      }
    }
  }
}

template <typename T>
int launch(const int32_t* pos, const T* amp, const int32_t* count, const T* threshold, T sr,
           int bsz, int cap, uint8_t* written, int32_t* victim, void* stream) {
  rhythm_scan_kernel<T><<<bsz, kThreads, 0, (cudaStream_t)stream>>>(
      pos, amp, count, threshold, sr, cap, written, victim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rhythm_scan_f32(const int32_t* pos, const float* amp, const int32_t* count,
                               const float* threshold, float sr, int bsz, int cap,
                               uint8_t* written, int32_t* victim, void* stream) {
  return launch<float>(pos, amp, count, threshold, sr, bsz, cap, written, victim, stream);
}

extern "C" int rhythm_scan_f64(const int32_t* pos, const double* amp, const int32_t* count,
                               const double* threshold, double sr, int bsz, int cap,
                               uint8_t* written, int32_t* victim, void* stream) {
  return launch<double>(pos, amp, count, threshold, sr, bsz, cap, written, victim, stream);
}

extern "C" const char* rhythm_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
