// Rhythm correction's greedy scan — CUDA kernel for Hopper (sm_90a).
//
// Replaces the lax.scan of bpm_analysis_tpu/models/corrections.py:92 (stage 4,
// correct_peaks_by_rhythm), which the port's plain version runs as a Python
// loop (models/corrections.rhythm_scan_plain).  For each recording it walks
// the candidate slots left to right, carrying the last kept slot, position
// and amplitude: a slot closer than the row's threshold to the last kept
// peak either replaces it (if louder; the old one becomes the slot's
// victim) or is dropped.  Outputs per slot: written (kept when seen) and
// victim (the slot it unseated, or cap).  The median and the compaction
// around it stay PyTorch.
//
// The arithmetic repeats the plain loop's: the interval is the integer
// position difference converted to the working type and divided (div.rn) by
// the sample rate, which the wrapper rounds to that type as torch does; the
// comparisons are the plain version's.
//
// What bounds it on this card: the dependent chain of one step, times the
// capacity.  Memory traffic is the positions and amplitudes in and two
// bytes-to-ints per slot out (16 x 1536 slots: ~0.2 MB, 0.07 us at 3.35
// TB/s).  The chain from one step's carry to the next: position sub, int to
// float cvt, / sr (div.rn), < threshold, the replace/keep logic and the
// three carry selects, about 6 ALU operations and one division, ~65 cycles a
// step, 1536 steps ~0.05 ms at 1.98 GHz.
//
// Design: one thread per recording, the carry in registers, the slot inputs
// loaded 8 slots ahead of the 8 dependent steps (the JAX scan unrolls 8);
// templated on the scalar type.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kThreads = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rhythm_scan_kernel(const int32_t* __restrict__ pos, const T* __restrict__ amp,
                   const int32_t* __restrict__ count, const T* __restrict__ threshold,
                   T sr, int bsz, int cap, uint8_t* __restrict__ written,
                   int32_t* __restrict__ victim) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bsz) return;
  const size_t row = (size_t)b * cap;
  const int cnt = count[b];
  const T thr = threshold[b];
  int last_slot = 0;
  int last_pos = pos[row];
  T last_amp = amp[row];
  for (int i0 = 0; i0 < cap; i0 += kUnroll) {
    int p_[kUnroll];
    T a_[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = min(i0 + u, cap - 1);
      p_[u] = pos[row + i];
      a_[u] = amp[row + i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (i >= cap) break;
      const T interval = T(p_[u] - last_pos) / sr;
      const bool act = i < cnt && i > 0;
      const bool conflict = act && interval < thr;
      const bool replace = conflict && a_[u] > last_amp;
      const bool w = act && !(conflict && !replace);
      victim[row + i] = replace ? last_slot : cap;
      written[row + i] = w ? 1 : 0;
      if (w) {
        last_slot = i;
        last_pos = p_[u];
        last_amp = a_[u];
      }
    }
  }
}

template <typename T>
int launch(const int32_t* pos, const T* amp, const int32_t* count, const T* threshold, T sr,
           int bsz, int cap, uint8_t* written, int32_t* victim, void* stream) {
  const dim3 grid((bsz + kThreads - 1) / kThreads);
  rhythm_scan_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      pos, amp, count, threshold, sr, bsz, cap, written, victim);
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
