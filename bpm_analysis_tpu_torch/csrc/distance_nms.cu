// The peak finders' distance suppression — CUDA kernel for Hopper (sm_90a).
//
// Replaces an XLA computation of the JAX package, not a Pallas kernel:
// bpm_analysis_tpu/ops/find_peaks.py:498 _select_by_distance, whose
// lax.while_loop of parallel rounds the port's eager form
// (ops/find_peaks._select_by_distance_plain) runs as ~330 launches a round,
// each over the row's whole slot width in int64, with a blocking host read
// of `alive.any()` after every round (11-19 rounds a batch on the engine
// cells).  This kernel is one launch a call with every round on the card.
//
// For each row b it computes the plain version's keep mask bit for bit:
//
//   * priorities rounded to float32 (a float64 row as .to(torch.float32)
//     rounds it), -0.0 taken as +0.0, ordered by their sortable key (flip
//     every bit of a negative float, the sign bit of a non-negative one);
//     among equal keys the later slot ranks higher;
//   * the window of slot i: the run of valid slots j next to i, at most
//     `reach` slots away, with pos[j] > pos[i] - d on the left and
//     pos[j] < pos[i] + d on the right, each bound rounded to float32 once,
//     where d = ceil(float32(distance)) and pos the float32 positions
//     (exact below 2^24, which the wrapper checks); the plain version's
//     shifted compares reach `reach` slots (a static distance of up to 252)
//     and its binary searches the whole row;
//   * rounds until no slot is alive: every alive slot that ranks above
//     every alive slot of its window is kept, then every alive slot with a
//     slot kept in this round in its window dies;
//   * the result is keep & valid (an invalid slot is never alive and ends
//     every window).
//
// What bounds it on this card: bytes.  The least work reads each row's
// positions (int64), priorities and valid mask once and writes the keep
// mask once: 14 bytes a float32 slot, 275 MB at the fleet's two calls
// (512 x 22,014 and 512 x 16,384 slots), 0.08 ms at 3.35 TB/s; 587 MB,
// 0.175 ms at the stress cell's two calls of 512 x 40,958.
//
// Design:
//   * One 1024-thread block a row holds the row's state in shared memory
//     for all its rounds, 9 bytes a slot: the key (uint32), the float32
//     position and a state byte (valid, alive, kept this round, kept).
//     One block holds up to ~25,700 slots (opt-in dynamic shared memory).
//   * A wider row is split over a cluster of up to 8 blocks, each holding
//     a contiguous part; a window that crosses a part's edge reads the
//     neighbouring part through distributed shared memory, and one cluster
//     barrier ends each phase.  The wrapper chooses the split from the
//     slot width (ops/cuda/nms_kernel.plan).  Past 8 blocks the row lives
//     in a global scratch region of its one block; the code is the same,
//     reading through generic pointers.
//   * A round is two phases, each a scan out of every alive slot over its
//     window that stops at the first slot that decides it: (A) an alive
//     slot that ranks higher beats it, else it marks itself kept-this-round;
//     (B) a kept-this-round slot in its window kills it.  A phase writes
//     only bits that no scan of the same phase reads (A sets kept-this-round
//     and turns last round's into kept; B clears alive), each slot written
//     by its own thread, so the scans need no order within a phase.
//   * The block's or of "still alive" (__syncthreads_or, and each block's
//     flag read over the cluster) ends the loop: no host read.
//   * Templated on the priorities' dtype (float, double).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSplit = 8;
constexpr int kSlotBytes = 9;   // key (4), position (4), state (1)
constexpr uint8_t kValid = 1, kAlive = 2, kNew = 4, kKeep = 8;

// One block's part of a row: its key, position and state arrays of `chunk`
// slots, laid out one after the other from `base`.
struct Part {
  uint32_t* key;
  float* pos;
  uint8_t* st;
};

__device__ __forceinline__ Part part_at(unsigned char* base, int chunk) {
  Part p;
  p.key = reinterpret_cast<uint32_t*>(base);
  p.pos = reinterpret_cast<float*>(base + 4 * (size_t)chunk);
  p.st = base + 8 * (size_t)chunk;
  return p;
}

__device__ __forceinline__ void row_barrier(int split) {
  if (split > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t key_of(float f) {
  uint32_t bits = __float_as_uint(f);
  if (bits == 0x80000000u) bits = 0u;   // -0.0 + 0.0 == +0.0
  return (bits & 0x80000000u) ? ~bits : bits ^ 0x80000000u;
}

// Walks one side (kDir -1: left, +1: right) of the window of slot i, held
// at offset o of part r, one slot a step across the parts, and returns
// whether `hit(state, part, offset)` holds at some slot of the window; the
// walk ends at the row's edge, after `reach` slots, at an invalid slot and
// at the first slot past the position bound `lim`.
template <int kDir, typename Hit>
__device__ __forceinline__ bool scan(int i, int r, int o, float lim, int reach, int cap,
                                     int chunk, unsigned char* const* bases, Hit hit) {
  Part p = part_at(bases[r], chunk);
  for (int s = 1; s <= reach; ++s) {
    const int j = i + kDir * s;
    if (kDir < 0 ? j < 0 : j >= cap) return false;
    o += kDir;
    if (o < 0) {
      o = chunk - 1;
      p = part_at(bases[--r], chunk);
    } else if (o >= chunk) {
      o = 0;
      p = part_at(bases[++r], chunk);
    }
    const uint8_t st = p.st[o];
    if (!(st & kValid)) return false;
    const float pj = p.pos[o];
    if (kDir < 0 ? !(pj > lim) : !(pj < lim)) return false;
    if (hit(st, p, o)) return true;
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
distance_nms_kernel(const int64_t* __restrict__ positions, const T* __restrict__ priority,
                    const uint8_t* __restrict__ valid, const float* __restrict__ row_distance,
                    float distance, int cap, int reach, int split, int chunk,
                    unsigned char* __restrict__ scratch, size_t scratch_row,
                    uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned char* bases[kMaxSplit];
  __shared__ int alive_flag[2];                 // this block's "still alive", by round parity

  const int rank = blockIdx.x;                  // the block's part of its row
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  unsigned char* mine = scratch ? scratch + (size_t)b * scratch_row : smem;
  if (t < split) bases[t] = split > 1 ? cg::this_cluster().map_shared_rank(smem, t) : mine;
  const int first = rank * chunk;
  const int len = max(0, min(chunk, cap - first));
  const size_t row = (size_t)b * cap;
  const float d = ceilf(row_distance ? row_distance[b] : distance);
  const Part me = part_at(mine, chunk);

  for (int o = t; o < len; o += kThreads) {
    const size_t g = row + first + o;
    me.key[o] = key_of((float)priority[g]);
    me.pos[o] = (float)positions[g];
    me.st[o] = valid[g] ? (kValid | kAlive) : 0;
  }
  row_barrier(split);

  for (int round = 0;; ++round) {
    // (A) keep every alive slot that ranks above every alive slot of its window.
    for (int o = t; o < len; o += kThreads) {
      const uint8_t s = me.st[o];
      if (s & kNew) {
        me.st[o] = (uint8_t)((s & ~kNew) | kKeep);
        continue;
      }
      if (!(s & kAlive)) continue;
      const int i = first + o;
      const float p = me.pos[o];
      const uint32_t k = me.key[o];
      const bool beaten =
          scan<-1>(i, rank, o, __fsub_rn(p, d), reach, cap, chunk, bases,
                   [k](uint8_t sj, const Part& q, int oj) {
                     return (sj & kAlive) && q.key[oj] > k;
                   }) ||
          scan<1>(i, rank, o, __fadd_rn(p, d), reach, cap, chunk, bases,
                  [k](uint8_t sj, const Part& q, int oj) {
                    return (sj & kAlive) && q.key[oj] >= k;
                  });
      if (!beaten) me.st[o] = (uint8_t)(s | kNew);
    }
    row_barrier(split);

    // (B) every other alive slot with a slot kept in this round in its window dies.
    int alive = 0;
    for (int o = t; o < len; o += kThreads) {
      const uint8_t s = me.st[o];
      if (!(s & kAlive)) continue;
      if (s & kNew) {
        me.st[o] = kValid | kNew;
        continue;
      }
      const int i = first + o;
      const float p = me.pos[o];
      const auto kept = [](uint8_t sj, const Part&, int) { return (sj & kNew) != 0; };
      if (scan<-1>(i, rank, o, __fsub_rn(p, d), reach, cap, chunk, bases, kept) ||
          scan<1>(i, rank, o, __fadd_rn(p, d), reach, cap, chunk, bases, kept)) {
        me.st[o] = kValid;
      } else {
        alive = 1;
      }
    }
    alive = __syncthreads_or(alive);
    if (split > 1) {
      if (t == 0) alive_flag[round & 1] = alive;
      cg::this_cluster().sync();
      alive = 0;
      for (int r = 0; r < split; ++r) {
        alive |= *cg::this_cluster().map_shared_rank(&alive_flag[round & 1], r);
      }
    }
    if (!alive) break;
  }

  for (int o = t; o < len; o += kThreads) {
    keep[row + first + o] = (me.st[o] & (kNew | kKeep)) ? 1 : 0;
  }
  if (split > 1) cg::this_cluster().sync();   // no block leaves while another may read it
}

template <typename T>
int launch(const int64_t* positions, const T* priority, const uint8_t* valid,
           const float* row_distance, float distance, int batch, int cap, int reach,
           int split, int chunk, unsigned char* scratch, uint8_t* keep, void* stream) {
  if (batch < 1 || batch > 65535 || cap < 1 || reach < 0 || split < 1 || split > kMaxSplit ||
      chunk < 1 || (long long)split * chunk < cap || (long long)(split - 1) * chunk >= cap ||
      (scratch != nullptr && split != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t scratch_row = ((size_t)kSlotBytes * chunk + 15) / 16 * 16;
  const size_t smem = scratch ? 0 : (size_t)kSlotBytes * chunk;
  cudaError_t err = cudaFuncSetAttribute(distance_nms_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, distance_nms_kernel<T>, positions, priority, valid,
                           row_distance, distance, cap, reach, split, chunk, scratch,
                           scratch_row, keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// positions (B, cap) int64, priority (B, cap), valid and keep (B, cap) bool;
// row_distance (B,) float32 or null for `distance`; `scratch` null, or
// B * distance_nms_scratch_row(cap) bytes with split 1.
extern "C" int distance_nms_f32(const int64_t* positions, const float* priority,
                                const uint8_t* valid, const float* row_distance, float distance,
                                int batch, int cap, int reach, int split, int chunk,
                                unsigned char* scratch, uint8_t* keep, void* stream) {
  return launch<float>(positions, priority, valid, row_distance, distance, batch, cap, reach,
                       split, chunk, scratch, keep, stream);
}

extern "C" int distance_nms_f64(const int64_t* positions, const double* priority,
                                const uint8_t* valid, const float* row_distance, float distance,
                                int batch, int cap, int reach, int split, int chunk,
                                unsigned char* scratch, uint8_t* keep, void* stream) {
  return launch<double>(positions, priority, valid, row_distance, distance, batch, cap, reach,
                        split, chunk, scratch, keep, stream);
}

// Bytes of global scratch a row of `chunk` slots takes (16-byte aligned).
extern "C" long long distance_nms_scratch_row(int chunk) {
  return ((long long)kSlotBytes * chunk + 15) / 16 * 16;
}

extern "C" const char* distance_nms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
