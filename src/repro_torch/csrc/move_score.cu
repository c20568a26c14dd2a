// Micro-move scan frequencies for Hopper (sm_90a), float64.
//
// out[s, p] = #{q : AND over c of (p_min[s,p,c] <= q_hi[q,c] &&
//                                  p_max[s,p,c] >= q_lo[q,c])} / Q
//
// Replaces the TPU kernel src/repro/kernels/move_score/move_score.py:37-104
// (_kernel / _move_scores_call behind move_scores_pallas).  That kernel
// compares in float32 and averages a float32 0/1 tile, so the reorg planner
// could use it for ordering only.  This one compares in float64 and counts
// the scanning queries in an integer (no float atomics, no float sum), then
// divides once: out is exactly count / Q, the value numpy's mean of the
// reference's exact 0/1 scan matrix gives, on every input (+-inf included:
// empty partitions and the planner's padding carry [+inf, -inf] and score
// 0; a NaN bound fails its compare).  C = 0 scans every partition (1.0).
// The plane operand takes a state stride and a partition stride with dense
// columns, so a row-strided view is read in place.
//
// Bound: bytes.  It reads the plane (2 SPC doubles) and the window (2 QC)
// once and writes SP doubles: at the planner's shape (Q = 64, S = 2,
// P = 16..32, C = 8..32) a few tens of kilobytes, a fraction of a
// microsecond at 3.35 TB/s, so a launch costs more than the work.
//
// Design: this function is the fleet decision kernel's `freq` output for
// one tenant, so the kernel is that kernel's shared-memory tile
// (fleet_tile.cuh, tile_body<K>) with T = 1, no frames and `freq` the only
// output.  A block takes a chunk of the S * P slots (the plan aims at two
// blocks an SM), stages their zone maps column-major and the window's rows
// by 8-byte cp.async behind one barrier, and each thread ANDs every column
// of four slots (one when `path` 1 forces it) for its share of the window
// rows; the integer counts add up in shared memory and count / Q is written
// once.  It replaced a warp per output whose lanes walked the window in an
// early-exit loop (0.0041 ms of device time at the fleet's planning shape,
// a block of 256 threads for 8 outputs) and refused more than 453 columns.
// Past the tile's column limit (fleet_tile::max_columns(), 2,905) a second
// kernel takes the plane, one thread an output reading the window from
// device memory, so every C is taken, as the TPU kernel's column loop
// takes it.
#include "fleet_tile.cuh"

namespace {

constexpr int kWideThreads = 256;

template <int K>
__global__ void __launch_bounds__(fleet_tile::kMaxThreads)
move_score_kernel(const fleet_tile::Args a) {
  fleet_tile::tile_body<K>(a);
}

__global__ void __launch_bounds__(kWideThreads)
move_score_kernel_wide(const fleet_tile::Args a) {
  for (int64_t idx = (int64_t)blockIdx.x * kWideThreads + threadIdx.x;
       idx < a.N; idx += (int64_t)gridDim.x * kWideThreads) {
    const int64_t s = idx / a.P, p = idx - s * a.P;
    const double* mn = a.p_min + s * a.s_stride + p * a.p_stride;
    const double* mx = a.p_max + s * a.s_stride + p * a.p_stride;
    int count = 0;
    for (int q = 0; q < a.W; ++q) {
      const double* lo = a.w_lo + (int64_t)q * a.C;
      const double* hi = a.w_hi + (int64_t)q * a.C;
      bool keep = true;
      for (int c = 0; c < a.C && keep; ++c) {
        keep = mn[c] <= hi[c] && mx[c] >= lo[c];
      }
      count += keep ? 1 : 0;
    }
    a.freq[idx] = (double)count / (double)a.W;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue, launching nothing, for a path other than 0 (the
// plan's choice: four slots a thread from four window rows up), 1 (one
// slot a thread) or 2 (four).  Q and S * P must be positive.  The window
// (Q, C) is contiguous; the plane has dense columns and the given state
// and partition strides.  The caller allocates `out` as (S, P) contiguous
// doubles.
extern "C" int move_score(const double* q_lo, const double* q_hi,
                          const double* p_min, const double* p_max,
                          int64_t s_stride, int64_t p_stride, double* out,
                          int Q, int64_t S, int64_t P, int C, int path,
                          void* stream) {
  if (path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  fleet_tile::Args a = {};
  a.p_min = p_min;
  a.p_max = p_max;
  a.s_stride = s_stride;
  a.p_stride = p_stride;
  a.w_lo = q_lo;
  a.w_hi = q_hi;
  a.freq = out;
  a.T = 1;
  a.S = S;
  a.P = P;
  a.N = S * P;
  a.C = C;
  a.W = Q;
  a.dense = p_stride == C && s_stride == P * C;
  if (C > fleet_tile::max_columns()) {
    const int64_t blocks = (a.N + kWideThreads - 1) / kWideThreads;
    move_score_kernel_wide<<<(unsigned)(blocks < fleet_tile::kMaxBlocks
                                            ? blocks
                                            : fleet_tile::kMaxBlocks),
                             kWideThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const fleet_tile::Plan pl =
      fleet_tile::plan(1, S, P, C, 0, Q, false, false, true,
                       fleet_tile::multiprocessors(), path);
  return fleet_tile::launch(a, pl, move_score_kernel<1>,
                            move_score_kernel<4>, (cudaStream_t)stream);
}
