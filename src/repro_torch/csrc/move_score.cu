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
// 0).  C = 0 scans every partition (1.0).  The plane operand takes a state
// stride and a partition stride with dense columns, so a row-strided view
// is read in place.
//
// Bound: bytes.  It reads the plane (2 SPC doubles) and the window (2 QC)
// once and writes SP doubles: at the planner's shape (Q = 64, S = 2,
// P = 16..32, C = 8..32) a few tens of kilobytes, a fraction of a
// microsecond at 3.35 TB/s, so a launch costs more than the work.
//
// Design: simple and right.  The (Q, C) window is staged in shared memory
// once per block, in tiles of at most 48 KB (the planner's whole window,
// 64 x 32 bounds, is 32 KB: one tile).  Each warp owns one (s, p) output:
// its lanes take the window rows q = lane, lane + 32, ..., each stopping a
// row at its first non-overlapping column, and one integer warp reduction
// (__reduce_add_sync) sums their counts.  A first version gave each
// thread a whole output and walked all Q rows in one dependent chain of
// shared-memory and L1 loads: 0.043 ms per launch at the planner's shape,
// latency and not bandwidth; splitting the rows over the warp's lanes
// shortens the chain 32-fold.  The grid is one-dimensional and
// grid-strided with 64-bit indices, so any S * P is covered without the
// 65,535-block limit of the y and z grid axes; all threads of a block run
// the same number of grid-stride rounds, so the tile loop's barriers are
// uniform.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kTileBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
move_score_kernel(const double* __restrict__ q_lo,
                  const double* __restrict__ q_hi,
                  const double* __restrict__ p_min,
                  const double* __restrict__ p_max, int64_t s_stride,
                  int64_t p_stride, double* __restrict__ out, int Q,
                  int64_t S, int64_t P, int C, int tile_q) {
  extern __shared__ double smem[];
  double* s_lo = smem;                           // [tile_q][C]
  double* s_hi = smem + (int64_t)tile_q * C;     // [tile_q][C]
  const int lane = threadIdx.x % kWarp;
  const int64_t total = S * P;
  for (int64_t base = (int64_t)blockIdx.x * kWarpsPerBlock; base < total;
       base += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t idx = base + threadIdx.x / kWarp;   // this warp's output
    const bool live = idx < total;
    const int64_t s = live ? idx / P : 0;
    const int64_t p = live ? idx - s * P : 0;
    const double* mn = p_min + s * s_stride + p * p_stride;
    const double* mx = p_max + s * s_stride + p * p_stride;
    int count = 0;
    for (int q0 = 0; q0 < Q; q0 += tile_q) {
      const int qw = min(tile_q, Q - q0);
      __syncthreads();                           // the last tile's readers
      for (int e = threadIdx.x; e < qw * C; e += kThreads) {
        s_lo[e] = q_lo[(int64_t)q0 * C + e];
        s_hi[e] = q_hi[(int64_t)q0 * C + e];
      }
      __syncthreads();
      if (live) {
        for (int q = lane; q < qw; q += kWarp) {
          const double* lo = s_lo + (int64_t)q * C;
          const double* hi = s_hi + (int64_t)q * C;
          bool keep = true;
          for (int c = 0; c < C && keep; ++c) {
            keep = mn[c] <= hi[c] && mx[c] >= lo[c];
          }
          count += keep ? 1 : 0;
        }
      }
    }
    // Whole warps are live or not (a warp owns one output), so the full
    // mask is right; integer sums are exact in any order.
    if (live) {
      count = __reduce_add_sync(0xffffffffu, count);
      if (lane == 0) out[idx] = (double)count / (double)Q;
    }
  }
}

}  // namespace

// The largest column count the kernel takes: the same as decision_fused's
// (one warp-wide tile of bounds in a block's 227 KB of shared memory), so
// every plane the fleet scores can also be planned over.
extern "C" int move_score_max_columns(void) {
  return (int)((232448 / sizeof(double) - 1) / (2 * kWarp));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Q and S * P must be positive and C at most move_score_max_columns().
// The window (Q, C) is contiguous; the plane has dense columns and the
// given state and partition strides.  The caller allocates `out` as (S, P)
// contiguous doubles.
extern "C" int move_score(const double* q_lo, const double* q_hi,
                          const double* p_min, const double* p_max,
                          int64_t s_stride, int64_t p_stride, double* out,
                          int Q, int64_t S, int64_t P, int C, void* stream) {
  int tile_q = Q;
  if (C > 0) {
    const int fit = kTileBytes / (2 * (int)sizeof(double) * C);
    tile_q = fit < Q ? fit : Q;
  }
  const size_t smem = 2 * (size_t)tile_q * C * sizeof(double);
  const int64_t blocks = (S * P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  move_score_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q_lo, q_hi, p_min, p_max, s_stride, p_stride, out, Q, S, P, C, tile_q);
  return (int)cudaGetLastError();
}
