// The fleet's decision plane in one pass, for Hopper (sm_90a), float64.
//
// For B frames of per-tenant queries (B, T, C) and the packed plane
// (T, S, P, C):
//   scan[b, t, s, p] = AND over c of (p_min[t,s,p,c] <= q_hi[b,t,c] &&
//                                      p_max[t,s,p,c] >= q_lo[b,t,c])
//   cost[b, t, s]    = (sum over p of scan[b,t,s,p] * rows[t,s,p]) * inv_totals[t,s]
//   freq[t, s, p]    = (number of window rows w whose (W, C) bounds overlap
//                       partition (t, s, p)) / W
// Each output is optional: `scan`, `cost` or `freq` may be null.
//
// Replaces the TPU kernel src/repro/kernels/decision_fused/decision_fused.py
// :44-220 (_overlap / _make_kernel / _fused_call behind
// fused_decision_pallas).  That kernel casts to float32, so its caller
// guards it and falls back to numpy whenever the plane is not
// float32-exact, which zone maps of float64 data almost never are.  This
// one compares in float64, is exact on every input (+-inf included) and
// needs no guard; `freq` is count / W, exact; `cost` sums each (b, t, s)
// over P in one fixed order inside one block (no float atomics), so two
// runs give the same bits.
//
// Bound: bytes.  It reads the plane (2 TSPC doubles), the frames (2 BTC),
// the row counts (TSP), the inverse totals (TS) and the window (2 WC) once,
// and writes BTSP scan bytes, BTS cost doubles and TSP freq doubles: at the
// fleet cells' shapes tens to hundreds of kilobytes, a fraction of a
// microsecond at 3.35 TB/s, so a launch costs more than the work.
//
// Design: simple and right.  One block per (t, s) state, threads over its
// partitions in tiles of blockDim.x.  A tile's zone-map rows are staged in
// dynamic shared memory, column-major so that the threads of a warp read
// consecutive words, and each row is read from device memory once for all
// B frames and all W window rows: the single read is the point of the TPU
// kernel.  For every frame each thread ANDs its partition's columns,
// stopping at the first miss, and writes its scan byte (coalesced along
// P).  The cost of a frame is a warp-shuffle tree over the tile's
// partitions, then thread 0 adds the warp sums in warp order to the
// frame's cost, tile after tile, and scales by the inverse total at the
// end.  The frame and window bounds are read straight from device memory:
// every thread of the block reads the same word, an L1 broadcast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWarp = 32;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kMaxThreads)
decision_fused_kernel(const double* __restrict__ q_lo,
                      const double* __restrict__ q_hi,
                      const double* __restrict__ p_min,
                      const double* __restrict__ p_max, int64_t t_stride,
                      int64_t s_stride, int64_t p_stride,
                      const double* __restrict__ rows,
                      const double* __restrict__ inv_totals,
                      const double* __restrict__ w_lo,
                      const double* __restrict__ w_hi,
                      uint8_t* __restrict__ scan, double* __restrict__ cost,
                      double* __restrict__ freq, int B, int T, int S, int P,
                      int C, int W) {
  extern __shared__ double smem[];
  const int tp = blockDim.x;                 // partitions per tile
  double* s_min = smem;                      // [C][tp]
  double* s_max = smem + (int64_t)C * tp;    // [C][tp]
  double* s_warp = smem + 2 * (int64_t)C * tp;   // [tp / 32]
  const int r = threadIdx.x;
  const int64_t states = (int64_t)T * S;
  for (int64_t ts = blockIdx.x; ts < states; ts += gridDim.x) {
    const int64_t t = ts / S;
    const int64_t s = ts - t * S;
    const double* base_min = p_min + t * t_stride + s * s_stride;
    const double* base_max = p_max + t * t_stride + s * s_stride;
    if (cost != nullptr && r == 0) {
      for (int b = 0; b < B; ++b) cost[((int64_t)b * T + t) * S + s] = 0.0;
    }
    for (int p0 = 0; p0 < P; p0 += tp) {
      const int pw = min(tp, P - p0);
      __syncthreads();                       // the last tile's readers are done
      for (int e = r; e < pw * C; e += tp) {
        const int pr = e / C, c = e - pr * C;
        const int64_t off = (int64_t)(p0 + pr) * p_stride + c;
        s_min[(int64_t)c * tp + pr] = base_min[off];
        s_max[(int64_t)c * tp + pr] = base_max[off];
      }
      __syncthreads();
      const bool live = r < pw;
      const int64_t p = p0 + r;
      if (scan != nullptr || cost != nullptr) {
        const double row = (cost != nullptr && live) ? rows[ts * P + p] : 0.0;
        for (int b = 0; b < B; ++b) {
          const int64_t bt = (int64_t)b * T + t;
          const double* lo = q_lo + bt * C;
          const double* hi = q_hi + bt * C;
          bool keep = live;
          for (int c = 0; c < C && keep; ++c) {
            keep = s_min[(int64_t)c * tp + r] <= hi[c] &&
                   s_max[(int64_t)c * tp + r] >= lo[c];
          }
          if (scan != nullptr && live) scan[(bt * S + s) * P + p] = keep ? 1 : 0;
          if (cost != nullptr) {
            double v = keep ? row : 0.0;
            for (int off = kWarp / 2; off > 0; off >>= 1) {
              v += __shfl_down_sync(0xffffffffu, v, off);
            }
            if ((r & (kWarp - 1)) == 0) s_warp[r / kWarp] = v;
            __syncthreads();
            if (r == 0) {
              double sum = 0.0;
              for (int w = 0; w < tp / kWarp; ++w) sum += s_warp[w];
              cost[bt * S + s] += sum;
            }
            __syncthreads();
          }
        }
      }
      if (freq != nullptr && live) {
        int count = 0;
        for (int w = 0; w < W; ++w) {
          const double* lo = w_lo + (int64_t)w * C;
          const double* hi = w_hi + (int64_t)w * C;
          bool keep = true;
          for (int c = 0; c < C && keep; ++c) {
            keep = s_min[(int64_t)c * tp + r] <= hi[c] &&
                   s_max[(int64_t)c * tp + r] >= lo[c];
          }
          count += keep ? 1 : 0;
        }
        freq[ts * P + p] = (double)count / (double)W;
      }
    }
    if (cost != nullptr && r == 0) {
      const double inv = inv_totals[ts];
      for (int b = 0; b < B; ++b) cost[((int64_t)b * T + t) * S + s] *= inv;
    }
  }
}

// Threads per block (a warp multiple, at most one tile of the partitions)
// and the dynamic shared memory they need.
int tile_threads(int P) {
  const int tp = ((P + kWarp - 1) / kWarp) * kWarp;
  return tp < kWarp ? kWarp : (tp > kMaxThreads ? kMaxThreads : tp);
}

size_t smem_bytes(int tp, int C) {
  return (2 * (size_t)C * tp + tp / kWarp) * sizeof(double);
}

}  // namespace

// The largest column count the kernel takes: one warp-wide tile of bounds
// must fit in a block's 227 KB of shared memory.
extern "C" int decision_fused_max_columns(void) {
  return (int)((232448 / sizeof(double) - 1) / (2 * kWarp));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// T * S must be positive.  Frames (B, T, C), rows (T, S, P), inverse
// totals (T, S) and window (W, C) are contiguous; the plane has dense
// columns and the given tenant, state and partition strides.  `rows` and
// `inv_totals` are read only when `cost` is given, the window only when
// `freq` is.  The caller allocates every output.
extern "C" int decision_fused(const double* q_lo, const double* q_hi,
                              const double* p_min, const double* p_max,
                              int64_t t_stride, int64_t s_stride,
                              int64_t p_stride, const double* rows,
                              const double* inv_totals, const double* w_lo,
                              const double* w_hi, uint8_t* scan, double* cost,
                              double* freq, int B, int T, int S, int P, int C,
                              int W, void* stream) {
  int tp = tile_threads(P);
  while (tp > kWarp && smem_bytes(tp, C) > 48 * 1024) tp -= kWarp;
  const size_t smem = smem_bytes(tp, C);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decision_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t states = (int64_t)T * S;
  const dim3 grid((unsigned)(states < kMaxBlocks ? states : kMaxBlocks));
  decision_fused_kernel<<<grid, tp, smem, (cudaStream_t)stream>>>(
      q_lo, q_hi, p_min, p_max, t_stride, s_stride, p_stride, rows,
      inv_totals, w_lo, w_hi, scan, cost, freq, B, T, S, P, C, W);
  return (int)cudaGetLastError();
}
