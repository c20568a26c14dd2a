// Partition-pruning scan matrix for Hopper (sm_90a), float64.
//
// out[q, p] = AND over c of (p_min[p, c] <= q_hi[q, c] && p_max[p, c] >= q_lo[q, c])
//
// Replaces the TPU kernel src/repro/kernels/pruning/pruning.py:30-99
// (_kernel / _scan_matrix_call behind scan_matrix_pallas).  That kernel casts
// every bound to float32, so its caller guards it and falls back to numpy
// whenever a bound is not float32-exact; this one compares in float64, is
// exact on every input (+-inf included) and needs no guard.  C = 0 scans every
// partition.  The partition operand takes a row stride, so the StateMatrix
// plane's (n * P_cap, C) view is read in place.
//
// Bound: bytes.  It reads (2QC + 2PC) * 8 bytes and writes QP bytes, about
// 150 KB at the per-query shape (Q = 1, P = 9 * 32, C = 32): well under a
// microsecond at 3.35 TB/s, so a launch costs more than the work.
//
// Design: simple and right.  A block of 32 x 8 threads owns a tile of 32
// partitions by 8 queries; each thread owns one (q, p) output and loops over
// the columns.  Both tiles are staged through shared memory, 32 columns at a
// time, with rows padded by one element so the per-thread column reads do not
// collide on a bank.  Ragged edges are masked.  Query tiles beyond the
// 65,535-block grid limit are walked by a loop over blockIdx.y.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BP = 32;       // partitions per block: threadIdx.x, one warp
constexpr int BQ = 8;        // queries per block: threadIdx.y
constexpr int CC = 32;       // columns staged per chunk
constexpr int LD = CC + 1;   // padded shared-memory row

__global__ void __launch_bounds__(BP * BQ)
scan_matrix_kernel(const double* __restrict__ q_lo,
                   const double* __restrict__ q_hi, int64_t q_stride,
                   const double* __restrict__ p_min,
                   const double* __restrict__ p_max, int64_t p_stride,
                   uint8_t* __restrict__ out, int Q, int P, int C) {
  __shared__ double s_min[BP * LD];
  __shared__ double s_max[BP * LD];
  __shared__ double s_lo[BQ * LD];
  __shared__ double s_hi[BQ * LD];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * BP + tx;
  const int p0 = blockIdx.x * BP;
  const int p = p0 + tx;
  for (int64_t q0 = (int64_t)blockIdx.y * BQ; q0 < Q;
       q0 += (int64_t)gridDim.y * BQ) {
    const int64_t q = q0 + ty;
    bool keep = true;
    for (int c0 = 0; c0 < C; c0 += CC) {
      const int cw = min(CC, C - c0);
      for (int e = tid; e < BP * CC; e += BP * BQ) {
        const int r = e / CC, c = e % CC;
        if (p0 + r < P && c < cw) {
          const int64_t off = (int64_t)(p0 + r) * p_stride + c0 + c;
          s_min[r * LD + c] = p_min[off];
          s_max[r * LD + c] = p_max[off];
        }
      }
      for (int e = tid; e < BQ * CC; e += BP * BQ) {
        const int r = e / CC, c = e % CC;
        if (q0 + r < Q && c < cw) {
          const int64_t off = (q0 + r) * q_stride + c0 + c;
          s_lo[r * LD + c] = q_lo[off];
          s_hi[r * LD + c] = q_hi[off];
        }
      }
      __syncthreads();
      if (p < P && q < Q) {
        for (int c = 0; c < cw; ++c) {
          keep = keep && s_min[tx * LD + c] <= s_hi[ty * LD + c]
                      && s_max[tx * LD + c] >= s_lo[ty * LD + c];
        }
      }
      __syncthreads();
    }
    if (p < P && q < Q) out[q * P + p] = keep ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Q and P must be positive; the caller allocates `out` as (Q, P) bytes.
extern "C" int pruning_scan_matrix(const double* q_lo, const double* q_hi,
                                   int64_t q_stride, const double* p_min,
                                   const double* p_max, int64_t p_stride,
                                   uint8_t* out, int Q, int P, int C,
                                   void* stream) {
  const int64_t q_blocks = ((int64_t)Q + BQ - 1) / BQ;
  const dim3 block(BP, BQ);
  const dim3 grid((unsigned)((P + BP - 1) / BP),
                  (unsigned)(q_blocks < 65535 ? q_blocks : 65535));
  scan_matrix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      q_lo, q_hi, q_stride, p_min, p_max, p_stride, out, Q, P, C);
  return (int)cudaGetLastError();
}
