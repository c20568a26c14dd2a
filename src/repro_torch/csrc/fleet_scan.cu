// Fused multi-tenant fleet scan for Hopper (sm_90a), float64.
//
// out[t, n] = AND over c of (p_min[t, n, c] <= q_hi[t, c] && p_max[t, n, c] >= q_lo[t, c])
//
// Replaces the TPU kernel src/repro/kernels/fleet_scan/fleet_scan.py:30-115
// (_kernel / _scan_fleet_call behind scan_fleet_pallas).  Every tenant's
// query is held against that tenant's own packed plane of N = S * P
// state-partition slots.  The TPU kernel casts to float32 behind a guard
// that falls back to numpy whenever a bound is not float32-exact; this one
// compares in float64, is exact on every input (+-inf included: padded
// slots carry [+inf, -inf] and query-less tenants [-inf, +inf], and neither
// is a special case) and needs no guard.  C = 0 scans every slot.  The plane
// operand takes a tenant stride and a slot stride with dense columns, so a
// (T_cap, S_cap * P_cap, C) view of the fleet plane is read in place.
//
// Bound: bytes.  It reads (2TC + 2TNC) * 8 bytes and writes TN bytes: at
// the fleet cells' shapes (T = 16..64, N = 100..400, C = 8..10) tens to
// hundreds of kilobytes, well under a microsecond at 3.35 TB/s, so a
// launch costs more than the work.
//
// Design: simple and right.  One thread per (t, n) output walks the
// columns and stops at the first one that does not overlap.  Threads of a
// tenant read the same query row (an L1 broadcast); a slot's columns are
// contiguous.  The grid is one-dimensional and grid-strided with 64-bit
// indices, so any T * N is covered without the 65,535-block limit of the
// y and z grid axes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
fleet_scan_kernel(const double* __restrict__ q_lo,
                  const double* __restrict__ q_hi,
                  const double* __restrict__ p_min,
                  const double* __restrict__ p_max, int64_t t_stride,
                  int64_t n_stride, uint8_t* __restrict__ out, int64_t T,
                  int64_t N, int C) {
  const int64_t total = T * N;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kThreads) {
    const int64_t t = idx / N;
    const int64_t n = idx - t * N;
    const int64_t off = t * t_stride + n * n_stride;
    const double* mn = p_min + off;
    const double* mx = p_max + off;
    const double* lo = q_lo + t * C;
    const double* hi = q_hi + t * C;
    bool keep = true;
    for (int c = 0; c < C && keep; ++c) {
      keep = mn[c] <= hi[c] && mx[c] >= lo[c];
    }
    out[idx] = keep ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// T and N must be positive; query bounds are contiguous (T, C); the caller
// allocates `out` as (T, N) bytes.
extern "C" int fleet_scan(const double* q_lo, const double* q_hi,
                          const double* p_min, const double* p_max,
                          int64_t t_stride, int64_t n_stride, uint8_t* out,
                          int64_t T, int64_t N, int C, void* stream) {
  const int64_t blocks = (T * N + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  fleet_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q_lo, q_hi, p_min, p_max, t_stride, n_stride, out, T, N, C);
  return (int)cudaGetLastError();
}
