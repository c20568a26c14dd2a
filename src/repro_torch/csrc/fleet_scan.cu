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
// is a special case; a NaN bound fails its compare) and needs no guard.
// C = 0 scans every slot.  The plane operand takes a tenant stride and a
// slot stride with dense columns, so a (T_cap, S_cap * P_cap, C) view of
// the fleet plane is read in place.
//
// Bound: bytes.  It reads (2TC + 2TNC) * 8 bytes and writes TN bytes: at
// the fleet cells' shapes (T = 16..128, N = 96..400, C = 8..10) tens to
// hundreds of kilobytes, well under a microsecond at 3.35 TB/s, so the
// body's latency is what a launch costs.
//
// Design: the decision kernel's tile for one frame (fleet_tile.cuh): the
// scan of decision_fused.cu with B = 1, S = 1 and P = N.  A block stages
// a tenant's slots, or a chunk of them, and the tenant's query row with
// one barrier; each thread ANDs all C columns of one slot (four when
// `path` 2 forces it) and a ballot gives each quad's four flags to one
// lane, which stores them at once.  The earlier design gave one thread an
// output and read its slot's columns straight from device memory in an
// early-exit loop, on 48 of the 132 SMs at fleet64's frame.  Past the
// tile's column limit (fleet_tile::max_columns(), 2,905) a second kernel
// takes the rows: one thread an output, its columns read from device
// memory.
#include "fleet_tile.cuh"

namespace {

constexpr int kWideThreads = 256;

template <int K>
__global__ void __launch_bounds__(fleet_tile::kMaxThreads)
fleet_scan_kernel(const fleet_tile::Args a) {
  fleet_tile::tile_body<K>(a);
}

__global__ void __launch_bounds__(kWideThreads)
fleet_scan_wide_kernel(const fleet_tile::Args a) {
  const int64_t total = a.T * a.N;
  for (int64_t idx = (int64_t)blockIdx.x * kWideThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kWideThreads) {
    const int64_t t = idx / a.N, n = idx - t * a.N;
    const int64_t off = t * a.t_stride + n * a.p_stride;
    const double* lo = a.q_lo + t * a.C;
    const double* hi = a.q_hi + t * a.C;
    bool keep = true;
    for (int c = 0; c < a.C; ++c) {
      const double mn = a.p_min[off + c], mx = a.p_max[off + c];
      keep = keep & (mn <= hi[c] && mx >= lo[c]);
    }
    a.scan[idx] = keep ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue, launching nothing, for a path other than 0 (the
// plan's choice: one slot a thread for one frame), 1 (one slot a thread)
// or 2 (four).  T and N must be positive; query bounds are contiguous
// (T, C); the caller allocates `out` as (T, N) bytes.
extern "C" int fleet_scan(const double* q_lo, const double* q_hi,
                          const double* p_min, const double* p_max,
                          int64_t t_stride, int64_t n_stride, uint8_t* out,
                          int64_t T, int64_t N, int C, int path,
                          void* stream) {
  if (path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  fleet_tile::Args a = {};
  a.q_lo = q_lo;
  a.q_hi = q_hi;
  a.p_min = p_min;
  a.p_max = p_max;
  a.t_stride = t_stride;
  a.p_stride = n_stride;
  a.scan = out;
  a.T = T;
  a.S = 1;
  a.P = N;
  a.N = N;
  a.C = C;
  a.B = 1;
  a.dense = n_stride == C;
  if (C > fleet_tile::max_columns()) {
    const int64_t blocks = (T * N + kWideThreads - 1) / kWideThreads;
    fleet_scan_wide_kernel<<<(unsigned)(blocks < fleet_tile::kMaxBlocks
                                            ? blocks
                                            : fleet_tile::kMaxBlocks),
                             kWideThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const fleet_tile::Plan pl =
      fleet_tile::plan(T, 1, N, C, 1, 0, true, false, false,
                       fleet_tile::multiprocessors(), path);
  return fleet_tile::launch(a, pl, fleet_scan_kernel<1>,
                            fleet_scan_kernel<4>, (cudaStream_t)stream);
}
