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
// one compares in float64, is exact on every input (+-inf and NaN
// included) and needs no guard; `freq` is count / W, exact; `cost` sums
// each (b, t, s) over P in one fixed order inside one block (no float
// atomics), so two runs give the same bits.
//
// Bound: bytes.  It reads the plane (2 TSPC doubles), the frames (2 BTC),
// the row counts (TSP), the inverse totals (TS) and the window (2 WC) once,
// and writes BTSP scan bytes, BTS cost doubles and TSP freq doubles: at the
// fleet cells' shapes tens to hundreds of kilobytes, a fraction of a
// microsecond at 3.35 TB/s, so the body's latency is what a launch costs.
//
// Design: one shared-memory tile per tenant (fleet_tile.cuh).  A block
// stages a tenant's slots, or a chunk of them, and that tenant's frames
// with one barrier, and each thread ANDs all C columns of four slots (one,
// below four frames) for a frame and stores four scan bytes at once.
// `path` forces one or four slots a thread for measurement.  The earlier
// design took
// one block per (t, s) state with a thread per partition (8 or 16 of 32
// lanes working at the fleet cells' shapes) and read each frame's bounds
// from device memory in an early-exit column loop, a chain of dependent
// loads per frame: 0.0219 ms of device time at fleet64's pass, 30 times
// its bound, and 0.057 ms for the planner's freq-only launch, whose two
// blocks walked the window row by row.
#include "fleet_tile.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(fleet_tile::kMaxThreads)
decision_fused_kernel(const fleet_tile::Args a) {
  fleet_tile::tile_body<K>(a);
}

}  // namespace

// The largest column count the kernel takes: a tile of four slots and one
// row of bounds must fit in a block's 227 KB of shared memory.
extern "C" int decision_fused_max_columns(void) {
  return fleet_tile::max_columns();
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue, launching nothing, past the column limit or for a
// path other than 0 (the plan's choice), 1 (one slot a thread) or 2 (four).
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
                              int W, int path, void* stream) {
  if (C > fleet_tile::max_columns() || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  fleet_tile::Args a = {};
  a.q_lo = q_lo;
  a.q_hi = q_hi;
  a.p_min = p_min;
  a.p_max = p_max;
  a.t_stride = t_stride;
  a.s_stride = s_stride;
  a.p_stride = p_stride;
  a.rows = rows;
  a.inv_totals = inv_totals;
  a.w_lo = w_lo;
  a.w_hi = w_hi;
  a.scan = scan;
  a.cost = cost;
  a.freq = freq;
  a.T = T;
  a.S = S;
  a.P = P;
  a.N = (int64_t)S * P;
  a.C = C;
  a.B = B;
  a.W = W;
  a.dense = p_stride == C && (S == 1 || s_stride == (int64_t)P * C);
  const bool frames = B > 0 && (scan != nullptr || cost != nullptr);
  const fleet_tile::Plan pl = fleet_tile::plan(
      T, S, P, C, B, W, frames, cost != nullptr, freq != nullptr,
      fleet_tile::multiprocessors(), path);
  return fleet_tile::launch(a, pl, decision_fused_kernel<1>,
                            decision_fused_kernel<4>, (cudaStream_t)stream);
}
