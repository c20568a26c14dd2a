// Z-order (Morton) keys for Hopper (sm_90a), in two lanes from one template,
// and the 64-bit lane's keys routed to partitions in the same pass.
//
// key[i] = OR over b < bits, j < m of
//            bit b of code(v[i, j]) << (b * m + j)      (positions < width)
// code(v) = trunc(clamp((v - lo[j]) / max(hi[j] - lo[j], 1e-12), 0, 1)
//                 * (2^bits - 1))
//
// Replaces the TPU kernel src/repro/kernels/zorder/zorder.py:37-61
// (_kernel behind zorder_keys_pallas).  That kernel quantizes in float32 and
// takes m * bits <= 32 only, so the layout generator, whose keys are 16 bits
// of 3 columns in float64 into uint64, never called it.  Three entries:
//
//   (a) zorder_keys32: the TPU kernel's function.  A contiguous (N, m)
//       float32 array, float32 arithmetic, m * bits <= 32, uint32 keys.
//   (b) zorder_keys64: the layout generator's function (core/zorder.py).
//       m columns of an (N, C) float64 table read in place through its row
//       and column strides (both positive: a row-major table, a
//       column-major one or any strided view), float64 arithmetic, 16 bits
//       per column, 64-bit keys; bits that would land at positions >= 64
//       are dropped, as numpy's uint64 shift drops them.  The key is
//       written with bit 63 flipped, so signed int64 order is the unsigned
//       order and torch.searchsorted can route by it.
//   (c) zorder_route64: (b)'s key of each row routed through the k - 1
//       sorted (flipped) key boundaries of a Z-order layout:
//       id = min(searchsorted(boundaries, key, right=True), k - 1), int64,
//       without writing the key.  k <= zorder_max_parts().
//
// All write int64.  Each step is one IEEE operation rounded to nearest
// (__fsub_rn/__fdiv_rn/__fmul_rn and the __d* forms, and a true division:
// a reciprocal multiply changes codes at bucket edges), so nvcc's
// --fmad=true cannot contract the subtract and the multiply of a
// neighbouring step, then the code is truncated toward zero as numpy's and
// XLA's astype do.  The span keeps the reference's 1e-12 floor and the
// quotient its [0, 1] clamp: a full table routed with a sample's lo/hi has
// values outside that range.
//
// Bound: bytes.  A row needs its m key values and writes one int64.  The
// tpch-sf10-zorder cell routes a 59,986,052 x 32 row-major float64 table
// (256-byte rows) by 3 columns: 1,919,553,664 bytes, 0.573 ms at 3.35
// TB/s, a time only a columnar table can reach.  A row-major table cannot
// deliver less than the 32-byte sectors that hold the key columns: for 3
// columns in 3 sectors, 104 bytes a row with the id, 1.86 ms (the "sector
// floor").  On an H100 the loads of a row-major table move 64-byte sector
// pairs from DRAM: the time follows the pairs the key columns touch (3
// pairs for the cell's columns 4, 8 and 29), and asking L2 for a 32-byte
// fetch granularity changes nothing.
//
// Design, for the memory system:
//   * Read only where the key columns live, in well-formed requests.  Key
//     loads are ld.global.nc.L1::no_allocate with no L2 prefetch-size
//     qualifier (LDG.E.NA...CONSTANT in the SASS; the earlier design's
//     LDG.E.64.CONSTANT carried no LTC128B/LTC256B prefetch either); keys
//     and ids are written with streaming stores (STG.E.EF.64).
//   * How threads take rows follows the layout, chosen from the operands
//     (`path`; 0 = this choice, the others force one for measurement):
//     - a warp tile (row-major float64 rows on 64-byte boundaries, m <= 4
//       distinct key columns spanning two or more 64-byte sector pairs):
//       a warp takes 32 rows, loads every 16-byte chunk of the pairs that
//       hold a key column with coalesced vector loads, stages the key
//       values in shared memory and keys one row a lane.  The card moves
//       whole pairs anyway; asked for in full and in order they stream at
//       the table's own rate, where one scattered 8-byte load a value per
//       row ran about a fifth slower.
//     - kRows rows a thread, kThreads apart, all m * kRows loads issued
//       before any arithmetic, where consecutive rows are consecutive
//       elements (row stride 1: a column-major table): every warp load is
//       coalesced.
//     - one row a thread otherwise (strided views, narrow rows, one
//       pair), consecutive threads on consecutive rows; more rows a
//       thread, or a persistent grid, ran slower there.
//     A tail row reloads row n - 1 and stores nothing.  One block for
//     every kThreads (tile, one row) or kThreads * kRows rows.
//   * A loop-free bit spread.  For m <= 4 a 16-bit code reaches every m-th
//     bit in four shift-or-mask steps (chunks of 8, 4, 2 and 1 bits; m = 1
//     is the identity), and the key is the OR of the spread codes shifted
//     by j: the earlier design's 48-step bit loop cost more time than the
//     loads.  Lane (a) shares the spread: for m <= 4 and m * bits <= 32 it
//     stays below bit 32.  m >= 5 runs the bit loop with its drop of
//     positions >= width, one row a thread.
//   * Routing in the key pass.  The block stages the boundaries in shared
//     memory once, padded to a power of two with INT64_MAX, and each row
//     finds its id by a branch-free binary search (log2 + 1 compares).  A
//     padded entry counts only for the key INT64_MAX, whose id the clamp
//     to k - 1 already fixes.  The route takes the time of the keys alone,
//     and saves the key write and searchsorted's and clamp_max's passes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread a step: m <= 4, row stride 1
constexpr int kMaxCols = 32;
constexpr int kMaxBits = 16;
constexpr int kMaxBoundaries = 4096;  // 32 KB of shared memory
constexpr int64_t kMaxBlocks = 1 << 20;
// How threads take rows (zorder_keys64's and zorder_route64's `path`).
constexpr int kPathAuto = 0, kPathRow = 1, kPathRows = 2, kPathTile = 3;

struct Cols {
  int64_t off[kMaxCols];  // column index * column stride, in elements
};

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// Read-only loads that allocate no L1 line and ask L2 for no prefetch.
__device__ __forceinline__ float load_key(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p));
  return v;
}
__device__ __forceinline__ double load_key(const double* p) {
  double v;
  asm volatile("ld.global.nc.L1::no_allocate.f64 %0, [%1];"
               : "=d"(v)
               : "l"(p));
  return v;
}

__device__ __forceinline__ double2 load_chunk(const double* p) {
  double2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];"
               : "=d"(v.x), "=d"(v.y)
               : "l"(p));
  return v;
}

// The m-th-bit spread's mask after the step that moves chunks of s bits:
// s ones at every multiple of s * m.
template <int M, int S>
__host__ __device__ constexpr uint64_t spread_mask() {
  uint64_t mask = 0;
  for (int c = 0; c < kMaxBits / S; ++c)
    mask |= ((1ull << S) - 1) << (c * S * M);
  return mask;
}

// Bit b of a code below 2^16 to position b * M.  Before the step of s, the
// code sits in chunks of 2s bits at multiples of 2s * M; the step moves each
// chunk's upper half up by s * (M - 1).
template <int M>
__device__ __forceinline__ uint64_t spread(uint64_t x) {
  if (M > 1) {
    x = (x | (x << (8 * (M - 1)))) & spread_mask<M, 8>();
    x = (x | (x << (4 * (M - 1)))) & spread_mask<M, 4>();
    x = (x | (x << (2 * (M - 1)))) & spread_mask<M, 2>();
    x = (x | (x << (1 * (M - 1)))) & spread_mask<M, 1>();
  }
  return x;
}

template <typename F>
__device__ __forceinline__ uint32_t quantize(F v, F l, F span, F top) {
  F q = div_rn(sub_rn(v, l), span);
  q = q < (F)0 ? (F)0 : (q > (F)1 ? (F)1 : q);
  return (uint32_t)mul_rn(q, top);
}

// min(the number of staged boundaries <= key, nb): sb holds the nb
// boundaries padded to `pow2` entries.
__device__ __forceinline__ int64_t part_id(const int64_t* sb, int pow2,
                                           int nb, int64_t key) {
  int pos = 0;
  for (int step = pow2 >> 1; step > 0; step >>= 1)
    pos += sb[pos + step - 1] <= key ? step : 0;
  pos += pow2 > 0 && sb[pos] <= key ? 1 : 0;
  return pos < nb ? pos : nb;
}

// A launch's operands.  ROUTE kernels write the key's partition id
// (part_id over `bounds`) instead of the key.
template <typename F>
struct Job {
  const F* vals;          // the table (lane (a): the values)
  int64_t row_stride;     // in elements
  Cols cols;              // the key columns' offsets in a row, in elements
  const F* lo;
  const F* hi;
  const int64_t* bounds;  // ROUTE: the nb sorted flipped boundaries,
  int nb, pow2;           // staged padded to pow2 entries
  int64_t* out;
  int64_t n;
  int m, bits, width;
  uint64_t flip;
};

template <typename F, bool ROUTE>
__device__ __forceinline__ void stage_bounds(const Job<F>& job,
                                             int64_t* sb) {
  if (ROUTE) {
    for (int t = threadIdx.x; t < job.pow2; t += kThreads)
      sb[t] = t < job.nb ? job.bounds[t] : INT64_MAX;
    __syncthreads();
  }
}

template <typename F, bool ROUTE>
__device__ __forceinline__ void store(const Job<F>& job, const int64_t* sb,
                                      int64_t i, uint64_t key) {
  const int64_t signed_key = (int64_t)(key ^ job.flip);
  const int64_t o = ROUTE ? part_id(sb, job.pow2, job.nb, signed_key)
                          : signed_key;
  __stcs((long long*)(job.out + i), (long long)o);
}

template <typename F>
__device__ __forceinline__ F top_code(int bits) {
  return (F)((1u << bits) - 1u);
}

template <typename F>
__device__ __forceinline__ F span_of(F lo, F hi) {
  const F span = sub_rn(hi, lo);
  return span < (F)1e-12 ? (F)1e-12 : span;
}

// M > 0: m is M (<= 4) at compile time, R rows a thread a step, rows
// kThreads apart; M == 0: m is job.m (<= kMaxCols), one row a thread.
template <typename F, int M, int R, bool ROUTE>
__global__ void __launch_bounds__(kThreads) zorder_kernel(Job<F> job) {
  extern __shared__ int64_t sb[];
  stage_bounds<F, ROUTE>(job, sb);
  const F top = top_code<F>(job.bits);
  const int64_t n = job.n;
  if constexpr (M > 0) {
    F l[M], span[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      l[j] = job.lo[j];
      span[j] = span_of(l[j], job.hi[j]);
    }
    const int64_t step = (int64_t)gridDim.x * kThreads * R;
    for (int64_t base = (int64_t)blockIdx.x * kThreads * R; base < n;
         base += step) {
      F v[R][M];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t i = base + r * kThreads + threadIdx.x;
        const F* row = job.vals + (i < n ? i : n - 1) * job.row_stride;
#pragma unroll
        for (int j = 0; j < M; ++j) v[r][j] = load_key(row + job.cols.off[j]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uint64_t key = 0;
#pragma unroll
        for (int j = 0; j < M; ++j)
          key |= spread<M>(quantize(v[r][j], l[j], span[j], top)) << j;
        const int64_t i = base + r * kThreads + threadIdx.x;
        if (i < n) store<F, ROUTE>(job, sb, i, key);
      }
    }
  } else {
    const int m = job.m;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
      const F* row = job.vals + i * job.row_stride;
      uint64_t key = 0;
      for (int j = 0; j < m; ++j) {
        const F l = job.lo[j];
        const uint64_t code = quantize(load_key(row + job.cols.off[j]), l,
                                       span_of(l, job.hi[j]), top);
#pragma unroll
        for (int b = 0; b < kMaxBits; ++b) {
          if (b >= job.bits) break;
          const int pos = b * m + j;
          if (pos < job.width) key |= ((code >> b) & 1ull) << pos;
        }
      }
      store<F, ROUTE>(job, sb, i, key);
    }
  }
}

// A warp tile over a row-major float64 table whose rows start on 64-byte
// boundaries: NP 64-byte sector pairs of a row hold the key columns, pair q
// at index (pairs >> 5q) & 31 of the row.  A warp takes 32 rows a step; its
// lanes load every 16-byte chunk of those pairs with coalesced loads (with
// K = 4 * NP chunks a row, chunk c of row r is load (r * K + c) / 32 of
// lane (r * K + c) % 32), put the key values in shared memory, and lane r
// keys row r.  Each lane's plan is the same every step, packed into one
// int a load: the chunk's offset in the row, its row in the step, and its
// two elements' key columns plus one (0: none).
template <int M, int NP, bool ROUTE>
__global__ void __launch_bounds__(kThreads)
zorder_tile_kernel(Job<double> job, int pairs) {
  constexpr int K = 4 * NP;
  extern __shared__ int64_t sb[];
  __shared__ double staged[kThreads / 32][32][M];
  stage_bounds<double, ROUTE>(job, sb);
  const double top = top_code<double>(job.bits);
  double l[M], span[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    l[j] = job.lo[j];
    span[j] = span_of(l[j], job.hi[j]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int plan[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int f = t * 32 + lane, r = f / K, c = f % K;
    const int off = (pairs >> 5 * (c / 4) & 31) * 8 + 2 * (c % 4);
    int jx = 0, jy = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (job.cols.off[j] == off) jx = j + 1;
      if (job.cols.off[j] == off + 1) jy = j + 1;
    }
    plan[t] = off | r << 8 | jx << 16 | jy << 20;
  }
  const int64_t n = job.n;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads + warp * 32; base < n;
       base += step) {
    double2 v[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int64_t i = base + (plan[t] >> 8 & 255);
      v[t] = load_chunk(job.vals + (i < n ? i : n - 1) * job.row_stride +
                        (plan[t] & 255));
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int r = plan[t] >> 8 & 255, jx = plan[t] >> 16 & 15,
                jy = plan[t] >> 20 & 15;
      if (jx) staged[warp][r][jx - 1] = v[t].x;
      if (jy) staged[warp][r][jy - 1] = v[t].y;
    }
    __syncwarp();
    uint64_t key = 0;
#pragma unroll
    for (int j = 0; j < M; ++j)
      key |= spread<M>(quantize(staged[warp][lane][j], l[j], span[j], top))
             << j;
    if (base + lane < n) store<double, ROUTE>(job, sb, base + lane, key);
    __syncwarp();
  }
}

// One block for every kThreads * R rows (the grid-stride loop takes what
// lies past kMaxBlocks).
template <typename F, int M, int R, bool ROUTE>
void launch_rows(const Job<F>& job, cudaStream_t stream) {
  const int64_t tile = (int64_t)kThreads * R;
  const int64_t need = (job.n + tile - 1) / tile;
  const unsigned grid = (unsigned)(need < kMaxBlocks ? need : kMaxBlocks);
  const size_t smem = ROUTE ? (size_t)job.pow2 * sizeof(int64_t) : 0;
  zorder_kernel<F, M, R, ROUTE><<<grid, kThreads, smem, stream>>>(job);
}

template <int M, int NP, bool ROUTE>
void launch_tile(const Job<double>& job, int pairs, cudaStream_t stream) {
  const int64_t need = (job.n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(need < kMaxBlocks ? need : kMaxBlocks);
  const size_t smem = ROUTE ? (size_t)job.pow2 * sizeof(int64_t) : 0;
  zorder_tile_kernel<M, NP, ROUTE><<<grid, kThreads, smem, stream>>>(job,
                                                                     pairs);
}

template <typename F, int M, bool ROUTE>
void launch_path(int path, const Job<F>& job, int pairs, int npairs,
                 cudaStream_t stream) {
  if constexpr (M > 0) {
    if (path == kPathRows) {
      launch_rows<F, M, kRows, ROUTE>(job, stream);
      return;
    }
    if constexpr (sizeof(F) == 8) {
      if (path == kPathTile) {
        if (npairs == 1) launch_tile<M, 1, ROUTE>(job, pairs, stream);
        if constexpr (M >= 2)
          if (npairs == 2) launch_tile<M, 2, ROUTE>(job, pairs, stream);
        if constexpr (M >= 3)
          if (npairs == 3) launch_tile<M, 3, ROUTE>(job, pairs, stream);
        if constexpr (M >= 4)
          if (npairs == 4) launch_tile<M, 4, ROUTE>(job, pairs, stream);
        return;
      }
    }
  }
  launch_rows<F, M, 1, ROUTE>(job, stream);
}

// The warp tile's pairs (packed as zorder_tile_kernel takes them) and
// their count for m key columns at element offsets `cols` of a float64 row;
// false where the tile cannot read the table (a column stride other than
// 1, rows not on 64-byte boundaries, a repeated column, m > 4, a column
// past the row's first 32 pairs).
bool tile_plan(const double* table, int64_t row_stride, int64_t col_stride,
               const int64_t* cols, int m, int* pairs, int* npairs) {
  if (m > 4 || col_stride != 1 || row_stride % 8 != 0 ||
      (uintptr_t)table % 64 != 0)
    return false;
  unsigned mask = 0;
  for (int j = 0; j < m; ++j) {
    for (int i = 0; i < j; ++i)
      if (cols[i] == cols[j]) return false;
    if (cols[j] / 8 >= 32) return false;
    mask |= 1u << (cols[j] / 8);
  }
  *pairs = *npairs = 0;
  for (int p = 0; p < 32; ++p)
    if (mask >> p & 1) *pairs |= p << 5 * (*npairs)++;
  return true;
}

// path kPathAuto chooses from the operands: the warp tile where it can read
// the table and the key columns span two or more sector pairs, kRows rows
// a thread where consecutive rows are consecutive elements (row stride 1,
// a column-major table), one row a thread otherwise.
template <typename F, bool ROUTE>
int launch(int path, Job<F> job, int64_t col_stride, const int64_t* cols,
           cudaStream_t stream) {
  int pairs = 0, npairs = 0;
  bool tileable = false;
  if constexpr (sizeof(F) == 8)
    tileable = tile_plan(job.vals, job.row_stride, col_stride, cols, job.m,
                         &pairs, &npairs);
  if (path == kPathAuto)
    path = tileable && npairs >= 2 ? kPathTile
           : job.row_stride == 1   ? kPathRows
                                   : kPathRow;
  if (path != kPathRow && path != kPathRows && path != kPathTile)
    return (int)cudaErrorInvalidValue;
  if (path == kPathTile && !tileable) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < kMaxCols; ++j)
    job.cols.off[j] = j < job.m ? cols[j] * col_stride : 0;
  job.pow2 = 0;
  if (ROUTE && job.nb > 0)
    for (job.pow2 = 1; job.pow2 < job.nb; job.pow2 <<= 1) {
    }
  switch (job.m) {
    case 1: launch_path<F, 1, ROUTE>(path, job, pairs, npairs, stream); break;
    case 2: launch_path<F, 2, ROUTE>(path, job, pairs, npairs, stream); break;
    case 3: launch_path<F, 3, ROUTE>(path, job, pairs, npairs, stream); break;
    case 4: launch_path<F, 4, ROUTE>(path, job, pairs, npairs, stream); break;
    default: launch_path<F, 0, ROUTE>(path, job, pairs, npairs, stream);
  }
  return (int)cudaGetLastError();
}

template <typename F>
Job<F> make_job(const F* vals, int64_t row_stride, const F* lo, const F* hi,
                const int64_t* bounds, int nb, int64_t* out, int64_t n,
                int m, int bits, int width, uint64_t flip) {
  Job<F> job{};
  job.vals = vals;
  job.row_stride = row_stride;
  job.lo = lo;
  job.hi = hi;
  job.bounds = bounds;
  job.nb = nb;
  job.out = out;
  job.n = n;
  job.m = m;
  job.bits = bits;
  job.width = width;
  job.flip = flip;
  return job;
}

}  // namespace

// The most columns one key interleaves.
extern "C" int zorder_max_columns(void) { return kMaxCols; }

// The most partitions zorder_route64 routes to (k - 1 boundaries).
extern "C" int zorder_max_parts(void) { return kMaxBoundaries + 1; }

// Lane (a).  `vals` is (n, m) contiguous float32, `lo`/`hi` are (m,) float32
// on the device, `out` is (n,) int64.  n >= 1, 1 <= m, 1 <= bits <= 16,
// m * bits <= 32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int zorder_keys32(const float* vals, const float* lo,
                             const float* hi, int64_t* out, int64_t n, int m,
                             int bits, void* stream) {
  int64_t cols[kMaxCols];
  for (int j = 0; j < kMaxCols; ++j) cols[j] = j;
  return launch<float, false>(
      kPathAuto, make_job(vals, m, lo, hi, nullptr, 0, out, n, m, bits, 32,
                          0ull),
      1, cols, (cudaStream_t)stream);
}

// Lane (b).  `table` is (n, C) float64 with positive strides `row_stride`
// and `col_stride` (in elements); `cols` (host, m entries) are its columns
// to key; `lo`/`hi` are (m,) float64 on the device, `out` is (n,) int64
// receiving the keys with bit 63 flipped.  n >= 1,
// 1 <= m <= zorder_max_columns().  `path` is how threads take rows:
// 0 chooses from the operands (the wrappers pass 0), 1 (one row a thread),
// 2 (four) and 3 (a warp tile) force one, for measurement; a path that
// cannot take the operands returns cudaErrorInvalidValue.
extern "C" int zorder_keys64(const double* table, int64_t row_stride,
                             int64_t col_stride, const int64_t* cols,
                             const double* lo, const double* hi,
                             int64_t* out, int64_t n, int m, int path,
                             void* stream) {
  return launch<double, false>(
      path, make_job(table, row_stride, lo, hi, nullptr, 0, out, n, m,
                     kMaxBits, 64, 1ull << 63),
      col_stride, cols, (cudaStream_t)stream);
}

// Lane (b) routed.  As zorder_keys64, plus `boundaries`, the k - 1 sorted
// flipped int64 key boundaries on the device; `out` receives the int64
// partition ids.  1 <= k <= zorder_max_parts(), else cudaErrorInvalidValue.
extern "C" int zorder_route64(const double* table, int64_t row_stride,
                              int64_t col_stride, const int64_t* cols,
                              const double* lo, const double* hi,
                              const int64_t* boundaries, int64_t k,
                              int64_t* out, int64_t n, int m, int path,
                              void* stream) {
  if (k < 1 || k > kMaxBoundaries + 1) return (int)cudaErrorInvalidValue;
  return launch<double, true>(
      path, make_job(table, row_stride, lo, hi, boundaries, (int)(k - 1),
                     out, n, m, kMaxBits, 64, 1ull << 63),
      col_stride, cols, (cudaStream_t)stream);
}
