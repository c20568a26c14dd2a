// Partition-pruning scan matrix for Hopper (sm_90a), float64.
//
// out[q, p] = AND over c of (p_min[p, c] <= q_hi[q, c] && p_max[p, c] >= q_lo[q, c])
//
// Replaces the TPU kernel src/repro/kernels/pruning/pruning.py:30-99
// (_kernel / _scan_matrix_call behind scan_matrix_pallas).  That kernel casts
// every bound to float32, so its caller guards it and falls back to numpy
// whenever a bound is not float32-exact; this one compares in float64, is
// exact on every input (+-inf included; a NaN bound fails its compare, as in
// numpy) and needs no guard.  C = 0 scans every partition.  Both operands
// take a row stride over dense columns, so the StateMatrix plane's
// (n * P_cap, C) view and a block of rows sliced from a run's stacked query
// bounds are read in place.
//
// Bound: at the decision loop's block shape (Q = 256 queries, P = 9 * 32,
// C = 32) it reads (2QC + 2PC) * 8 bytes and writes QP bytes, about 0.35 MB
// (0.1 us at 3.35 TB/s), and does 3 float64 operations per (q, p, c), 7.1 M
// (0.2 us at 34 TFLOP/s): operations.  No launch gets near it: the work is
// smaller than a launch, so the design's job is one launch per block of
// queries (the caller's) and a body within a few empty launches.
//
// Two tiles, chosen from the operands (`path`; 0 = this choice, 1 and 2
// force one, for measurement; both take every shape):
//   1 (row): while Q times the row tile's blocks per query (ceil(P / 64))
//     is at most kRowMaxBlocks (a per-query estimate, serve, admission's
//     cost vectors, the fleet's fallback), each block takes one query row
//     (blockIdx.y) and each warp
//     kRowParts partitions, its lanes across the columns: lane c loads
//     column c of the query and of each of the warp's partition rows
//     (read-only loads, one coalesced 256-byte run of a row per warp load,
//     all 2 * kRowParts loads in flight before any compare), and a warp
//     vote ANDs the columns.  No shared memory and no barrier; the
//     earlier design's 32-partition x 8-query blocks left 7 of 8 thread
//     rows idle at Q = 1.
//   2 (tile): for larger scans (the decision loop's block estimates, Q of
//     256 over n * P_cap rows; serve blocks), a block owns kTileP = 32
//     partitions (the lanes) and walks the queries
//     kTileQ at a time, each warp kQ of them.  The partition tile's zone
//     maps are staged in shared memory once per block when C <= kChunk
//     (else once per column chunk), rows padded by one element so a lane's
//     column reads do not collide on a bank; each query tile's bounds are
//     staged beside them and read as warp-wide broadcasts.  A thread issues
//     every load of a chunk's staging before its first store to shared
//     memory (one round trip a chunk; a load-store loop waited for one per
//     element).  A thread loads its partition's bounds of a column once
//     for its kQ queries (the column loop unrolled by 8, so the shared
//     loads of eight columns are in flight together), keeps their flags in
//     registers across the column chunks and stores them as kQ coalesced
//     32-byte rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPathAuto = 0, kPathRow = 1, kPathTile = 2;
// Path 0 takes the row tile while Q times its blocks per query is at most
// this, else the tile.
constexpr int64_t kRowMaxBlocks = 512;

constexpr int kRowWarps = 8;       // row tile: warps per block
constexpr int kRowParts = 8;       // row tile: partitions per warp

constexpr int kWarps = 8;
constexpr int kTileThreads = kWarps * 32;
constexpr int kTileP = 32;         // tile: partitions per block, one per lane
constexpr int kQ = 4;              // tile: queries per warp
constexpr int kTileQ = kWarps * kQ;
constexpr int kChunk = 32;         // tile: columns staged at a time
constexpr int kLdP = kChunk + 1;   // padded partition row in shared memory
// Loads a thread issues to stage a chunk of the partition and query tiles.
constexpr int kPartLoads = kTileP * kChunk / kTileThreads;
constexpr int kQueryLoads = kTileQ * kChunk / kTileThreads;
static_assert(kPartLoads * kTileThreads == kTileP * kChunk, "tile shape");
static_assert(kQueryLoads * kTileThreads == kTileQ * kChunk, "tile shape");

constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kRowWarps * 32)
scan_rows_kernel(const double* __restrict__ q_lo,
                 const double* __restrict__ q_hi, int64_t q_stride,
                 const double* __restrict__ p_min,
                 const double* __restrict__ p_max, int64_t p_stride,
                 uint8_t* __restrict__ out, int Q, int P, int C) {
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * kRowParts;
  if (p0 >= P) return;  // whole warps leave; the kernel has no barrier
  for (int64_t q = blockIdx.y; q < Q; q += gridDim.y) {
    const double* lo_row = q_lo + q * q_stride;
    const double* hi_row = q_hi + q * q_stride;
    unsigned keep = (1u << kRowParts) - 1;  // bit j: partition p0 + j
    for (int c0 = 0; c0 < C; c0 += 32) {
      // Lane c takes column c0 + c of the query and of kRowParts partition
      // rows: every warp load is one coalesced run of a row.  A lane past
      // C passes; a row past P loads nothing and is never stored.
      const int c = c0 + lane;
      const bool col = c < C;
      const double lo = col ? __ldg(lo_row + c) : -INFINITY;
      const double hi = col ? __ldg(hi_row + c) : INFINITY;
      double mn[kRowParts], mx[kRowParts];
#pragma unroll
      for (int j = 0; j < kRowParts; ++j) {
        const bool in = col && p0 + j < P;
        const int64_t off = (int64_t)(p0 + j) * p_stride + c;
        mn[j] = in ? __ldg(p_min + off) : -INFINITY;
        mx[j] = in ? __ldg(p_max + off) : INFINITY;
      }
#pragma unroll
      for (int j = 0; j < kRowParts; ++j) {
        const bool pass = col ? (mn[j] <= hi) & (mx[j] >= lo) : true;
        if (!__all_sync(0xffffffffu, pass)) keep &= ~(1u << j);
      }
    }
    if (lane < kRowParts && p0 + lane < P)
      out[q * P + p0 + lane] = (keep >> lane) & 1u;
  }
}

__global__ void __launch_bounds__(kTileThreads)
scan_tile_kernel(const double* __restrict__ q_lo,
                 const double* __restrict__ q_hi, int64_t q_stride,
                 const double* __restrict__ p_min,
                 const double* __restrict__ p_max, int64_t p_stride,
                 uint8_t* __restrict__ out, int Q, int P, int C) {
  __shared__ double s_min[kTileP * kLdP];
  __shared__ double s_max[kTileP * kLdP];
  __shared__ double s_lo[kTileQ * kChunk];
  __shared__ double s_hi[kTileQ * kChunk];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * kTileP;
  const int p = p0 + lane;
  const int prows = min(kTileP, P - p0);
  // With C <= kChunk the partition tile is staged with the block's first
  // query tile and stays for the others.
  const bool resident = C <= kChunk;
  for (int64_t q0 = (int64_t)blockIdx.y * kTileQ; q0 < Q;
       q0 += (int64_t)gridDim.y * kTileQ) {
    const int64_t left = Q - q0;
    const int qrows = left < kTileQ ? (int)left : kTileQ;
    const bool parts = !resident || q0 == (int64_t)blockIdx.y * kTileQ;
    bool keep[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) keep[k] = true;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int cw = min(kChunk, C - c0);
      // Staging: every load of the chunk is issued before any store to
      // shared memory, so the block waits for one round trip, not one per
      // element a thread copies.
      double pa[kPartLoads], pb[kPartLoads], qa[kQueryLoads], qb[kQueryLoads];
      if (parts) {
#pragma unroll
        for (int i = 0; i < kPartLoads; ++i) {
          const int e = tid + i * kTileThreads, r = e / cw;
          if (r < prows) {
            const int64_t off = (int64_t)(p0 + r) * p_stride + c0 + e - r * cw;
            pa[i] = __ldg(p_min + off);
            pb[i] = __ldg(p_max + off);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kQueryLoads; ++i) {
        const int e = tid + i * kTileThreads, r = e / cw;
        if (r < qrows) {
          const int64_t off = (q0 + r) * q_stride + c0 + e - r * cw;
          qa[i] = __ldg(q_lo + off);
          qb[i] = __ldg(q_hi + off);
        }
      }
      if (parts) {
#pragma unroll
        for (int i = 0; i < kPartLoads; ++i) {
          const int e = tid + i * kTileThreads, r = e / cw;
          if (r < prows) {
            s_min[r * kLdP + e - r * cw] = pa[i];
            s_max[r * kLdP + e - r * cw] = pb[i];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kQueryLoads; ++i) {
        const int e = tid + i * kTileThreads, r = e / cw;
        if (r < qrows) {
          s_lo[r * kChunk + e - r * cw] = qa[i];
          s_hi[r * kChunk + e - r * cw] = qb[i];
        }
      }
      __syncthreads();
      if (lane < prows) {
        const double* lo = s_lo + warp * kQ * kChunk;
        const double* hi = s_hi + warp * kQ * kChunk;
#pragma unroll 8
        for (int c = 0; c < cw; ++c) {
          const double mn = s_min[lane * kLdP + c];
          const double mx = s_max[lane * kLdP + c];
#pragma unroll
          for (int k = 0; k < kQ; ++k)
            keep[k] = keep[k] & (mn <= hi[k * kChunk + c])
                              & (mx >= lo[k * kChunk + c]);
        }
      }
      __syncthreads();
    }
    if (lane < prows) {
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const int r = warp * kQ + k;
        if (r < qrows) out[(q0 + r) * P + p] = keep[k] ? 1 : 0;
      }
    }
  }
}

}  // namespace

// The tile that path 0 chooses for these operands (1 or 2).
extern "C" int pruning_choose_path(int Q, int P, int C) {
  (void)C;
  constexpr int per_block = kRowWarps * kRowParts;
  const int64_t blocks = (int64_t)Q * ((P + per_block - 1) / per_block);
  return blocks <= kRowMaxBlocks ? kPathRow : kPathTile;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue, launching nothing, for a path other than 0, 1, 2.
// Q and P must be positive; the caller allocates `out` as (Q, P) bytes.
extern "C" int pruning_scan_matrix(const double* q_lo, const double* q_hi,
                                   int64_t q_stride, const double* p_min,
                                   const double* p_max, int64_t p_stride,
                                   uint8_t* out, int Q, int P, int C,
                                   int path, void* stream) {
  if (path == kPathAuto) path = pruning_choose_path(Q, P, C);
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == kPathRow) {
    constexpr int per_block = kRowWarps * kRowParts;
    const dim3 grid((unsigned)((P + per_block - 1) / per_block),
                    (unsigned)(Q < kMaxGridY ? Q : kMaxGridY));
    scan_rows_kernel<<<grid, kRowWarps * 32, 0, s>>>(
        q_lo, q_hi, q_stride, p_min, p_max, p_stride, out, Q, P, C);
  } else if (path == kPathTile) {
    const int64_t q_tiles = ((int64_t)Q + kTileQ - 1) / kTileQ;
    const dim3 grid((unsigned)((P + kTileP - 1) / kTileP),
                    (unsigned)(q_tiles < kMaxGridY ? q_tiles : kMaxGridY));
    scan_tile_kernel<<<grid, kTileThreads, 0, s>>>(
        q_lo, q_hi, q_stride, p_min, p_max, p_stride, out, Q, P, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
