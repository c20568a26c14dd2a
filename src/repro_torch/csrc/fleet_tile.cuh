// One shared-memory tile per tenant: the fleet plane's overlap test for
// Hopper (sm_90a), float64.  Included by decision_fused.cu and
// fleet_scan.cu, whose kernels are this tile with different outputs.
//
// For rows of per-tenant bounds (B frames of a (B, T, C) tensor) and the
// packed (T, S, P, C) plane of zone maps, N = S * P slots a tenant:
//   scan[b, t, n] = AND over c of (min[t, n, c] <= hi[b, t, c] &&
//                                  max[t, n, c] >= lo[b, t, c])
//   cost[b, t, s] = (sum over p of scan[b, t, s, p] * rows[t, s, p])
//                   * inv_totals[t, s]
//   freq[t, n]    = (number of window rows w overlapping slot n) / W
// Each output is optional.  The compares are float64 and exact on every
// input: +-inf, the padding slots [+inf, -inf], the dummy queries
// [-inf, +inf]; a NaN bound fails its compare, as in numpy.  C = 0 scans
// every slot.
//
// Layout of the work.  A block takes one tenant's slots, or a chunk of
// them (whole states when `cost` is asked, so a state's sum stays in one
// block) when the grid would otherwise be smaller than two blocks an SM.
// It stages the chunk's zone maps in shared memory, column-major, at most
// one tile of slots at a time, and beside them the frames' rows of that
// tenant (or the window's rows, for `freq`), a chunk of rows at a time.
// Every copy of a stage is an 8-byte cp.async, issued before the one
// barrier that ends the stage: the block waits for one round trip, not one
// per copy, and neighbouring threads copy neighbouring doubles of the plane
// (one coalesced run when the plane is dense).
//
// A thread takes K consecutive slots of one row (a frame or a window row)
// and ANDs every column with no early exit; a row bound it reads is a
// broadcast.  The tile holds the k-th slots of the K-slot groups in one
// run (slot j, column c at [c][j % K][j / K]), so the lanes of a warp read
// consecutive doubles: no bank conflict.  K = 4 (four or more rows) reads
// each row bound once for four slots and writes the four scan bytes as one
// 32-bit store; K = 1 (fewer than four rows, the fleet scan's one frame)
// keeps four times the lanes busy, and a ballot hands
// each quad's four flags to its first lane for the same 32-bit store.  The
// store is one word where the row's offset is a multiple of 4, bytes at
// the edges.  `cost` stages the flags in shared memory and a thread per
// (frame, state) sums them over P in slot order, carrying a state across
// tiles in the same block: one fixed order, no float atomics, so two
// launches give the same bits.  `freq` splits the window's rows across the
// threads of a slot group and adds the integer counts in shared memory
// (exact in any order), then writes count / W.
//
// The block count, the tile, K and the row chunk come from the operands
// (plan() below; `path` forces K for measurement); the block loops over
// its tiles, its row chunks and, grid-strided with 64-bit indices, over
// more (tenant, chunk) units than the grid holds, so T past 65,535 and any
// slot count are taken.  Every loop that holds a barrier or a ballot has a
// block-uniform trip count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fleet_tile {

constexpr int kMaxThreads = 512;
constexpr int kMaxTileSlots = 1024;        // slots a tile stages at most
constexpr int kMaxRows = 1024;             // rows a chunk stages at most
constexpr int64_t kMinSpan = 8;            // slots a block takes at least
constexpr size_t kTileBudget = 96 * 1024;  // zone-map bytes a tile aims at
constexpr size_t kRowBudget = 32 * 1024;   // row bytes a chunk aims at
constexpr size_t kSmemMax = 232448;        // a block's shared memory, sm_90
constexpr int64_t kMaxBlocks = 1 << 20;

// The kernel's operands and its plan, passed by value.
struct Args {
  const double* q_lo;          // frames: row (b, t) at (b * T + t) * C
  const double* q_hi;
  const double* p_min;         // plane: dense columns, these strides
  const double* p_max;
  int64_t t_stride, s_stride, p_stride;
  const double* rows;          // (T, S, P), read when cost is asked
  const double* inv_totals;    // (T, S)
  const double* w_lo;          // window (W, C), read when freq is asked
  const double* w_hi;
  uint8_t* scan;               // (B, T, N) bytes or null
  double* cost;                // (B, T, S) or null
  double* freq;                // (T, N) or null
  int64_t T, S, P, N;
  int C, B, W;
  int dense;                   // p_stride == C and s_stride == P * C
  // The plan: (tenant, chunk) units of `span` slots, tiles of at most
  // `tile` slots (a multiple of 4), row chunks of at most `chunk` rows.
  int64_t chunks, span;
  int tile, chunk;
};

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t round4(int64_t a) { return (a + 3) & ~int64_t{3}; }
inline int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Shared memory of a block: the tile's bounds, the chunk's row bounds,
// the tile's freq counts and the chunk's cost flags.
inline size_t smem_bytes(int tile, int chunk, int C, bool cost, bool freq) {
  return 16 * (size_t)C * ((size_t)tile + chunk) +
         (freq ? 4 * (size_t)tile : 0) +
         (cost ? (size_t)chunk * tile : 0);
}

// The widest rows a block takes: a tile of 4 slots and a chunk of 1 row,
// with counts and flags, must fit in shared memory.
inline int max_columns() {
  return (int)((kSmemMax - smem_bytes(4, 1, 0, true, true)) / (16 * 5));
}

struct Plan {
  int64_t chunks, span;
  int slots, tile, chunk, threads;   // slots: K, slots a thread
  size_t smem;
};

// Paths: 0 lets the plan choose, 1 and 2 force one or four slots a
// thread (for measurement; both take every shape).
constexpr int kPathAuto = 0, kPathOne = 1, kPathFour = 2;

// `sms`: the card's multiprocessors; the plan aims at two blocks each.
inline Plan plan(int64_t T, int64_t S, int64_t P, int C, int B, int W,
                 bool frames, bool cost, bool freq, int sms, int path) {
  Plan pl;
  const int64_t N = S * P;
  const int64_t need = ceil_div(2 * (int64_t)(sms > 0 ? sms : 1), T);
  if (N == 0) {
    pl.span = 0;
    pl.chunks = 1;
  } else if (cost) {
    int64_t k = ceil_div(S, need);
    const int64_t k_min = ceil_div(kMinSpan, P);
    k = clamp64(k < k_min ? k_min : k, 1, S);
    pl.span = k * P;
    pl.chunks = ceil_div(S, k);
  } else {
    int64_t span = round4(ceil_div(N, need));
    pl.span = clamp64(span, kMinSpan, round4(N));
    pl.chunks = ceil_div(N, pl.span);
  }
  const size_t per_slot = 16 * (size_t)C + (freq ? 4 : 0) + 1;
  int64_t tile = (int64_t)(kTileBudget / per_slot) & ~int64_t{3};
  tile = clamp64(tile, 4, kMaxTileSlots);
  pl.tile = (int)clamp64(tile, 4, pl.span > 4 ? round4(pl.span) : 4);
  const int64_t f_rows = frames ? B : 0, w_rows = freq ? W : 0;
  const int64_t rows = f_rows > w_rows ? f_rows : w_rows;
  // Four slots a thread share each row bound they read; with fewer than
  // four rows a thread would have too little work, and one slot a thread
  // keeps the lanes busy.
  pl.slots = path == kPathOne ? 1
             : path == kPathFour ? 4 : (rows >= 4 ? 4 : 1);
  const size_t per_row = 16 * (size_t)C + (cost ? pl.tile : 0) + 1;
  pl.chunk = (int)clamp64((int64_t)(kRowBudget / per_row), 1,
                          clamp64(rows, 1, kMaxRows));
  const int64_t groups = ceil_div(pl.tile, pl.slots);
  const int64_t f_items = groups * (f_rows < pl.chunk ? f_rows : pl.chunk);
  const int64_t w_items = groups * (w_rows < pl.chunk ? w_rows : pl.chunk);
  const int64_t copies = ceil_div(2 * (int64_t)C * (pl.tile + pl.chunk), 8);
  int64_t threads = f_items > w_items ? f_items : w_items;
  threads = threads > copies ? threads : copies;
  pl.threads = (int)clamp64((threads + 31) & ~int64_t{31}, 32, kMaxThreads);
  pl.smem = smem_bytes(pl.tile, pl.chunk, C, cost, freq);
  return pl;
}

inline void apply(Args& a, const Plan& pl) {
  a.chunks = pl.chunks;
  a.span = pl.span;
  a.tile = pl.tile;
  a.chunk = pl.chunk;
}

inline unsigned grid_size(const Args& a) {
  const int64_t units = a.T * a.chunks;
  return (unsigned)(units < kMaxBlocks ? units : kMaxBlocks);
}

__device__ __forceinline__ void copy8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n / d for non-negative operands, in 32 bits when both fit.
__device__ __forceinline__ int64_t div64(int64_t n, int64_t d) {
  return (n | d) <= 0xffffffffLL ? (int64_t)((uint32_t)n / (uint32_t)d)
                                 : n / d;
}

// Copies the zone maps of slots [n0, n0 + nw) of tenant t into the tile:
// slot j of column c at tile[c * K * nq + (j % K) * nq + j / K], so the
// k-th slots of the nq groups of K lie in one run.  A thread steps through
// its elements (j, c) without a division per element.
template <int K>
__device__ __forceinline__ void stage_tile(const Args& a, int64_t t,
                                           int64_t n0, int nw, int nq,
                                           double* s_min, double* s_max) {
  const int C = a.C, nt = blockDim.x;
  if (C == 0) return;
  const double* bmin = a.p_min + t * a.t_stride;
  const double* bmax = a.p_max + t * a.t_stride;
  const int dj = nt / C, dc = nt - dj * C;
  int j = threadIdx.x / C, c = threadIdx.x - j * C;
  for (int e = threadIdx.x; e < nw * C; e += nt) {
    int64_t off;
    if (a.dense) {
      off = n0 * C + e;
    } else {
      const int64_t n = n0 + j, s = div64(n, a.P);
      off = s * a.s_stride + (n - s * a.P) * a.p_stride + c;
    }
    const int d = c * K * nq + (j % K) * nq + j / K;
    copy8(s_min + d, bmin + off);
    copy8(s_max + d, bmax + off);
    c += dc;
    j += dj;
    if (c >= C) {
      c -= C;
      ++j;
    }
  }
}

// Copies `rows` rows of C bounds, `stride` apart, into s_lo / s_hi.
__device__ __forceinline__ void stage_rows(const double* lo, const double* hi,
                                           int64_t stride, int rows, int C,
                                           double* s_lo, double* s_hi) {
  const int nt = blockDim.x;
  if (C == 0) return;
  const int dr = nt / C, dc = nt - dr * C;
  int r = threadIdx.x / C, c = threadIdx.x - r * C;
  for (int e = threadIdx.x; e < rows * C; e += nt) {
    copy8(s_lo + e, lo + r * stride + c);
    copy8(s_hi + e, hi + r * stride + c);
    c += dc;
    r += dr;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
}

// Bit k: slot K * i + k of the tile overlaps the row [lo, hi] in every
// column.  Slots past the tile's end compute noise no caller stores.
template <int K>
__device__ __forceinline__ unsigned group_overlap(const double* s_min,
                                                  const double* s_max, int nq,
                                                  int i, const double* lo,
                                                  const double* hi, int C) {
  bool keep[K];
#pragma unroll
  for (int k = 0; k < K; ++k) keep[k] = true;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const double l = lo[c], h = hi[c];
    double mn[K], mx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mn[k] = s_min[(c * K + k) * nq + i];
      mx[k] = s_max[(c * K + k) * nq + i];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) keep[k] = keep[k] & (mn[k] <= h && mx[k] >= l);
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) m |= (unsigned)keep[k] << k;
  return m;
}

// Four flags as four bytes of one little-endian word.
__device__ __forceinline__ uint32_t quad_bytes(unsigned m) {
  return (m & 1u) | (m & 2u) << 7 | (m & 4u) << 14 | (m & 8u) << 21;
}

// The flags of slots j .. j + valid - 1 (bits of m) at out: one 32-bit
// store for a whole, aligned quad, else byte stores.
__device__ __forceinline__ void store_quad(uint8_t* out, unsigned m,
                                           int valid) {
  if (valid == 4 && ((uintptr_t)out & 3) == 0) {
    *reinterpret_cast<uint32_t*>(out) = quad_bytes(m);
  } else {
    for (int k = 0; k < valid; ++k) out[k] = (m >> k) & 1u;
  }
}

// A (frame, state) cost of the tile: its flags times the state's row
// counts, summed over the state's slots in the tile in slot order, added
// to the sum of the state's earlier tiles (same block), scaled by the
// inverse total at the state's last slot.
__device__ __forceinline__ void cost_item(const Args& a, int64_t t,
                                          int64_t n0, int nw, int64_t b,
                                          int64_t s, const uint8_t* flags) {
  const int64_t first = s * a.P, end = first + a.P;
  const int64_t lo = first > n0 ? first : n0;
  const int64_t hi = end < n0 + nw ? end : n0 + nw;
  const double* rows = a.rows + t * a.N;
  double sum = 0.0;
  for (int64_t n = lo; n < hi; ++n) sum += (double)flags[n - n0] * rows[n];
  double* out = a.cost + (b * a.T + t) * a.S + s;
  double v = lo == first ? sum : *out + sum;
  if (hi == end) v *= a.inv_totals[t * a.S + s];
  *out = v;
}

// The kernel body; K slots a thread (1 or 4, see the top of this file).
template <int K>
__device__ __forceinline__ void tile_body(const Args& a) {
  extern __shared__ double smem[];
  const int C = a.C;
  double* s_min = smem;                                  // [C][tile]
  double* s_max = s_min + (size_t)C * a.tile;            // [C][tile]
  double* s_lo = s_max + (size_t)C * a.tile;             // [chunk][C]
  double* s_hi = s_lo + (size_t)a.chunk * C;             // [chunk][C]
  int* s_count = reinterpret_cast<int*>(s_hi + (size_t)a.chunk * C);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(
      s_count + (a.freq != nullptr ? a.tile : 0));       // [chunk][width]
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool frames = a.B > 0 && (a.scan != nullptr || a.cost != nullptr);
  const int64_t units = a.T * a.chunks;
  bool reuse = false;                  // shared memory holds a stage
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t t = div64(u, a.chunks);
    if (a.N == 0) {                    // no slots: every cost is 0 * inv
      if (a.cost != nullptr) {
        for (int64_t e = tid; e < (int64_t)a.B * a.S; e += nt) {
          const int64_t b = e / a.S, s = e - b * a.S;
          a.cost[(b * a.T + t) * a.S + s] = 0.0 * a.inv_totals[t * a.S + s];
        }
      }
      continue;
    }
    const int64_t first = (u - t * a.chunks) * a.span;
    const int64_t last = first + a.span < a.N ? first + a.span : a.N;
    for (int64_t n0 = first; n0 < last; n0 += a.tile) {
      const int nw = (int)(last - n0 < a.tile ? last - n0 : a.tile);
      const int nq = (nw + K - 1) / K;          // groups of K slots
      // A row of items: nq groups, with K = 1 padded to whole quads so
      // that lanes 4k .. 4k + 3 share a row.
      const int width = K == 1 ? (nq + 3) & ~3 : nq;
      bool staged = false;
      for (int b0 = 0; frames && b0 < a.B; b0 += a.chunk) {
        const int rows = a.B - b0 < a.chunk ? a.B - b0 : a.chunk;
        if (reuse) __syncthreads();    // the last stage's readers are done
        reuse = true;
        if (!staged) stage_tile<K>(a, t, n0, nw, nq, s_min, s_max);
        staged = true;
        const int64_t row0 = ((int64_t)b0 * a.T + t) * C;
        stage_rows(a.q_lo + row0, a.q_hi + row0, a.T * C, rows, C, s_lo,
                   s_hi);
        copies_done();
        __syncthreads();
        const int items = rows * width;
        // With K = 1 every lane of a warp runs the ballot: the bound is
        // rounded up to whole warps.
        const int bound = K == 1 ? (items + 31) & ~31 : items;
        for (int e = tid; e < bound; e += nt) {
          const int r = e / width, i = e - r * width;
          const int j = K * i;                   // the item's first slot
          const bool live = e < items && j < nw;
          unsigned m = live ? group_overlap<K>(s_min, s_max, nq, i,
                                               s_lo + r * C, s_hi + r * C, C)
                            : 0u;
          if (K == 1) {
            m = (__ballot_sync(0xffffffffu, m != 0) >> (lane & ~3)) & 0xfu;
            if ((lane & 3) != 0) continue;
          }
          if (!live) continue;
          if (a.scan != nullptr) {
            store_quad(a.scan + ((b0 + r) * a.T + t) * a.N + n0 + j, m,
                       nw - j < 4 ? nw - j : 4);
          }
          if (a.cost != nullptr) {
            *reinterpret_cast<uint32_t*>(s_flag + r * K * width + j) =
                quad_bytes(m);
          }
        }
        if (a.cost != nullptr) {
          __syncthreads();
          const int64_t s0 = div64(n0, a.P);
          const int ns = (int)(div64(n0 + nw - 1, a.P) - s0 + 1);
          for (int e = tid; e < rows * ns; e += nt) {
            const int r = e / ns;
            cost_item(a, t, n0, nw, b0 + r, s0 + (e - r * ns),
                      s_flag + r * K * width);
          }
        }
      }
      if (a.freq == nullptr) continue;
      for (int w0 = 0; w0 < a.W; w0 += a.chunk) {
        const int rows = a.W - w0 < a.chunk ? a.W - w0 : a.chunk;
        if (reuse) __syncthreads();
        reuse = true;
        if (!staged) stage_tile<K>(a, t, n0, nw, nq, s_min, s_max);
        staged = true;
        if (w0 == 0) {
          for (int j = tid; j < nw; j += nt) s_count[j] = 0;
        }
        stage_rows(a.w_lo + (int64_t)w0 * C, a.w_hi + (int64_t)w0 * C, C,
                   rows, C, s_lo, s_hi);
        copies_done();
        __syncthreads();
        // Item (group g, slots K * i ..): group g counts rows g,
        // g + groups, ...
        const int groups = nt / nq > 1 ? nt / nq : 1;
        for (int e = tid; e < groups * nq; e += nt) {
          const int g = e / nq, i = e - g * nq;
          int n[K];
#pragma unroll
          for (int k = 0; k < K; ++k) n[k] = 0;
          for (int r = g; r < rows; r += groups) {
            const unsigned m = group_overlap<K>(s_min, s_max, nq, i,
                                                s_lo + r * C, s_hi + r * C, C);
#pragma unroll
            for (int k = 0; k < K; ++k) n[k] += (m >> k) & 1u;
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (K * i + k < nw && n[k]) atomicAdd(s_count + K * i + k, n[k]);
          }
        }
      }
      __syncthreads();
      for (int j = tid; j < nw; j += nt) {
        const int count = a.W > 0 ? s_count[j] : 0;
        a.freq[t * a.N + n0 + j] = (double)count / (double)a.W;
      }
    }
  }
}

// Launches `kernel1` or `kernel4` (K = 1 or 4 slots a thread) on the plan
// for `a` and returns cudaGetLastError() (0 on success).
template <class Kernel>
inline int launch(Args& a, const Plan& pl, Kernel kernel1, Kernel kernel4,
                  cudaStream_t stream) {
  apply(a, pl);
  const Kernel kernel = pl.slots == 4 ? kernel4 : kernel1;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid_size(a), pl.threads, pl.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The card's multiprocessor count, read once per device.
inline int multiprocessors() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
        cudaSuccess)
      counts[dev] = n;
  }
  return counts[dev];
}

}  // namespace fleet_tile
