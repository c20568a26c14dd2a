// Causal (+ prefix-LM) flash attention for Hopper (sm_90a): a scalar route
// for float32 and bfloat16 inputs, and a tensor-core route for bfloat16.
//
// out[b, t, h, :] = sum_s p[t, s] v[b, s, h / g, :] / sum_s p[t, s], over
// the keys s that query t (at position q_offset + t) may see:
//   s < kv_valid  and, if causal,  (s <= q_offset + t  or  s < prefix_len),
// with p = exp(q.k * dh^-1/2 - running max) accumulated by the online
// softmax; a row with no visible key gives 0 (the denominator is clamped at
// 1e-30, as src/repro/models/layers.py:170-186 guards it).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:27-121 (_kernel / flash_attention_pallas), and computes
// the function of the model layer src/repro/models/layers.py:122-192 that
// the reference's comment says should dispatch to it:
// - native GQA: query head h reads kv head h / g in place, where the
//   reference's ops wrapper repeats the kv heads (ops.py:26-28);
// - the (B, T, H, dh) layout read through strides, with no transposes, and
//   ragged T and S masked here, with no padding copies;
// - q_offset, a scalar kv_valid (clamped to [0, S] by the caller) and
//   prefix_len.
// The probabilities are rounded to the input type before P.V, as
// layers.py:177-178 does (the Pallas kernel keeps them in float32); the
// running denominator adds them unrounded.  The Pallas kernel's causal
// block skip (flash_attention.py:41) ignores prefix_len and is off by 0.82
// at prefix_len 96 with 64-row blocks; here a kv tile is skipped only if
// its first key is past the tile's last query AND at or past prefix_len,
// so the key loop ends at min(kv_valid, max(last query position + 1,
// prefix_len)).
//
// Bound: operations.  At qwen3-1.7b's prefill (B 4, T = S = 2048, 16 query
// heads over 8 kv heads, dh 128, causal, bf16) the work is 4 dh flops per
// visible (query, key) pair, 68.7 GFLOP, 0.0695 ms at the tensor cores'
// 989 TFLOP/s, against 100 MB of q, k, v and out, 0.03 ms at 3.35 TB/s.
//
// Route 0, scalar (float32, and bfloat16 the tensor cores cannot take):
// float32 FMAs, no tensor cores.  One block of 256 threads per (64-query
// tile, query head, batch row).  The q tile is staged once in shared
// memory as float32; each 64-key tile of K is staged, the 64 x 64 scores
// are computed with every thread owning a 4 x 4 register tile (rows ty +
// 16 i, keys tx + 16 j), the row max and sum are reduced across the 16
// lanes that share a row with xor shuffles, the rounded probabilities go to
// shared memory, and then the V tile replaces the K tile in the same buffer
// for P.V, each thread owning 4 rows x dh/16 output columns in registers.
// Rows are padded to dh + 1 floats so the 16 lanes that read 16 different
// keys hit 16 different banks.  Shared memory is 4 (2 * 64 (dh + 1) + 64 *
// 65) bytes: 82,688 at dh 128, 148,224 at dh 256.  It restages K and V per
// query head and runs at about 59x the bound at qwen3's prefill.
//
// Route 1, tensor cores (bfloat16, dh a multiple of 16 up to 256, 16-byte
// aligned bases, token, head and batch strides multiples of 8 elements):
// - Work: a kv head's units are its (64-row query tile, query head of the
//   GQA group) pairs, tile by tile.  A block takes NC consecutive units,
//   one per consumer warpgroup (NC = 3 up to dh 128, 2 above), so the
//   group's query heads on the same positions share one K/V stream: at
//   qwen3's g = 2 a K/V tile serves 192 query rows, where the scalar route
//   loads it for 64.  Every g takes the same mapping: for g > NC each block
//   gets its own NC heads of the group (g = 8 spreads a tile's heads over
//   three blocks, each with its own K/V stream), and units of adjacent
//   tiles in one block differ by at most one key tile, which the earlier
//   one skips.  Blocks
//   run (kv head, batch) fastest and from the last units (the longest
//   causal rows) to the first, so the short diagonal ones fill the tail;
//   at qwen3's prefill that is 32 x 22 = 704 blocks.
// - Loads: one thread of a producer warpgroup issues TMA loads of 64-key x
//   dh K and V tiles into a ring of up to 4 stages, each with its own full
//   barriers (K, V) and an empty barrier every consumer releases.  The
//   tensor maps are 4-D over (dh, token, head, batch) with the operands'
//   own strides (head-strided views need no copy), in SWIZZLE_128B boxes
//   of 64 columns x 64 rows (a row of DP, dh padded to a multiple of 64,
//   is DP / 64 boxes; TMA zero-fills columns past dh and tokens past T and
//   S).  They are encoded on the host per call by cuTensorMapEncodeTiled,
//   looked up at run time, so nothing links libcuda.  Q is loaded once per
//   warpgroup.
// - S = Q K^T: wgmma m64n64k16 bf16 -> f32, Q and K from shared memory,
//   both K-major (DP / 16 instructions per tile).
// - Online softmax in registers on the accumulator fragment (a thread
//   holds 2 rows x 16 keys; row max and sum across the 4 lanes of a quad,
//   as trees), with the scalar route's masking, -inf guards, corr and
//   1e-30 clamp; exp2 of scores scaled by dh^-1/2 log2(e).
// - O += P V: P from registers (the S fragment packed to bf16x2 is the
//   register A operand's layout), V from shared memory MN-major (transpose
//   bit set), m64n128k16 (and n64 for the last 64 columns of DP 64 or 192),
//   O in registers: DP / 2 floats a thread.
// - Overlap: named barriers pass a turn round the consumers, so one
//   warpgroup issues its wgmmas while the others do their softmax.  In its
//   turn a warpgroup issues S of tile i with P V of tile i - 1 (ptxas waits
//   for both before the softmax reads S, so the overlap is the other
//   warpgroups').  Each turn's wgmma groups are fixed, which lets the
//   compiler keep them in flight (with the groups chosen by branches,
//   ptxas serialized every wgmma).
// - Registers: setmaxnreg moves them from the producer to the consumers
//   (24 and 160 a thread with three consumers, 40 and 232 with two).  No
//   trap in the barrier waits: a trap there kept ptxas from using them.
// - O is normalised, written to the warpgroup's Q tile in the swizzled
//   layout and stored by TMA, which clips rows past T and columns past dh.
// Its times on the card are in PERF.md.  What holds it back: each
// warpgroup's softmax takes longer than its wgmmas, and the L2 feeds the
// K/V stream at a rate the loads wait on.  (Persistent blocks that load
// the next item's Q during this one ran no faster at qwen3's prefill.)
#include <cuda.h>   // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;            // tx: the lanes sharing a row
constexpr int kRowsPerThread = kBlockQ / (kThreads / kLanesPerRow);   // 4
constexpr int kKeysPerThread = kBlockK / kLanesPerRow;                // 4
constexpr int kMaxHeadDim = 256;
constexpr int kLdP = kBlockK + 1;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qs[3], ks[3], vs[3], os[3];       // batch, token, head strides
  int T, S, group, dh;
  int causal, prefix_len, kv_valid, q_offset;
  float scale;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// The value the reference's p.astype(v.dtype) gives, back in float32.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage rows [r0, r0 + 64) of a (rows, dh) head slice with row stride
// `row_stride` into s[64][ld] as float32; rows at or past `rows` are 0.
template <typename T>
__device__ __forceinline__ void stage(float* s, int ld, const T* base,
                                      int64_t row_stride, int r0, int rows,
                                      int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBlockQ; r += kThreads / 32) {
    const int row = r0 + r;
    const T* src = base + (int64_t)row * row_stride;
    for (int c = lane; c < dh; c += 32) {
      s[r * ld + c] = row < rows ? load(src + c) : 0.f;
    }
  }
}

template <typename T, int DB>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int NC = DB / kLanesPerRow;     // output columns per thread
  extern __shared__ float smem[];
  const int dh = a.dh;
  const int ld = dh + 1;
  float* sQ = smem;                          // [64][ld]
  float* sKV = sQ + kBlockQ * ld;            // [64][ld]: K, then V
  float* sP = sKV + kBlockK * ld;            // [64][kLdP]

  const int tx = threadIdx.x % kLanesPerRow;
  const int ty = threadIdx.x / kLanesPerRow;
  const int t0 = blockIdx.x * kBlockQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / a.group;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + hq * a.os[2];

  stage(sQ, ld, q, a.qs[1], t0, a.T, dh);

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][NC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = a.q_offset + min(t0 + kBlockQ, a.T) - 1;
  int kv_end = a.kv_valid;
  if (a.causal) kv_end = min(kv_end, max(q_last + 1, a.prefix_len));

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();              // sQ staged; the last tile's V read
    stage(sKV, ld, k, a.ks[1], k0, a.S, dh);
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = sKV[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + 16 * i;
      const int qpos = a.q_offset + t0 + r;
      bool vis[kKeysPerThread];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kpos = k0 + tx + 16 * j;
        vis[j] = kpos < a.kv_valid &&
                 (!a.causal || kpos <= qpos || kpos < a.prefix_len);
        s[i][j] = vis[j] ? s[i][j] * a.scale : -INFINITY;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_safe) : 0.f;
        row_sum += p;
        sP[r * kLdP + tx + 16 * j] =
            round_to(p, static_cast<const T*>(nullptr));
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();              // every score read K; sP written
    stage(sKV, ld, v, a.vs[1], k0, a.S, dh);
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pr[i] = sP[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float vv = sKV[kk * ld + col];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= a.T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + (int64_t)t * a.os[1];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(dst + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int DB>
int launch(const Args& a, int batch, int n_q, int heads,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)kBlockQ * (a.dh + 1) + kBlockQ * kLdP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((n_q + kBlockQ - 1) / kBlockQ),
                  (unsigned)heads, (unsigned)batch);
  flash_attention_kernel<T, DB><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int batch, int n_q, int heads,
             cudaStream_t stream) {
  if (a.dh <= 32) return launch<T, 32>(a, batch, n_q, heads, stream);
  if (a.dh <= 64) return launch<T, 64>(a, batch, n_q, heads, stream);
  if (a.dh <= 128) return launch<T, 128>(a, batch, n_q, heads, stream);
  return launch<T, 256>(a, batch, n_q, heads, stream);
}

}  // namespace


// ---------------------------------------------------------------------------
// Route 1: the tensor-core kernel (bfloat16)
// ---------------------------------------------------------------------------

namespace {
namespace tc {

constexpr int kRows = 64;                   // query rows a consumer warpgroup
constexpr int kQPanel = kRows * 128;        // bytes of a 64-row x 64-column box

struct Args {
  int T, Hkv, group, units, blocks;         // units and blocks a kv head
  int heads;                                // B * Hkv
  int causal, prefix_len, kv_valid, q_offset;
  float scale_log2;                         // dh^-1/2 * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.  (No
// trap on a phase that never completes: a trap on this path keeps ptxas
// from giving the consumers the registers setmaxnreg frees.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box at (dh column c0, token c1, head c2, batch c3).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the fence and wait instructions.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// A shared-memory matrix descriptor for the SWIZZLE_128B layout TMA writes
// (8-row groups of 128-byte rows, 1024 bytes apart: SBO).  For a K-major
// operand LBO is unused (1); for an MN-major one it is the stride between
// 64-column panels.  The tiles are 1024-byte aligned, so base offset 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[0:32] (+)= A . B over k16: m64n64k16, A and B from shared memory,
// both K-major (no transpose).
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A . B over k16: m64n64k16, A (4 bf16x2 registers a thread)
// from registers, B from shared memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:64] (+)= A . B over k16: m64n128k16, A (4 bf16x2 registers a thread)
// from registers, B from shared memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The block of a kernel padded to DP head columns: kConsumers consumer
// warpgroups (three up to DP 128; two above, where O takes DP / 2
// registers a thread) and a producer warpgroup, with the registers
// setmaxnreg gives each (65,536 in all).  Its shared memory: a Q tile a
// consumer (reused for its output), the K and V rings of 64-key tiles,
// then the barriers; every tile 1024-byte aligned, as SWIZZLE_128B needs;
// as many stages as fit in 220 KB, at most 4.  (128-key tiles ran slower
// at qwen3's prefill: fewer stages fit, and the wgmmas took as long per
// key.)
template <int DP>
struct Plan {
  static constexpr int kConsumers = DP <= 128 ? 3 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
  static constexpr int kKeys = 64;
  static constexpr int kQTile = DP * 128;              // 64 rows x DP bf16
  static constexpr int kKVPanel = kKeys * 128;         // kKeys rows x 64 bf16
  static constexpr int kKVTile = kKeys * DP * 2;
  static constexpr int kFit =
      (220 * 1024 - kConsumers * kQTile) / (2 * kKVTile);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kK = kConsumers * kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBars = kV + kStages * kKVTile;
  // full K, full V and empty barriers a stage, and one Q barrier a consumer
  static constexpr int kBytes = kBars + 8 * (3 * kStages + kConsumers);
  static constexpr int kAlloc = kBytes + 1024;         // room to align
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                    65536, "registers");
};

// The query head and first row consumer warpgroup w of a block takes, and
// the key where its loop ends (0 when it has no rows).  A kv head's units
// are its (64-row tile, query head of the group) pairs, tile by tile; a
// block takes kConsumers consecutive ones, so its warpgroups share one K/V
// stream and their key ranges differ by at most one tile.
struct Work {
  int hq, t0, kv_end;
  bool active;
};

__device__ __forceinline__ Work work_of(const Args& a, int unit, int hk) {
  Work r;
  r.hq = hk * a.group + unit % a.group;
  r.t0 = unit / a.group * kRows;
  r.active = unit < a.units;
  r.kv_end = 0;
  if (r.active) {
    r.kv_end = a.kv_valid;
    if (a.causal) {
      const int q_last = a.q_offset + min(r.t0 + kRows, a.T) - 1;
      r.kv_end = min(r.kv_end, max(q_last + 1, a.prefix_len));
    }
    r.kv_end = max(r.kv_end, 0);
  }
  return r;
}

template <int DP>
__device__ __forceinline__ void produce(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    const Work (&work)[Plan<DP>::kConsumers], uint32_t base, int n_kv, int hk,
    int b) {
  using P = Plan<DP>;
  const uint32_t bars = base + P::kBars;
#pragma unroll
  for (int w = 0; w < P::kConsumers; ++w) {
    if (!work[w].active) continue;
    const uint32_t bar = bars + 8 * (3 * P::kStages + w);
    mbar_expect_tx(bar, P::kQTile);
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
      tma_load(base + w * P::kQTile + p * kQPanel, mq, bar, p * 64,
               work[w].t0, work[w].hq, b);
  }
  for (int i = 0; i < n_kv; ++i) {
    const int s = i % P::kStages, use = i / P::kStages;
    if (use > 0) mbar_wait(bars + 8 * (2 * P::kStages + s), (use - 1) & 1);
    const uint32_t full_k = bars + 8 * s, full_v = bars + 8 * (P::kStages + s);
    mbar_expect_tx(full_k, P::kKVTile);
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
      tma_load(base + P::kK + s * P::kKVTile + p * P::kKVPanel, mk, full_k,
               p * 64, i * P::kKeys, hk, b);
    mbar_expect_tx(full_v, P::kKVTile);
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
      tma_load(base + P::kV + s * P::kKVTile + p * P::kKVPanel, mv, full_v,
               p * 64, i * P::kKeys, hk, b);
  }
}

// S = Q K^T of one tile into sc: DP / 16 wgmmas m64n64k16 over the K-major
// Q and K tiles (a k16 step is 32 bytes into a 128-byte row; four steps a
// 64-column panel).
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[Plan<DP>::kKeys / 2],
                                         uint32_t sq, uint32_t sk) {
  static_assert(Plan<DP>::kKeys == 64, "S is m64n64");
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const uint32_t q = sq + (kc / 4) * kQPanel + (kc % 4) * 32;
    const uint32_t k = sk + (kc / 4) * Plan<DP>::kKVPanel + (kc % 4) * 32;
    mma_ss_n64(sc, make_desc(q, 16), make_desc(k, 16), kc > 0);
  }
}

// O += P V of one tile: per 16 keys (two 8-key groups of 1024 bytes) one
// m64n128 wgmma per 128 columns and an m64n64 one for a last 64, V read
// MN-major with LBO the stride between its 64-column panels.
template <int DP>
__device__ __forceinline__ void issue_pv(
    float (&o)[DP / 2], const uint32_t (&pa)[Plan<DP>::kKeys / 16][4],
    uint32_t sv) {
  constexpr int kPanel = Plan<DP>::kKVPanel;
#pragma unroll
  for (int kk = 0; kk < Plan<DP>::kKeys / 16; ++kk) {
    const uint32_t vk = sv + kk * 2048;
#pragma unroll
    for (int n = 0; n < DP / 128; ++n)
      mma_rs_n128(o + 64 * n, pa[kk], make_desc(vk + 2 * n * kPanel, kPanel),
                  1);
    if (DP % 128)
      mma_rs_n64(o + 64 * (DP / 128), pa[kk],
                 make_desc(vk + 2 * (DP / 128) * kPanel, kPanel), 1);
  }
}

// t[h][0] = op over t[h][0 .. 2 W), for both rows, as a tree.
template <int W, int J>
__device__ __forceinline__ void tree_max(float (&t)[2][J]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < W; ++j) t[h][j] = fmaxf(t[h][j], t[h][j + W]);
  if constexpr (W > 1) tree_max<W / 2>(t);
}
template <int W, int J>
__device__ __forceinline__ void tree_sum(float (&t)[2][J]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < W; ++j) t[h][j] += t[h][j + W];
  if constexpr (W > 1) tree_sum<W / 2>(t);
}

// The online softmax of the tile at key k0 on the scores' fragment:
// element 4 j + 2 h + e is row row + 8 h, key k0 + 8 j + 2 quad + e.
// Masks, updates the running max m (in score units) and this lane's share
// of the sum l of both rows, leaves the unrounded probabilities in sc and
// the factor the accumulator's rows must be scaled by in corr.  Maxima and
// sums are taken as trees, so a row's values are not one dependent chain.
template <int NK>
__device__ __forceinline__ void softmax_tile(float (&sc)[NK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Args& a,
                                             int k0, int q_first, int row,
                                             int quad) {
  constexpr int J = NK / 8;                 // 8-key chunks of the tile
  const int last = k0 + NK - 1;
  const bool dense = last < a.kv_valid &&
                     (!a.causal || last <= q_first || last < a.prefix_len);
  if (!dense) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q_first + row + 8 * h;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * quad + e;
          if (!(kpos < a.kv_valid &&
                (!a.causal || kpos <= qpos || kpos < a.prefix_len)))
            sc[4 * j + 2 * h + e] = -INFINITY;
        }
    }
  }
  float t[2][J];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j)
      t[h][j] = fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
  tree_max<J / 2>(t);
  float m_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float row_max = t[h][0];
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m[h], row_max);
    // exp(scale (x - m)) = exp2(x scale log2(e) - m scale log2(e))
    m_safe[h] = isfinite(m_new) ? m_new * a.scale_log2 : 0.f;
    corr[h] = isfinite(m[h]) ? ex2(m[h] * a.scale_log2 - m_safe[h]) : 0.f;
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& x0 = sc[4 * j + 2 * h];
      float& x1 = sc[4 * j + 2 * h + 1];
      x0 = ex2(fmaf(x0, a.scale_log2, -m_safe[h]));   // a masked -inf gives 0
      x1 = ex2(fmaf(x1, a.scale_log2, -m_safe[h]));
      t[h][j] = x0 + x1;
    }
  tree_sum<J / 2>(t);
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + t[h][0];
}

// The probabilities rounded to bf16, as the A operand of keys 16 kk ..
// 16 kk + 15: (row, 2 quad), (row + 8, 2 quad), (row, 8 + 2 quad),
// (row + 8, 8 + 2 quad), each with its neighbour.
template <int NK>
__device__ __forceinline__ void pack_p(const float (&sc)[NK / 2],
                                       uint32_t (&pa)[NK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// Named barriers 4, 5 (and 6) pass a turn round the consumer warpgroups:
// a warpgroup issues its wgmmas only in its turn and hands the turn to
// the next once they are issued, so the others' softmax runs while the
// tensor cores work for it.  (Barrier 0 is __syncthreads, 1 to 3 the
// consumers' epilogues.)
__device__ __forceinline__ void wait_turn(int w) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(4 + w) : "memory");
}
__device__ __forceinline__ void pass_turn(int next) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 + next) : "memory");
}

// A consumer warpgroup: n_kv + 1 turns, the same for all of them.  In
// turn 0 it issues S of its first tile; in turn i < n_own, S of tile i
// together with P V of tile i - 1; in turn n_own, P V of its last tile.
// A tile's stage is released once its P V is done, or, for a tile past
// its own keys, in a later turn once the tile has landed (so the release
// counts toward this tile's phase of the empty barrier).  Each turn's
// wgmma groups are fixed, so the compiler can keep them in flight.
template <int DP>
__device__ __forceinline__ void consume(const Args& a, const Work& wk, int w,
                                        const CUtensorMap* mo, uint8_t* smem,
                                        uint32_t base, int n_kv, int b) {
  using P = Plan<DP>;
  constexpr int NK = P::kKeys;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, quad = lane % 4;
  const int row = 16 * (tid / 32) + lane / 4;   // this thread's rows: +0, +8
  const uint32_t bars = base + P::kBars;
  const uint32_t sq = base + w * P::kQTile;
  auto full_k = [&](int i) { return bars + 8 * (i % P::kStages); };
  auto full_v = [&](int i) { return bars + 8 * (P::kStages + i % P::kStages); };
  auto parity = [](int i) { return (uint32_t)(i / P::kStages) & 1; };
  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(bars + 8 * (2 * P::kStages + i % P::kStages));
  };
  auto k_tile = [&](int i) {
    return base + P::kK + (i % P::kStages) * P::kKVTile;
  };
  auto v_tile = [&](int i) {
    return base + P::kV + (i % P::kStages) * P::kKVTile;
  };
  // The last warpgroup does not hand over its last turn: nobody waits for
  // it.
  constexpr int NC = P::kConsumers;
  auto end_turn = [&](int turn) {
    if (w < NC - 1 || turn < n_kv) pass_turn((w + 1) % NC);
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float sc[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[NK / 16][4];
  if (wk.active) mbar_wait(bars + 8 * (3 * P::kStages + w), 0);
  const int q_first = a.q_offset + wk.t0;
  const int n_own = (wk.kv_end + NK - 1) / NK;

  if (w == NC - 1) pass_turn(0);             // warpgroup 0 goes first
  if (n_own > 0) {
    mbar_wait(full_k(0), parity(0));
    wait_turn(w);
    wg_fence();
    issue_qk<DP>(sc, sq, k_tile(0));
    wg_commit();
    end_turn(0);
    wg_wait<0>();
    pin(sc);
    softmax_tile<NK>(sc, m, l, corr, a, 0, q_first, row, quad);
    pack_p<NK>(sc, pa);                      // O is still 0: no rescale

    for (int i = 1; i < n_own; ++i) {
      mbar_wait(full_k(i), parity(i));
      mbar_wait(full_v(i - 1), parity(i - 1));
      wait_turn(w);
      wg_fence();
      issue_qk<DP>(sc, sq, k_tile(i));
      wg_commit();
      issue_pv<DP>(o, pa, v_tile(i - 1));
      wg_commit();
      end_turn(i);
      wg_wait<1>();
      pin(sc);
      softmax_tile<NK>(sc, m, l, corr, a, i * NK, q_first, row, quad);
      wg_wait<0>();
      pin(o);
      release(i - 1);
      // Once the running maxima settle, corr is exactly 1 for every row of
      // a warp and the rescale is skipped.
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }
      pack_p<NK>(sc, pa);
    }

    mbar_wait(full_v(n_own - 1), parity(n_own - 1));
    wait_turn(w);
    wg_fence();
    issue_pv<DP>(o, pa, v_tile(n_own - 1));
    wg_commit();
    end_turn(n_own);
    wg_wait<0>();
    pin(o);
    release(n_own - 1);
  } else {
    wait_turn(w);
    end_turn(0);
  }
  for (int turn = n_own + 1; turn <= n_kv; ++turn) {
    wait_turn(w);
    end_turn(turn);
    mbar_wait(full_v(turn - 1), parity(turn - 1));
    release(turn - 1);
  }

  if (wk.active) {
    // O / l, rounded, into this warpgroup's Q tile in the swizzled layout
    // (16-byte chunk c of row r at chunk c ^ (r % 8)), then one TMA store
    // per 64-column panel.
    uint8_t* so = smem + w * P::kQTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float denom = fmaxf(l[h], 1e-30f);
      const int r = row + 8 * h;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int off = (j / 8) * kQPanel + r * 128 +
                        (((j % 8) ^ (r % 8)) * 16) + quad * 4;
        *reinterpret_cast<uint32_t*>(so + off) = pack_bf16(
            o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
        tma_store(mo, sq + p * kQPanel, p * 64, wk.t0, wk.hq, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(Plan<DP>::kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mo, const Args a) {
  using P = Plan<DP>;
  constexpr int NC = P::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + P::kBars;

  // Blocks run (kv head, batch) fastest and the units' blocks from the
  // last (the longest causal rows) to the first, so the short diagonal
  // tiles fill the tail.
  const int bh = (int)(blockIdx.x % a.heads);
  const int unit0 = (a.blocks - 1 - (int)(blockIdx.x / a.heads)) * NC;
  const int hk = bh % a.Hkv, b = bh / a.Hkv;
  Work work[NC];
  int kv_end = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w) {
    work[w] = work_of(a, unit0 + w, hk);
    kv_end = max(kv_end, work[w].kv_end);
  }
  const int n_kv = (kv_end + P::kKeys - 1) / P::kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), 1);
      mbar_init(bars + 8 * (2 * P::kStages + s), NC);
    }
    for (int w = 0; w < NC; ++w) mbar_init(bars + 8 * (3 * P::kStages + w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, made warp-uniform for the compiler, so that each
  // branch gets the registers its setmaxnreg gives it.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(P::kProducerRegs));
    if (threadIdx.x == 0) produce<DP>(&mq, &mk, &mv, work, base, n_kv, hk, b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(P::kConsumerRegs));
    consume<DP>(a, work[wg - 1], wg - 1, &mo, smem, base, n_kv, b);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the runtime has loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (dh, token, head, batch) of a bf16 operand whose element
// strides are st = (batch, token, head), in 64 x rows x 1 x 1 boxes.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
            const int64_t* st, int batch, int tokens, int heads, int dh,
            int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)tokens,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(EncodeTiled enc, const void* q, const void* k, const void* v,
           void* out, const int64_t* strides, int B, int T, int S, int Hq,
           int Hkv, int dh, Args a, cudaStream_t stream) {
  a.blocks = (a.units + Plan<DP>::kConsumers - 1) / Plan<DP>::kConsumers;
  const int64_t blocks = (int64_t)a.blocks * a.heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4] = {};                  // k, v stay zero when S is 0
  const int keys = Plan<DP>::kKeys;
  if (!encode(enc, &maps[0], q, strides, B, T, Hq, dh, kRows) ||
      !encode(enc, &maps[3], out, strides + 9, B, T, Hq, dh, kRows) ||
      (S > 0 &&
       (!encode(enc, &maps[1], k, strides + 3, B, S, Hkv, dh, keys) ||
        !encode(enc, &maps[2], v, strides + 6, B, S, Hkv, dh, keys))))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<DP>::kAlloc);
  if (err != cudaSuccess) return (int)err;
  flash_attention_tc<DP><<<(unsigned)blocks, Plan<DP>::kThreads,
                           Plan<DP>::kAlloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

// The operands route 1 takes: bf16, dh a multiple of 16 in [16, 256],
// 16-byte aligned bases, positive strides that are multiples of 8 elements
// (16 bytes, as TMA needs); k and v are not read when S is 0.
int run(int dtype, const void* q, const void* k, const void* v, void* out,
        const int64_t* strides, int B, int T, int S, int Hq, int Hkv, int dh,
        int causal, int prefix_len, int kv_valid, int q_offset, float scale,
        cudaStream_t stream) {
  if (dtype != 1 || dh % 16 || dh < 16 || dh > 256)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    if (S == 0 && (i == 1 || i == 2)) continue;
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] <= 0 || strides[3 * i + j] % 8)
        return (int)cudaErrorInvalidValue;
  }
  const int group = Hq / Hkv;
  const int64_t units = ((int64_t)T + kRows - 1) / kRows * group;
  const int64_t heads = (int64_t)B * Hkv;
  if (units > 0x7fffffff || heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.T = T;
  a.Hkv = Hkv;
  a.group = group;
  a.units = (int)units;
  a.heads = (int)heads;
  a.causal = causal;
  a.prefix_len = prefix_len;
  a.kv_valid = kv_valid;
  a.q_offset = q_offset;
  a.scale_log2 = scale * 1.4426950408889634f;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (dh <= 64)
    return launch<64>(enc, q, k, v, out, strides, B, T, S, Hq, Hkv, dh, a,
                      stream);
  if (dh <= 128)
    return launch<128>(enc, q, k, v, out, strides, B, T, S, Hq, Hkv, dh, a,
                       stream);
  if (dh <= 192)
    return launch<192>(enc, q, k, v, out, strides, B, T, S, Hq, Hkv, dh, a,
                       stream);
  return launch<256>(enc, q, k, v, out, strides, B, T, S, Hq, Hkv, dh, a,
                     stream);
}

}  // namespace tc
}  // namespace

extern "C" int flash_attention_max_head_dim(void) { return kMaxHeadDim; }

// Launches route 0 (scalar) or 1 (tensor cores) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// the route does not take; nothing is launched then.  dtype: 0 float32, 1
// bfloat16.  strides: 12 element strides, (batch, token, head) of q, k, v
// and out; the head dim is contiguous in all four.  kv_valid is in [0, S];
// Hq is a multiple of Hkv; 1 <= dh <= 256; B and Hq at most 65,535 (the
// scalar grid's z and y axes).
extern "C" int flash_attention(int route, int dtype, const void* q,
                               const void* k, const void* v, void* out,
                               const int64_t* strides, int B, int T, int S,
                               int Hq, int Hkv, int dh, int causal,
                               int prefix_len, int kv_valid, int q_offset,
                               float scale, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || Hkv < 1 || Hq % Hkv || B > 65535 ||
      Hq > 65535 || kv_valid < 0 || kv_valid > S ||
      (dtype != 0 && dtype != 1) || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || Hq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return tc::run(dtype, q, k, v, out, strides, B, T, S, Hq, Hkv, dh, causal,
                   prefix_len, kv_valid, q_offset, scale, st);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.T = T;
  a.S = S;
  a.group = Hq / Hkv;
  a.dh = dh;
  a.causal = causal;
  a.prefix_len = prefix_len;
  a.kv_valid = kv_valid;
  a.q_offset = q_offset;
  a.scale = scale;
  return dtype == 0 ? dispatch<float>(a, B, T, Hq, st)
                    : dispatch<__nv_bfloat16>(a, B, T, Hq, st);
}
