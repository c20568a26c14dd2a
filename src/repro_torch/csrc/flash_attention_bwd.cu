// The backward of the causal (+ prefix-LM) flash attention of
// flash_attention.cu, for Hopper (sm_90a): a scalar route for float32 and
// bfloat16 inputs, and a tensor-core route for bfloat16.
//
// Given q (B, T, Hq, dh), k, v (B, S, Hkv, dh), the forward's output o and
// its cotangent dO, both (B, T, Hq, dh), it writes dq, dk and dv in the input
// type.  With s = q.k * dh^-1/2 over the keys each query may see (the
// forward's mask: s < kv_valid and, if causal, s <= q_offset + t or s <
// prefix_len), P = exp(s - m) / max(l, 1e-30) for the row's max m and
// denominator l, and D = rowsum(dO * o):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),
//   dQ = dS K dh^-1/2,  dK = dS^T Q dh^-1/2,
// each kv head summing over its Hq / Hkv query heads.  Rows with no visible
// key give zero gradients.  Scores, statistics and accumulators are float32.
//
// Replaces no TPU kernel: the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:99) has no backward,
// and the reference trains by autodiff of the jnp blocked attention
// (src/repro/models/layers.py:122-192).  It is the gradient of that function,
// launched by the backward of the port's autograd.Function, because
// autograd cannot see through the forward kernel's launch.
//
// Bound: operations.  10 dh flops per visible (query, key) pair (QK^T and
// dO V^T, then dV, dQ and dK), against q, k, v, o and dO read once and dq,
// dk, dv written once.  At qwen3-1.7b's training shape (B 4, T = S = 2048,
// 16 query heads over 8 kv heads, dh 128, causal, bf16): 171.9 GFLOP, 0.174
// ms at the tensor cores' 989 TFLOP/s, against 201 MB, 0.060 ms at 3.35
// TB/s.
//
// Both routes: two kernels on one stream, dq then dkdv, no atomics and no
// split of a sum across blocks, so every launch gives the same bits (the
// training step's bit-exact resume relies on it).  dq computes each row's
// statistics and writes them to a float32 scratch that dkdv reads.
//
// Route 0, scalar (float32, and bfloat16 the tensor cores cannot take):
// float32 FMAs, no tensor cores, 256 threads a block.
// 1. dq: one block per (64-query tile, query head, batch row).  Pass 1 runs
//    the forward's online max and denominator over the tile's key range
//    (the forward's causal end, min(kv_valid, max(last query position + 1,
//    prefix_len))) and D from o and dO; it writes m, 1/l and D per row to
//    the scratch (3, B, Hq, T).  Pass 2 walks the keys again: V's tile gives
//    dP = dO V^T, K's tile (in the same buffer) gives S, P and dS, which
//    goes to shared memory, and dQ += dS K stays in registers.  Each thread
//    owns a 4 x 4 score tile (rows ty + 16 i, keys tx + 16 j) and 4 rows x
//    dh/16 columns of dQ.
// 2. dkdv: one block per (key tile, kv head, batch row); the key tile is 64
//    keys up to dh 128 and 32 above (shared memory).  K and V stay staged;
//    the block loops over the group's query heads, then over the query
//    tiles that may see a key of the tile (from the first one when causal
//    and the tile starts at or past prefix_len), staging Q, dO and the rows'
//    statistics, computing S^T and dP^T (each thread 4 or 2 keys x 4
//    queries), P and dS to shared memory, then dV += P^T dO and dK += dS^T Q
//    in registers (keys x dh/16 columns each).
// Every tile is staged through float32 shared memory by plain loads, rows
// padded to dh + 1 floats so 16 lanes reading 16 rows hit 16 banks.  Shared
// memory: dq 4 (3 * 64 (dh + 1) + 64 * 65) bytes (115,712 at dh 128,
// 214,016 at dh 256); dkdv 4 ((2 KB + 128) (dh + 1) + 2 KB * 65 + 192) bytes
// (166,144 at dh 128, 214,784 at dh 256 with KB = 32).
//
// Route 1, tensor cores (bfloat16, dh a multiple of 16 up to 256, 16-byte
// aligned bases, token, head and batch strides multiples of 8 elements: the
// operands the forward's tensor-core route takes).  The forward's pieces:
// TMA loads of 64-row x 64-column SWIZZLE_128B boxes over 4-D tensor maps
// (dh, token, head, batch) with the operands' own strides, a producer
// warpgroup whose one thread keeps a ring of stages in flight on
// mbarriers, consumer warpgroups running wgmma m64nNk16 bf16 -> f32, and
// setmaxnreg moving registers from the producer (24) to two consumers
// (240).  Head dims pad to DP = 64, 128 or 256 columns; panels past dh are
// zeroed once in shared memory and never loaded, so dh 192 reads as 256.
// 1. dq: a block takes two consecutive units of a kv head, one a consumer
//    (one consumer above DP 128, where dQ takes DP / 2 registers a
//    thread), a unit being a (64-row query tile, query head of the group)
//    pair, as the forward's blocks do: at qwen3's g = 2 both heads of a
//    tile share one K/V stream.  Blocks run from the last query tiles (the
//    longest causal rows) to the first: 32 x 8 x 4 = 1,024 at qwen3's
//    training shape.  Each consumer's Q and dO tiles stay staged; the
//    ring brings K tiles for pass 1, then K and V tiles for pass 2.
//    Pass 1: S = Q K^T on wgmma, the forward's online max and sum in
//    registers; each row's lse2 = m dh^-1/2 log2(e) + log2(max(l, 1e-30))
//    and D (from o and dO read straight from global memory, 16 bytes a
//    load) go to the scratch (B, Hq, T / 64, 2, 64).  Pass 2: S = Q K^T and
//    dP = dO V^T on wgmma, P = exp2(S dh^-1/2 log2(e) - lse2) and dS = P
//    (dP - D) in registers, then dQ += dS K with dS rounded to bf16 as the
//    register A operand and K read MN-major, dQ in registers.
// 2. dkdv: a block owns 128 keys of one (kv head, batch row), 64 a
//    consumer, whose K and V tiles stay staged (above DP 128 both consumers
//    own the same 64 keys and split dK's and dV's columns, each recomputing
//    S^T and dP^T).  Blocks run from the keys near position 0, which the
//    most query tiles see: 16 x 8 x 4 = 512 at qwen3's training shape.  The
//    ring brings, for each query head of the group and each query tile
//    that may see a key of the block, the Q and dO tiles and the rows'
//    lse2 and D (one bulk copy).  S^T = K Q^T and dP^T = V dO^T on wgmma;
//    P^T = exp2(S^T dh^-1/2 log2(e) - lse2) and dS^T = P^T (dP^T - D) in
//    registers; dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to
//    bf16 as register A operands and dO and Q read MN-major.  dK and dV
//    stay in registers across the whole loop.
// Rounding P and dS to bf16 before their products is the rounding the
// forward gives P before P V.  Masks are applied per element only on tiles
// that are not wholly visible; every consumer of a block walks the block's
// whole range, and a tile past its own rows is masked to zero.  The
// results are written to shared memory in the swizzled layout and stored by
// TMA, which clips rows past T and S.  Shared memory (at most 220 KB of
// tiles, at most 4 stages, plus 1,024 bytes of alignment room): at DP 128
// dq holds 2 x 2 Q/dO tiles and 4 K/V stages, 198,224 bytes, and dkdv 2 K
// and 2 V tiles and 4 Q/dO/statistics stages, 199,752 bytes.  At DP 256
// (dh over 128) the 32 KB tiles need smaller blocks: dq one consumer (1 x
// 2 Q/dO tiles) and 2 stages, 197,928 bytes; dkdv one K and one V tile and
// 2 stages, 198,696 bytes.  Its times beside the bound are in PERF.md.
#include <cuda.h>   // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                  // tx: the lanes sharing a row
constexpr int kBlockQ = 64;                 // query rows of a tile
constexpr int kRows = kBlockQ / (kThreads / kLanes);   // 4 a thread
constexpr int kMaxHeadDim = 256;
constexpr int kLdT = 65;                    // row stride of P and dS tiles

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;                             // (3, B, Hq, T): m, 1/l, D
  int64_t qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int B, T, S, Hq, group, dh;
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

// Stage rows [r0, r0 + n) of a (rows, dh) head slice with row stride
// `row_stride` into s[n][ld] as float32; rows at or past `rows` are 0.
template <typename T>
__device__ __forceinline__ void stage(float* s, int ld, int n, const T* base,
                                      int64_t row_stride, int r0, int rows,
                                      int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kThreads / 32) {
    const int row = r0 + r;
    const T* src = base + (int64_t)row * row_stride;
    for (int c = lane; c < dh; c += 32) {
      s[r * ld + c] = row < rows ? load(src + c) : 0.f;
    }
  }
}

// Whether query t (at position q_offset + t) sees the key at kpos.
__device__ __forceinline__ bool visible(const Args& a, int t, int kpos) {
  return t < a.T && kpos < a.kv_valid &&
         (!a.causal || kpos <= a.q_offset + t || kpos < a.prefix_len);
}

template <typename T, int DB>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const Args a) {
  constexpr int NC = DB / kLanes;           // dQ columns a thread
  extern __shared__ float smem[];
  const int dh = a.dh;
  const int ld = dh + 1;
  float* sQ = smem;                          // [64][ld]
  float* sdO = sQ + kBlockQ * ld;            // [64][ld]
  float* sKV = sdO + kBlockQ * ld;           // [64][ld]: K, V or o
  float* sDS = sKV + kBlockQ * ld;           // [64][kLdT]

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int t0 = blockIdx.x * kBlockQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / a.group;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + hq * a.os[2];
  const T* dout =
      static_cast<const T*>(a.dout) + b * a.dos[0] + hq * a.dos[2];
  T* dq = static_cast<T*>(a.dq) + b * a.dqs[0] + hq * a.dqs[2];

  stage(sQ, ld, kBlockQ, q, a.qs[1], t0, a.T, dh);
  stage(sdO, ld, kBlockQ, dout, a.dos[1], t0, a.T, dh);

  const int q_last = a.q_offset + min(t0 + kBlockQ, a.T) - 1;
  int kv_end = a.kv_valid;
  if (a.causal) kv_end = min(kv_end, max(q_last + 1, a.prefix_len));

  // S = Q K^T (or dP = dO V^T) for this thread's 4 x 4 tile.
  auto dots = [&](const float* sA, float (&s)[kRows][4]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float av[kRows], kv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) av[i] = sA[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }
  };

  // Pass 1: the rows' max and denominator, as the forward runs them.
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv_end; k0 += kBlockQ) {
    __syncthreads();              // sQ staged; the last tile's K read
    stage(sKV, ld, kBlockQ, k, a.ks[1], k0, a.S, dh);
    __syncthreads();
    float s[kRows][4];
    dots(sQ, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = t0 + ty + 16 * i;
      bool vis[4];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(a, t, k0 + tx + 16 * j);
        s[i][j] = vis[j] ? s[i][j] * a.scale : -INFINITY;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        row_sum += vis[j] ? expf(s[i][j] - m_safe) : 0.f;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
    }
  }

  // D = rowsum(dO * o); the statistics go to the scratch for dkdv.
  __syncthreads();
  stage(sKV, ld, kBlockQ, o, a.os[1], t0, a.T, dh);
  __syncthreads();
  float big_d[kRows], inv_l[kRows];
  const int64_t plane = (int64_t)a.B * a.Hq * a.T;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    float d = 0.f;
    for (int c = tx; c < dh; c += kLanes)
      d = fmaf(sdO[r * ld + c], sKV[r * ld + c], d);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    big_d[i] = d;
    m[i] = isfinite(m[i]) ? m[i] : 0.f;
    inv_l[i] = 1.f / fmaxf(l[i], 1e-30f);
    const int t = t0 + r;
    if (tx == 0 && t < a.T) {
      const int64_t idx = ((int64_t)b * a.Hq + hq) * a.T + t;
      a.stats[idx] = m[i];
      a.stats[plane + idx] = inv_l[i];
      a.stats[2 * plane + idx] = big_d[i];
    }
  }

  // Pass 2: dQ = dS K * scale.
  float acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockQ) {
    __syncthreads();              // o or the last tile's K read
    stage(sKV, ld, kBlockQ, v, a.vs[1], k0, a.S, dh);
    __syncthreads();
    float dp[kRows][4];
    dots(sdO, dp);
    __syncthreads();              // every thread read V
    stage(sKV, ld, kBlockQ, k, a.ks[1], k0, a.S, dh);
    __syncthreads();
    float s[kRows][4];
    dots(sQ, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const float p = visible(a, t0 + r, k0 + key)
                            ? expf(s[i][j] * a.scale - m[i]) * inv_l[i]
                            : 0.f;
        sDS[r * kLdT + key] = p * (dp[i][j] - big_d[i]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kBlockQ; ++kk) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = sDS[(ty + 16 * i) * kLdT + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float kv = sKV[kk * ld + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= a.T) continue;
    T* dst = dq + (int64_t)t * a.dqs[1];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(dst + col, acc[i][c] * a.scale);
    }
  }
}

template <typename T, int DB, int KB>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const Args a) {
  constexpr int NC = DB / kLanes;           // dK, dV columns a thread
  constexpr int KA = KB / kLanes;           // keys a thread
  extern __shared__ float smem[];
  const int dh = a.dh;
  const int ld = dh + 1;
  float* sK = smem;                          // [KB][ld]
  float* sV = sK + KB * ld;                  // [KB][ld]
  float* sQ = sV + KB * ld;                  // [64][ld]
  float* sdO = sQ + kBlockQ * ld;            // [64][ld]
  float* sP = sdO + kBlockQ * ld;            // [KB][kLdT]
  float* sDS = sP + KB * kLdT;               // [KB][kLdT]
  float* sM = sDS + KB * kLdT;               // [64]: m
  float* sIL = sM + kBlockQ;                 // [64]: 1 / l
  float* sD = sIL + kBlockQ;                 // [64]: D

  const int tx = threadIdx.x % kLanes;       // queries tx + 16 i
  const int ty = threadIdx.x / kLanes;       // keys ty + 16 j
  const int s0 = blockIdx.x * KB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
  T* dk = static_cast<T*>(a.dk) + b * a.dks[0] + hk * a.dks[2];
  T* dv = static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[2];
  const int64_t plane = (int64_t)a.B * a.Hq * a.T;

  float acc_k[KA][NC], acc_v[KA][NC];
#pragma unroll
  for (int j = 0; j < KA; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  if (s0 < a.kv_valid) {
    stage(sK, ld, KB, k, a.ks[1], s0, a.S, dh);
    stage(sV, ld, KB, v, a.vs[1], s0, a.S, dh);
    // The first query tile that may see a key of this tile.
    int t_begin = 0;
    if (a.causal && s0 >= a.prefix_len)
      t_begin = max(0, s0 - a.q_offset) / kBlockQ * kBlockQ;
    for (int h = 0; h < a.group; ++h) {
      const int hq = hk * a.group + h;
      const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
      const T* dout =
          static_cast<const T*>(a.dout) + b * a.dos[0] + hq * a.dos[2];
      const float* stats = a.stats + ((int64_t)b * a.Hq + hq) * a.T;
      for (int t0 = t_begin; t0 < a.T; t0 += kBlockQ) {
        __syncthreads();          // the last tile's Q, dO, P and dS read
        stage(sQ, ld, kBlockQ, q, a.qs[1], t0, a.T, dh);
        stage(sdO, ld, kBlockQ, dout, a.dos[1], t0, a.T, dh);
        if (threadIdx.x < kBlockQ) {
          const int t = t0 + threadIdx.x;
          const bool in = t < a.T;
          sM[threadIdx.x] = in ? stats[t] : 0.f;
          sIL[threadIdx.x] = in ? stats[plane + t] : 0.f;
          sD[threadIdx.x] = in ? stats[2 * plane + t] : 0.f;
        }
        __syncthreads();
        float s[KA][4], dp[KA][4];
#pragma unroll
        for (int j = 0; j < KA; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
        for (int d = 0; d < dh; ++d) {
          float kv[KA], vv[KA], qv[4], dov[4];
#pragma unroll
          for (int j = 0; j < KA; ++j) {
            kv[j] = sK[(ty + 16 * j) * ld + d];
            vv[j] = sV[(ty + 16 * j) * ld + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qv[i] = sQ[(tx + 16 * i) * ld + d];
            dov[i] = sdO[(tx + 16 * i) * ld + d];
          }
#pragma unroll
          for (int j = 0; j < KA; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
              dp[j][i] = fmaf(vv[j], dov[i], dp[j][i]);
            }
        }
#pragma unroll
        for (int j = 0; j < KA; ++j) {
          const int key = ty + 16 * j;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = tx + 16 * i;
            const float p = visible(a, t0 + r, s0 + key)
                                ? expf(s[j][i] * a.scale - sM[r]) * sIL[r]
                                : 0.f;
            sP[key * kLdT + r] = p;
            sDS[key * kLdT + r] = p * (dp[j][i] - sD[r]);
          }
        }
        __syncthreads();
        for (int r = 0; r < kBlockQ; ++r) {
          float p[KA], ds[KA];
#pragma unroll
          for (int j = 0; j < KA; ++j) {
            p[j] = sP[(ty + 16 * j) * kLdT + r];
            ds[j] = sDS[(ty + 16 * j) * kLdT + r];
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int col = tx + 16 * c;
            if (col < dh) {
              const float dov = sdO[r * ld + col];
              const float qv = sQ[r * ld + col];
#pragma unroll
              for (int j = 0; j < KA; ++j) {
                acc_v[j][c] = fmaf(p[j], dov, acc_v[j][c]);
                acc_k[j][c] = fmaf(ds[j], qv, acc_k[j][c]);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int key = s0 + ty + 16 * j;
    if (key >= a.S) continue;
    T* dst_k = dk + (int64_t)key * a.dks[1];
    T* dst_v = dv + (int64_t)key * a.dvs[1];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        store(dst_k + col, acc_k[j][c] * a.scale);
        store(dst_v + col, acc_v[j][c]);
      }
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DB, int KB>
int launch(const Args& a, int n_kv, cudaStream_t stream) {
  const size_t ld = (size_t)a.dh + 1;
  const size_t smem_dq =
      sizeof(float) * (3 * kBlockQ * ld + (size_t)kBlockQ * kLdT);
  const size_t smem_kv =
      sizeof(float) * ((2 * (size_t)KB + 2 * kBlockQ) * ld +
                       2 * (size_t)KB * kLdT + 3 * kBlockQ);
  int err = allow_smem(flash_attention_bwd_dq_kernel<T, DB>, smem_dq);
  if (err) return err;
  err = allow_smem(flash_attention_bwd_dkdv_kernel<T, DB, KB>, smem_kv);
  if (err) return err;
  const dim3 grid_q((unsigned)((a.T + kBlockQ - 1) / kBlockQ),
                    (unsigned)a.Hq, (unsigned)a.B);
  flash_attention_bwd_dq_kernel<T, DB><<<grid_q, kThreads, smem_dq,
                                         stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid_k((unsigned)((a.S + KB - 1) / KB), (unsigned)n_kv,
                    (unsigned)a.B);
  flash_attention_bwd_dkdv_kernel<T, DB, KB><<<grid_k, kThreads, smem_kv,
                                               stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int n_kv, cudaStream_t stream) {
  if (a.dh <= 32) return launch<T, 32, 64>(a, n_kv, stream);
  if (a.dh <= 64) return launch<T, 64, 64>(a, n_kv, stream);
  if (a.dh <= 128) return launch<T, 128, 64>(a, n_kv, stream);
  return launch<T, 256, 32>(a, n_kv, stream);
}

}  // namespace


// ---------------------------------------------------------------------------
// Route 1: the tensor-core kernels (bfloat16)
// ---------------------------------------------------------------------------

namespace {
namespace tc {

constexpr int kRows = 64;                   // rows of every tile
constexpr int kPanel = kRows * 128;         // bytes of a 64 x 64 bf16 box
constexpr int kStatBytes = 2 * kRows * 4;   // a query tile's lse2 and D

struct Args {
  const __nv_bfloat16* o;                   // read for D
  const __nv_bfloat16* dout;
  float* stats;                             // (B, Hq, q_tiles, 2, 64)
  int64_t os[3], dos[3];                    // batch, token, head strides
  int T, S, Hq, Hkv, group, dh, panels;     // panels: ceil(dh / 64) loaded
  int q_tiles, units, blocks, heads;        // dq: units, blocks a kv head
  int causal, prefix_len, kv_valid, q_offset;
  float scale, scale_log2;                  // dh^-1/2, and times log2(e)
};

// The PTX helpers of flash_attention.cu's tensor-core route (mbarriers,
// TMA, wgmma), repeated here: that source stays as it is.
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

// Returns once the barrier's phase of the given parity has completed (no
// trap: one on this path keeps ptxas from honouring setmaxnreg).
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

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
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

// d[0:32] += A . B over k16: m64n64k16, A (4 bf16x2 registers a thread)
// from registers, B from shared memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                          uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:64] += A . B over k16: m64n128k16, A (4 bf16x2 registers a thread)
// from registers, B from shared memory MN-major (transposed).
__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a,
                                           uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc = A B^T over DP columns: DP / 16 wgmmas m64n64k16 over two 64-row
// K-major tiles (a k16 step is 32 bytes into a 128-byte row; four steps a
// 64-column panel).
template <int DP>
__device__ __forceinline__ void issue_nt(float (&acc)[32], uint32_t sa,
                                         uint32_t sb) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const uint32_t off = (kc / 4) * kPanel + (kc % 4) * 32;
    mma_ss_n64(acc, make_desc(sa + off, 16), make_desc(sb + off, 16), kc > 0);
  }
}

// acc += A B over the 64 rows of a tile: A from registers (4 k16
// fragments), B the N columns of the tile from `sb` on, MN-major; per 16
// rows (two 8-row groups of 1024 bytes) one m64n128 wgmma per 128 columns
// and an m64n64 one for a last 64, with LBO the panel stride.
template <int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t bk = sb + kk * 2048;
#pragma unroll
    for (int n = 0; n < N / 128; ++n)
      mma_rs_n128(acc + 64 * n, a[kk], make_desc(bk + 2 * n * kPanel, kPanel));
    if (N % 128)
      mma_rs_n64(acc + 64 * (N / 128), a[kk],
                 make_desc(bk + 2 * (N / 128) * kPanel, kPanel));
  }
}

// An accumulator tile rounded to bf16 as the A operand of its 64 columns:
// k16 step kk takes (row, 2 quad), (row + 8, 2 quad), (row, 8 + 2 quad),
// (row + 8, 8 + 2 quad) of columns 16 kk on, each with its neighbour.
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Whether query t (at position q_offset + t) sees the key at kpos, and
// whether every pair of the 64 x 64 tile at (t0, k0) is visible.
__device__ __forceinline__ bool visible(const Args& a, int t, int kpos) {
  return t < a.T && kpos < a.kv_valid &&
         (!a.causal || kpos <= a.q_offset + t || kpos < a.prefix_len);
}
__device__ __forceinline__ bool dense(const Args& a, int t0, int k0) {
  const int last = k0 + kRows - 1;
  return t0 + kRows <= a.T && last < a.kv_valid &&
         (!a.causal || last <= a.q_offset + t0 || last < a.prefix_len);
}

// t[h][0] = op over t[h][0 .. 2 W), for both rows, as a tree.
template <int W>
__device__ __forceinline__ void tree_max(float (&t)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < W; ++j) t[h][j] = fmaxf(t[h][j], t[h][j + W]);
  if constexpr (W > 1) tree_max<W / 2>(t);
}
template <int W>
__device__ __forceinline__ void tree_sum(float (&t)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < W; ++j) t[h][j] += t[h][j + W];
  if constexpr (W > 1) tree_sum<W / 2>(t);
}

// Zeroes the panels past a.panels of the first `tiles` tiles (64 rows x
// DP columns each) from smem: TMA loads only the panels that hold head
// columns, and the products read the rest as zeros.
template <int DP>
__device__ __forceinline__ void zero_padding(uint8_t* smem, int tiles,
                                             const Args& a) {
  if (a.panels == DP / 64) return;
  for (int t = 0; t < tiles; ++t)
    for (int p = a.panels; p < DP / 64; ++p) {
      uint4* dst = reinterpret_cast<uint4*>(smem + (t * DP / 64 + p) * kPanel);
      for (int i = threadIdx.x; i < kPanel / 16; i += blockDim.x)
        dst[i] = make_uint4(0, 0, 0, 0);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dq kernel's block: kConsumers consumer warpgroups, each a 64-row query
// tile of one head (its Q and dO tiles stay staged), and a producer
// warpgroup streaming the kv head's K tiles (pass 1) and K and V tiles
// (pass 2) through a ring; then D's rows and the barriers.  Two consumers
// up to DP 128, one above (its dQ takes DP / 2 registers a thread).
template <int DP>
struct DqPlan {
  static constexpr int kConsumers = DP <= 128 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kTile = DP * 128;               // 64 rows x DP bf16
  static constexpr int kFit =
      (220 * 1024 - 2 * kConsumers * kTile) / (2 * kTile);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kDO = kConsumers * kTile;
  static constexpr int kK = 2 * kConsumers * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kD = kV + kStages * kTile;      // float[64] a consumer
  static constexpr int kBars = kD + kConsumers * 256;
  // full and empty a stage, one Q/dO barrier a consumer
  static constexpr int kBytes = kBars + 8 * (2 * kStages + kConsumers);
  static constexpr int kAlloc = kBytes + 1024;         // room to align
  static constexpr int kTiles = 2 * kConsumers + 2 * kStages;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
};

// dkdv kernel's block: two consumer warpgroups and a producer streaming the
// group's Q and dO tiles with their rows' statistics through a ring.  Up to
// DP 128 each consumer owns 64 keys (128 a block); above, both own the
// same 64 keys and split dK's and dV's columns (each DP / 2 registers a
// thread), recomputing S^T and dP^T.
template <int DP>
struct KvPlan {
  static constexpr int kConsumers = 2;
  static constexpr int kSplit = DP <= 128 ? 1 : 2;
  static constexpr int kKTiles = kConsumers / kSplit;
  static constexpr int kKeys = kRows * kKTiles;        // keys a block
  static constexpr int kCols = DP / kSplit;            // columns a consumer
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kTile = DP * 128;
  static constexpr int kFit = (220 * 1024 - 2 * kKTiles * kTile) /
                              (2 * kTile + kStatBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kV = kKTiles * kTile;
  static constexpr int kQ = 2 * kKTiles * kTile;
  static constexpr int kDO = kQ + kStages * kTile;
  static constexpr int kStats = kDO + kStages * kTile;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  // full and empty a stage, one K/V barrier
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1);
  static constexpr int kAlloc = kBytes + 1024;
  static constexpr int kTiles = 2 * kKTiles + 2 * kStages;
  static_assert(kStages >= 2, "the Q/dO ring needs two stages");
};

constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536,
              "registers");

// The query head and first row of dq unit `unit` of kv head hk, and the
// key its rows' range ends at (the forward's causal end).
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

__device__ __forceinline__ float* stats_of(const Args& a, int b, int hq,
                                           int t0) {
  return a.stats +
         (((int64_t)b * a.Hq + hq) * a.q_tiles + t0 / kRows) * (2 * kRows);
}

// D = rowsum(dO * o) of a consumer's 64 rows into d[64], from global memory
// (two threads a row, 8 columns a load); rows past T give 0.
__device__ __forceinline__ void rows_d(const Args& a, int b, int hq, int t0,
                                       float* d) {
  const int tid = threadIdx.x % 128;
  const int r = tid / 2, t = t0 + r;
  float acc = 0.f;
  if (t < a.T) {
    const __nv_bfloat16* o = a.o + b * a.os[0] + (int64_t)t * a.os[1] +
                             hq * a.os[2];
    const __nv_bfloat16* g = a.dout + b * a.dos[0] + (int64_t)t * a.dos[1] +
                             hq * a.dos[2];
    for (int c = (tid % 2) * 8; c < a.dh; c += 16) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(o2[k]);
        const float2 y = __bfloat1622float2(g2[k]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (tid % 2 == 0) d[r] = acc;
}

template <int DP>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv,
    const CUtensorMap* mdo, const Work (&work)[DqPlan<DP>::kConsumers],
    const Args& a, uint32_t base, int n_kv, int hk, int b) {
  using P = DqPlan<DP>;
  const uint32_t bars = base + P::kBars;
  const uint32_t panel_bytes = a.panels * kPanel;
#pragma unroll
  for (int w = 0; w < P::kConsumers; ++w) {
    if (!work[w].active) continue;
    const uint32_t bar = bars + 8 * (2 * P::kStages + w);
    mbar_expect_tx(bar, 2 * panel_bytes);
    for (int p = 0; p < a.panels; ++p) {
      tma_load(base + w * P::kTile + p * kPanel, mq, bar, p * 64, work[w].t0,
               work[w].hq, b);
      tma_load(base + P::kDO + w * P::kTile + p * kPanel, mdo, bar, p * 64,
               work[w].t0, work[w].hq, b);
    }
  }
  // Items 0 .. n_kv - 1: K tiles (pass 1); n_kv .. 2 n_kv - 1: K and V.
  for (int i = 0; i < 2 * n_kv; ++i) {
    const int s = i % P::kStages, use = i / P::kStages;
    if (use > 0) mbar_wait(bars + 8 * (P::kStages + s), (use - 1) & 1);
    const bool both = i >= n_kv;
    const int k0 = (both ? i - n_kv : i) * kRows;
    const uint32_t full = bars + 8 * s;
    mbar_expect_tx(full, (both ? 2 : 1) * panel_bytes);
    for (int p = 0; p < a.panels; ++p) {
      tma_load(base + P::kK + s * P::kTile + p * kPanel, mk, full, p * 64, k0,
               hk, b);
      if (both)
        tma_load(base + P::kV + s * P::kTile + p * kPanel, mv, full, p * 64,
                 k0, hk, b);
    }
  }
}

// A dq consumer warpgroup.  Pass 1 runs the forward's online max and sum
// over S = Q K^T and writes each row's lse2 = max * scale * log2(e) +
// log2(max(l, 1e-30)) and D; pass 2 recomputes S, computes dP = dO V^T,
// P = exp2(S scale log2(e) - lse2) and dS = P (dP - D) in registers, and
// adds dS K (dS rounded to bf16) to dQ.  Every consumer of a block walks
// the block's keys; a tile past its own rows' keys is masked to zero.
template <int DP>
__device__ __forceinline__ void dq_consume(const Args& a, const Work& wk,
                                           int w, const CUtensorMap* mdq,
                                           uint8_t* smem, uint32_t base,
                                           int n_kv, int b) {
  using P = DqPlan<DP>;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, quad = lane % 4;
  const int row = 16 * (tid / 32) + lane / 4;   // this thread's rows: +0, +8
  const uint32_t bars = base + P::kBars;
  const uint32_t sq = base + w * P::kTile;
  const uint32_t sdo = base + P::kDO + w * P::kTile;
  auto full = [&](int i) { return bars + 8 * (i % P::kStages); };
  auto parity = [](int i) { return (uint32_t)(i / P::kStages) & 1; };
  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(bars + 8 * (P::kStages + i % P::kStages));
  };
  auto k_tile = [&](int i) {
    return base + P::kK + (i % P::kStages) * P::kTile;
  };
  auto v_tile = [&](int i) {
    return base + P::kV + (i % P::kStages) * P::kTile;
  };

  if (!wk.active) {                          // keep the ring turning
    for (int i = 0; i < 2 * n_kv; ++i) {
      mbar_wait(full(i), parity(i));
      release(i);
    }
    return;
  }
  float* sd = reinterpret_cast<float*>(smem + P::kD + w * 256);
  rows_d(a, b, wk.hq, wk.t0, sd);
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
  const float dd[2] = {sd[row], sd[row + 8]};
  const int t_first = wk.t0 + row;              // rows t_first, t_first + 8
  mbar_wait(bars + 8 * (2 * P::kStages + w), 0);

  // Pass 1: the rows' max (in score units) and this lane's share of l.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32];
  for (int i = 0; i < n_kv; ++i) {
    const int k0 = i * kRows;
    mbar_wait(full(i), parity(i));
    wg_fence();
    issue_nt<DP>(s, sq, k_tile(i));
    wg_commit();
    wg_wait<0>();
    pin(s);
    release(i);
    if (!dense(a, wk.t0, k0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!visible(a, t_first + 8 * h, k0 + 8 * j + 2 * quad + e))
              s[4 * j + 2 * h + e] = -INFINITY;
    }
    float t[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[h][j] = fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
    tree_max<4>(t);
    float m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float row_max = t[h][0];
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m[h], row_max);
      m_safe[h] = isfinite(m_new) ? m_new * a.scale_log2 : 0.f;
      const float corr =
          isfinite(m[h]) ? ex2(m[h] * a.scale_log2 - m_safe[h]) : 0.f;
      l[h] *= corr;
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        t[h][j] = ex2(fmaf(s[4 * j + 2 * h], a.scale_log2, -m_safe[h])) +
                  ex2(fmaf(s[4 * j + 2 * h + 1], a.scale_log2, -m_safe[h]));
    tree_sum<4>(t);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] += t[h][0];
  }
  float lse[2];
  float* stats = stats_of(a, b, wk.hq, wk.t0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lse[h] = (isfinite(m[h]) ? m[h] * a.scale_log2 : 0.f) +
             log2f(fmaxf(l[h], 1e-30f));
    if (quad == 0) {
      stats[row + 8 * h] = lse[h];
      stats[kRows + row + 8 * h] = dd[h];
    }
  }

  // Pass 2: dQ += dS K.
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float dp[32];
  uint32_t ds[4][4];
  for (int i = 0; i < n_kv; ++i) {
    const int it = n_kv + i, k0 = i * kRows;
    mbar_wait(full(it), parity(it));
    wg_fence();
    issue_nt<DP>(s, sq, k_tile(it));
    issue_nt<DP>(dp, sdo, v_tile(it));
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    if (!dense(a, wk.t0, k0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!visible(a, t_first + 8 * h, k0 + 8 * j + 2 * quad + e))
              s[4 * j + 2 * h + e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e;
          const float p = ex2(fmaf(s[x], a.scale_log2, -lse[h]));
          s[x] = p * (dp[x] - dd[h]);
        }
    pack(s, ds);
    wg_fence();
    issue_rs<DP>(dq, ds, k_tile(it));
    wg_commit();
    wg_wait<0>();
    pin(dq);
    release(it);
  }

  // dQ * scale, rounded, into this warpgroup's Q tile in the swizzled
  // layout (16-byte chunk c of row r at chunk c ^ (r % 8)), then one TMA
  // store a panel, which clips rows past T.
  uint8_t* so = smem + w * P::kTile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int off = (j / 8) * kPanel + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
                      quad * 4;
      *reinterpret_cast<uint32_t*>(so + off) = pack_bf16(
          dq[4 * j + 2 * h] * a.scale, dq[4 * j + 2 * h + 1] * a.scale);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
  if (tid == 0) {
    for (int p = 0; p < a.panels; ++p)
      tma_store(mdq, sq + p * kPanel, p * 64, wk.t0, wk.hq, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int DP>
__global__ void __launch_bounds__(DqPlan<DP>::kThreads, 1)
flash_attention_bwd_dq_tc(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const __grid_constant__ CUtensorMap mdq,
                          const Args a) {
  using P = DqPlan<DP>;
  constexpr int NC = P::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + P::kBars;

  // Blocks run (kv head, batch) fastest and the units' blocks from the
  // last (the longest causal rows) to the first.
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
  const int n_kv = (kv_end + kRows - 1) / kRows;

  zero_padding<DP>(smem, P::kTiles, a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), NC);
    }
    for (int w = 0; w < NC; ++w) mbar_init(bars + 8 * (2 * P::kStages + w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(kProducerRegs));
    if (threadIdx.x == 0)
      dq_produce<DP>(&mq, &mk, &mv, &mdo, work, a, base, n_kv, hk, b);
  } else {
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(kConsumerRegs));
    dq_consume<DP>(a, work[wg - 1], wg - 1, &mdq, smem, base, n_kv, b);
  }
}

template <int DP>
__global__ void __launch_bounds__(KvPlan<DP>::kThreads, 1)
flash_attention_bwd_dkdv_tc(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const __grid_constant__ CUtensorMap mdo,
                            const __grid_constant__ CUtensorMap mdk,
                            const __grid_constant__ CUtensorMap mdv,
                            const Args a) {
  using P = KvPlan<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + P::kBars;
  const uint32_t kv_bar = bars + 8 * 2 * P::kStages;

  // Blocks run (kv head, batch) fastest and key blocks from position 0
  // (seen by the most query tiles) on.
  const int bh = (int)(blockIdx.x % a.heads);
  const int s0 = (int)(blockIdx.x / a.heads) * P::kKeys;
  const int hk = bh % a.Hkv, b = bh / a.Hkv;
  // The first query tile that may see a key of the block, and the items:
  // (query head of the group, query tile) pairs, head by head.
  int t_begin = 0;
  if (a.causal && s0 >= a.prefix_len)
    t_begin = max(0, s0 - a.q_offset) / kRows * kRows;
  const int n_t = s0 < a.kv_valid ? max(0, a.q_tiles - t_begin / kRows) : 0;
  const int n_items = a.group * n_t;

  zero_padding<DP>(smem, P::kTiles, a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), P::kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // K and V tiles wholly past S are not loaded: no key of theirs is
      // visible and their stores are skipped.
      const uint32_t panel_bytes = a.panels * kPanel;
      const int k_tiles = min(P::kKTiles, (a.S - s0 + kRows - 1) / kRows);
      mbar_expect_tx(kv_bar, 2 * k_tiles * panel_bytes);
      for (int kt = 0; kt < k_tiles; ++kt)
        for (int p = 0; p < a.panels; ++p) {
          tma_load(base + kt * P::kTile + p * kPanel, &mk, kv_bar, p * 64,
                   s0 + kt * kRows, hk, b);
          tma_load(base + P::kV + kt * P::kTile + p * kPanel, &mv, kv_bar,
                   p * 64, s0 + kt * kRows, hk, b);
        }
      for (int i = 0; i < n_items; ++i) {
        const int s = i % P::kStages, use = i / P::kStages;
        if (use > 0) mbar_wait(bars + 8 * (P::kStages + s), (use - 1) & 1);
        const int hq = hk * a.group + i / n_t;
        const int t0 = t_begin + (i % n_t) * kRows;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * panel_bytes + kStatBytes);
        for (int p = 0; p < a.panels; ++p) {
          tma_load(base + P::kQ + s * P::kTile + p * kPanel, &mq, full,
                   p * 64, t0, hq, b);
          tma_load(base + P::kDO + s * P::kTile + p * kPanel, &mdo, full,
                   p * 64, t0, hq, b);
        }
        bulk_load(base + P::kStats + s * kStatBytes, stats_of(a, b, hq, t0),
                  kStatBytes, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    // A consumer: dV += P^T dO and dK += dS^T Q over its keys and columns,
    // with S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T and dS^T
    // in registers (rounded to bf16 as the A operands).
    constexpr int NCOL = P::kCols;
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, quad = lane % 4;
    const int row = 16 * (tid / 32) + lane / 4;  // this thread's keys: +0, +8
    const int kt = P::kSplit == 1 ? w : 0;
    const int c0 = P::kSplit == 1 ? 0 : w * NCOL;
    const int key0 = s0 + kt * kRows;
    const uint32_t sk = base + kt * P::kTile;
    const uint32_t sv = base + P::kV + kt * P::kTile;
    float dk[NCOL / 2], dv[NCOL / 2];
#pragma unroll
    for (int i = 0; i < NCOL / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[4][4], dsa[4][4];
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_items; ++i) {
      const int s = i % P::kStages;
      const int t0 = t_begin + (i % n_t) * kRows;
      const uint32_t sq = base + P::kQ + s * P::kTile;
      const uint32_t sdo = base + P::kDO + s * P::kTile;
      const float* sst =
          reinterpret_cast<const float*>(smem + P::kStats + s * kStatBytes);
      mbar_wait(bars + 8 * s, (uint32_t)(i / P::kStages) & 1);
      wg_fence();
      issue_nt<DP>(st, sk, sq);
      issue_nt<DP>(dpt, sv, sdo);
      wg_commit();
      wg_wait<0>();
      pin(st);
      pin(dpt);
      const bool all = dense(a, t0, key0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tq = 8 * j + 2 * quad;        // queries tq, tq + 1
        const float2 lse = *reinterpret_cast<const float2*>(sst + tq);
        const float2 dd = *reinterpret_cast<const float2*>(sst + kRows + tq);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * h + e;
            float sx = st[x];
            if (!all && !visible(a, t0 + tq + e, key0 + row + 8 * h))
              sx = -INFINITY;
            const float p = ex2(fmaf(sx, a.scale_log2, e ? -lse.y : -lse.x));
            st[x] = p;
            dpt[x] = p * (dpt[x] - (e ? dd.y : dd.x));
          }
      }
      pack(st, pa);
      pack(dpt, dsa);
      wg_fence();
      issue_rs<NCOL>(dv, pa, sdo + (c0 / 64) * kPanel);
      issue_rs<NCOL>(dk, dsa, sq + (c0 / 64) * kPanel);
      wg_commit();
      wg_wait<0>();
      pin(dv);
      pin(dk);
      if (tid == 0) mbar_arrive(bars + 8 * (P::kStages + s));
    }

    // dK * scale and dV, rounded, into the K and V tiles' panels of this
    // consumer's columns once both consumers are done reading them, then
    // one TMA store a panel (clipping keys past S).
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    uint8_t* so_k = smem + kt * P::kTile;
    uint8_t* so_v = smem + P::kV + kt * P::kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
#pragma unroll
      for (int j = 0; j < NCOL / 8; ++j) {
        const int cj = c0 / 8 + j;              // 8-column chunk of the tile
        const int off = (cj / 8) * kPanel + r * 128 +
                        (((cj % 8) ^ (r % 8)) * 16) + quad * 4;
        *reinterpret_cast<uint32_t*>(so_k + off) = pack_bf16(
            dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(so_v + off) =
            pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
    if (tid == 0 && key0 < a.S) {
      for (int p = c0 / 64; p < (c0 + NCOL) / 64 && p < a.panels; ++p) {
        tma_store(&mdk, sk + p * kPanel, p * 64, key0, hk, b);
        tma_store(&mdv, sv + p * kPanel, p * 64, key0, hk, b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
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
// strides are st = (batch, token, head), in 64 x 64 x 1 x 1 boxes.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
            const int64_t* st, int batch, int tokens, int heads, int dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)tokens,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// maps: q, k, v, dout, dq, dk, dv.
template <int DP>
int launch(const CUtensorMap (&maps)[7], Args a, int B, int S,
           cudaStream_t stream) {
  using PQ = DqPlan<DP>;
  using PK = KvPlan<DP>;
  a.blocks = (a.units + PQ::kConsumers - 1) / PQ::kConsumers;
  const int64_t blocks_q = (int64_t)a.blocks * a.heads;
  const int64_t blocks_k = (int64_t)((S + PK::kKeys - 1) / PK::kKeys) *
                           a.heads;
  if (blocks_q > 0x7fffffff || blocks_k > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_tc<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, PQ::kAlloc);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_tc<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PK::kAlloc);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq_tc<DP><<<(unsigned)blocks_q, PQ::kThreads,
                                  PQ::kAlloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dkdv_tc<DP><<<(unsigned)blocks_k, PK::kThreads,
                                    PK::kAlloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[5], maps[6], a);
  return (int)cudaGetLastError();
}

// The operands route 1 takes: bf16, dh a multiple of 16 in [16, 256],
// 16-byte aligned bases and positive strides that are multiples of 8
// elements (16 bytes, as TMA and the 16-byte loads of o and dO need).
int run(int dtype, const void* q, const void* k, const void* v,
        const void* o, const void* dout, void* dq, void* dk, void* dv,
        float* stats, const int64_t* strides, int B, int T, int S, int Hq,
        int Hkv, int dh, int causal, int prefix_len, int kv_valid,
        int q_offset, float scale, cudaStream_t stream) {
  if (dtype != 1 || dh % 16 || dh < 16 || dh > 256)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] <= 0 || strides[3 * i + j] % 8)
        return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(stats) % 16)
    return (int)cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int64_t q_tiles = ((int64_t)T + kRows - 1) / kRows;
  const int64_t units = q_tiles * group;
  const int64_t heads = (int64_t)B * Hkv;
  if (units > 0x7fffffff || heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[7] = {};
  if (!encode(enc, &maps[0], q, strides, B, T, Hq, dh) ||
      !encode(enc, &maps[1], k, strides + 3, B, S, Hkv, dh) ||
      !encode(enc, &maps[2], v, strides + 6, B, S, Hkv, dh) ||
      !encode(enc, &maps[3], dout, strides + 12, B, T, Hq, dh) ||
      !encode(enc, &maps[4], dq, strides + 15, B, T, Hq, dh) ||
      !encode(enc, &maps[5], dk, strides + 18, B, S, Hkv, dh) ||
      !encode(enc, &maps[6], dv, strides + 21, B, S, Hkv, dh))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.stats = stats;
  for (int i = 0; i < 3; ++i) {
    a.os[i] = strides[9 + i];
    a.dos[i] = strides[12 + i];
  }
  a.T = T;
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.group = group;
  a.dh = dh;
  a.panels = (dh + 63) / 64;
  a.q_tiles = (int)q_tiles;
  a.units = (int)units;
  a.heads = (int)heads;
  a.causal = causal;
  a.prefix_len = prefix_len;
  a.kv_valid = kv_valid;
  a.q_offset = q_offset;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  if (dh <= 64) return launch<64>(maps, a, B, S, stream);
  if (dh <= 128) return launch<128>(maps, a, B, S, stream);
  return launch<256>(maps, a, B, S, stream);
}

}  // namespace tc
}  // namespace

extern "C" int flash_attention_bwd_max_head_dim(void) { return kMaxHeadDim; }

// Launches route 0 (scalar) or 1 (tensor cores), the dq kernel then the
// dkdv kernel, on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for arguments the route does not take; nothing
// is launched then.  dtype: 0 float32, 1 bfloat16.  strides: 24 element
// strides, (batch, token, head) of q, k, v, o, dO, dq, dk and dv; the head
// dim is contiguous in all eight.  stats: float32 scratch of 3 * B * Hq *
// round_up(T, 64), 16-byte aligned.  kv_valid is in [0, S]; Hq is a
// multiple of Hkv; 1 <= dh <= 256; B, Hq at most 65,535; T and S at least
// 1.
extern "C" int flash_attention_bwd(int route, int dtype, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout, void* dq,
                                   void* dk, void* dv, float* stats,
                                   const int64_t* strides, int B, int T,
                                   int S, int Hq, int Hkv, int dh, int causal,
                                   int prefix_len, int kv_valid, int q_offset,
                                   float scale, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || Hkv < 1 || Hq < 1 || Hq % Hkv ||
      B < 1 || B > 65535 || Hq > 65535 || T < 1 || S < 1 || kv_valid < 0 ||
      kv_valid > S || (dtype != 0 && dtype != 1) ||
      (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return tc::run(dtype, q, k, v, o, dout, dq, dk, dv, stats, strides, B, T,
                   S, Hq, Hkv, dh, causal, prefix_len, kv_valid, q_offset,
                   scale, st);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = stats;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.dos[i] = strides[12 + i];
    a.dqs[i] = strides[15 + i];
    a.dks[i] = strides[18 + i];
    a.dvs[i] = strides[21 + i];
  }
  a.B = B;
  a.T = T;
  a.S = S;
  a.Hq = Hq;
  a.group = Hq / Hkv;
  a.dh = dh;
  a.causal = causal;
  a.prefix_len = prefix_len;
  a.kv_valid = kv_valid;
  a.q_offset = q_offset;
  a.scale = scale;
  return dtype == 0 ? dispatch<float>(a, Hkv, st)
                    : dispatch<__nv_bfloat16>(a, Hkv, st);
}
