// The backward of the causal (+ prefix-LM) flash attention of
// flash_attention.cu, for Hopper (sm_90a): float32 and bfloat16 inputs.
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
// key give zero gradients.  Scores, statistics and accumulators are float32;
// P is not rounded to the input type (the gradient of the float32
// function; the reference's bf16 cast of P before P.V rounds its cotangent,
// which the tolerances carry).
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
// Design: float32 FMAs, no tensor cores, no atomics, so every launch gives
// the same bits (the training step's bit-exact resume relies on it).  Two
// kernels on one stream:
// 1. dq: one block of 256 threads per (64-query tile, query head, batch
//    row).  Pass 1 runs the forward's online max and denominator over the
//    tile's key range (the forward's causal end, min(kv_valid, max(last
//    query position + 1, prefix_len))) and D from o and dO; it writes m, 1/l
//    and D per row to a float32 scratch (3, B, Hq, T).  Pass 2 walks the keys
//    again: V's tile gives dP = dO V^T, K's tile (in the same buffer) gives
//    S, P and dS, which goes to shared memory, and dQ += dS K stays in
//    registers.  Each thread owns a 4 x 4 score tile (rows ty + 16 i, keys
//    tx + 16 j) and 4 rows x dh/16 columns of dQ.
// 2. dkdv: one block per (key tile, kv head, batch row); the key tile is 64
//    keys up to dh 128 and 32 above (shared memory).  K and V stay staged;
//    the block loops over the group's query heads, then over the query
//    tiles that may see a key of the tile (from the first one when causal
//    and the tile starts at or past prefix_len), staging Q, dO and the rows'
//    statistics, computing S^T and dP^T (each thread 4 or 2 keys x 4
//    queries), P and dS to shared memory, then dV += P^T dO and dK += dS^T Q
//    in registers (keys x dh/16 columns each).
// Rows are padded to dh + 1 floats so 16 lanes reading 16 rows hit 16
// banks.  Shared memory: dq 4 (3 * 64 (dh + 1) + 64 * 65) bytes (115,712 at
// dh 128, 214,016 at dh 256); dkdv 4 ((2 KB + 128) (dh + 1) + 2 KB * 65 +
// 192) bytes (166,144 at dh 128, 214,784 at dh 256 with KB = 32).  Its times
// beside the bound are in PERF.md.
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

extern "C" int flash_attention_bwd_max_head_dim(void) { return kMaxHeadDim; }

// Launches the two kernels on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments they do not take; nothing
// is launched then.  dtype: 0 float32, 1 bfloat16.  strides: 24 element
// strides, (batch, token, head) of q, k, v, o, dO, dq, dk and dv; the head
// dim is contiguous in all eight.  stats: float32 scratch of 3 * B * Hq * T.
// kv_valid is in [0, S]; Hq is a multiple of Hkv; 1 <= dh <= 256; B, Hq at
// most 65,535; T and S at least 1.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* stats,
                                   const int64_t* strides, int B, int T,
                                   int S, int Hq, int Hkv, int dh, int causal,
                                   int prefix_len, int kv_valid, int q_offset,
                                   float scale, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || Hkv < 1 || Hq < 1 || Hq % Hkv ||
      B < 1 || B > 65535 || Hq > 65535 || T < 1 || S < 1 || kv_valid < 0 ||
      kv_valid > S || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(a, Hkv, st)
                    : dispatch<__nv_bfloat16>(a, Hkv, st);
}
