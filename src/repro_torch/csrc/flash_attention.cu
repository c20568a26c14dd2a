// Causal (+ prefix-LM) flash attention for Hopper (sm_90a), float32 and
// bfloat16 inputs, float32 arithmetic.
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
// layers.py:177-178 does (the Pallas kernel keeps them in float32).  The
// Pallas kernel's causal block skip (flash_attention.py:41) ignores
// prefix_len and is off by 0.82 at prefix_len 96 with 64-row blocks; here
// a kv tile is skipped only if its first key is past the tile's last query
// AND at or past prefix_len, so the loop ends at
// min(kv_valid, max(last query position + 1, prefix_len)).
//
// Bound: operations.  At qwen3-1.7b's prefill (B 4, T = S = 2048, 16 query
// heads over 8 kv heads, dh 128, causal, bf16) the work is 4 dh flops per
// visible (query, key) pair, 68.7 GFLOP, 0.0695 ms at the tensor cores'
// 989 TFLOP/s, against 100 MB of q, k, v and out, 0.03 ms at 3.35 TB/s.
//
// Design: simple and right; it does not use the tensor cores (mma.sync or
// wgmma, TMA and a kv-sharing GQA layout are a later performance change).
// One block of 256 threads per (64-query tile, query head, batch row).  The
// q tile is staged once in shared memory as float32; each 64-key tile of K
// is staged, the 64 x 64 scores are computed with every thread owning a
// 4 x 4 register tile (rows ty + 16 i, keys tx + 16 j), the row max and sum
// are reduced across the 16 lanes that share a row with xor shuffles, the
// rounded probabilities go to shared memory, and then the V tile replaces
// the K tile in the same buffer for P.V, each thread owning 4 rows x dh/16
// output columns in registers.  Rows are padded to dh + 1 floats so the 16
// lanes that read 16 different keys hit 16 different banks.  Shared memory
// is 4 (2 * 64 (dh + 1) + 64 * 65) bytes: 82,688 at dh 128 (two blocks per
// SM), 148,224 at dh 256.
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

extern "C" int flash_attention_max_head_dim(void) { return kMaxHeadDim; }

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.  dtype: 0
// float32, 1 bfloat16.  strides: 12 element strides, (batch, token, head)
// of q, k, v and out; the head dim is contiguous in all four.  kv_valid is
// in [0, S]; Hq is a multiple of Hkv; 1 <= dh <= 256; B and Hq at most
// 65,535 (the grid's z and y axes).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out,
                               const int64_t* strides, int B, int T, int S,
                               int Hq, int Hkv, int dh, int causal,
                               int prefix_len, int kv_valid, int q_offset,
                               float scale, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || Hkv < 1 || Hq % Hkv || B > 65535 ||
      Hq > 65535 || kv_valid < 0 || kv_valid > S || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || Hq == 0) return 0;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(a, B, T, Hq, st)
                    : dispatch<__nv_bfloat16>(a, B, T, Hq, st);
}
