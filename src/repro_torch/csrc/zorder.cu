// Z-order (Morton) keys for Hopper (sm_90a), in two lanes from one template.
//
// key[i] = OR over b < bits, j < m of
//            bit b of code(v[i, j]) << (b * m + j)      (positions < width)
// code(v) = trunc(clamp((v - lo[j]) / max(hi[j] - lo[j], 1e-12), 0, 1)
//                 * (2^bits - 1))
//
// Replaces the TPU kernel src/repro/kernels/zorder/zorder.py:37-61
// (_kernel behind zorder_keys_pallas).  That kernel quantizes in float32 and
// takes m * bits <= 32 only, so the layout generator, whose keys are 16 bits
// of 3 columns in float64 into uint64, never called it.  This source has two
// entry points over one kernel template:
//
//   (a) zorder_keys32: the TPU kernel's function.  A contiguous (N, m)
//       float32 array, float32 arithmetic, m * bits <= 32, uint32 keys.
//   (b) zorder_keys64: the layout generator's function (core/zorder.py).
//       m columns of an (N, C) float64 table read in place through its row
//       stride and m column indices (no (N, m) copy of the table is made),
//       float64 arithmetic, 16 bits per column, 64-bit keys; bits that would
//       land at positions >= 64 are dropped, as numpy's uint64 shift drops
//       them.  The key is written with bit 63 flipped, so signed int64 order
//       is the unsigned order and torch.searchsorted can route by it.
//
// Both write int64 keys.  Each step is one IEEE operation rounded to nearest
// (__fsub_rn/__fdiv_rn/__fmul_rn and the __d* forms), so nvcc's --fmad=true
// cannot contract the subtract and the multiply of a neighbouring step, then
// the code is truncated toward zero as numpy's and XLA's astype do.  The span
// keeps the reference's 1e-12 floor and the quotient its [0, 1] clamp: a
// full table routed with a sample's lo/hi has values outside that range.
//
// Bound: bytes.  It reads m values and writes one int64 per row: lane (a)
// at the bench shape (1,000,000 x 3, bits 10) moves 20,000,000 bytes, 5.97
// us at 3.35 TB/s; lane (b) over a 59,986,052-row table moves at least
// 1,919,553,664 bytes (three float64 columns and the key), 0.573 ms.  A
// strided read of 3 of 32 columns touches a 32-byte sector per value, so
// the bytes the card really moves are up to 4x that floor.
//
// Design: simple and right.  One thread per row, grid-stride with 64-bit
// indices.  The column loop is unrolled for m = 1..4 (compile-time M), the
// bit loop for up to 16 bits; other m (up to kMaxCols) run the same loops
// with a runtime count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 32;
constexpr int kMaxBits = 16;
constexpr int64_t kMaxBlocks = 1 << 20;

struct Cols {
  int64_t c[kMaxCols];
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

// M > 0: m is M at compile time; M == 0: m is m_rt (<= kMaxCols).
template <typename F, int M>
__global__ void __launch_bounds__(kThreads)
zorder_kernel(const F* __restrict__ vals, int64_t row_stride, Cols cols,
              const F* __restrict__ lo, const F* __restrict__ hi,
              int64_t* __restrict__ out, int64_t n, int m_rt, int bits,
              int width, uint64_t flip) {
  const int m = M > 0 ? M : m_rt;
  const F top = (F)((1u << bits) - 1u);
  const F floor_span = (F)1e-12;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const F* row = vals + i * row_stride;
    uint64_t key = 0;
#pragma unroll
    for (int j = 0; j < (M > 0 ? M : kMaxCols); ++j) {
      if (M == 0 && j >= m) break;
      const F l = lo[j];
      F span = sub_rn(hi[j], l);
      span = span < floor_span ? floor_span : span;
      F q = div_rn(sub_rn(row[cols.c[j]], l), span);
      q = q < (F)0 ? (F)0 : (q > (F)1 ? (F)1 : q);
      const uint64_t code = (uint64_t)mul_rn(q, top);
#pragma unroll
      for (int b = 0; b < kMaxBits; ++b) {
        if (b >= bits) break;
        const int pos = b * m + j;
        if (pos < width) key |= ((code >> b) & 1ull) << pos;
      }
    }
    out[i] = (int64_t)(key ^ flip);
  }
}

template <typename F>
int launch(const F* vals, int64_t row_stride, const Cols& cols, const F* lo,
           const F* hi, int64_t* out, int64_t n, int m, int bits, int width,
           uint64_t flip, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  switch (m) {
    case 1:
      zorder_kernel<F, 1><<<grid, kThreads, 0, stream>>>(
          vals, row_stride, cols, lo, hi, out, n, m, bits, width, flip);
      break;
    case 2:
      zorder_kernel<F, 2><<<grid, kThreads, 0, stream>>>(
          vals, row_stride, cols, lo, hi, out, n, m, bits, width, flip);
      break;
    case 3:
      zorder_kernel<F, 3><<<grid, kThreads, 0, stream>>>(
          vals, row_stride, cols, lo, hi, out, n, m, bits, width, flip);
      break;
    case 4:
      zorder_kernel<F, 4><<<grid, kThreads, 0, stream>>>(
          vals, row_stride, cols, lo, hi, out, n, m, bits, width, flip);
      break;
    default:
      zorder_kernel<F, 0><<<grid, kThreads, 0, stream>>>(
          vals, row_stride, cols, lo, hi, out, n, m, bits, width, flip);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The most columns one key interleaves.
extern "C" int zorder_max_columns(void) { return kMaxCols; }

// Lane (a).  `vals` is (n, m) contiguous float32, `lo`/`hi` are (m,) float32
// on the device, `out` is (n,) int64.  n >= 1, 1 <= m, 1 <= bits <= 16,
// m * bits <= 32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int zorder_keys32(const float* vals, const float* lo,
                             const float* hi, int64_t* out, int64_t n, int m,
                             int bits, void* stream) {
  Cols cols;
  for (int j = 0; j < kMaxCols; ++j) cols.c[j] = j;
  return launch<float>(vals, m, cols, lo, hi, out, n, m, bits, 32, 0ull,
                       (cudaStream_t)stream);
}

// Lane (b).  `table` is (n, C) float64 with unit column stride and row
// stride `row_stride`; `cols` (host, m entries) are its columns to key;
// `lo`/`hi` are (m,) float64 on the device, `out` is (n,) int64 receiving
// the keys with bit 63 flipped.  n >= 1, 1 <= m <= zorder_max_columns().
extern "C" int zorder_keys64(const double* table, int64_t row_stride,
                             const int64_t* cols, const double* lo,
                             const double* hi, int64_t* out, int64_t n,
                             int m, void* stream) {
  Cols c;
  for (int j = 0; j < kMaxCols; ++j) c.c[j] = j < m ? cols[j] : 0;
  return launch<double>(table, row_stride, c, lo, hi, out, n, m, kMaxBits,
                        64, 1ull << 63, (cudaStream_t)stream);
}
