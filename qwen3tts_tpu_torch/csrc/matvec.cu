// Weight-streaming matrix-vector products at batch 1.
//
// Replaces the Pallas kernels of benchmarks/matvec_probe.py:
//
//   matvec     (pallas_mv)     out[1, N] = T(x[1, K] @ W[K, N]), float32 sums
//   matvec_kt  (pallas_mv_kt)  out[N, 1] = f32(T(sum_k T(W_t[n, k] * x[k])))
//
// T is bfloat16 or float32 (x and W of one type).  matvec_kt keeps the
// Pallas body's rounding: each product is rounded to T (jnp's product of
// two T arrays), the row sum is taken in float32 and rounded to T, and the
// output is float32.
//
// Bound: bytes.  Both read the K x N weights once and do 2 operations per
// weight element: at the probe's default (K 1024, N 65536, bf16) that is
// 128 MB, 40 us at 3.35 TB/s.
//
// Design.  The TPU kernels' bn / bm tiles (full-K column blocks of W, row
// blocks of W_t) do not carry over; the tiling here is chosen for 132 SMs:
//
//   * matvec: one CTA per tile of kCols output columns over the whole K
//     (gemv.cuh tile_dot, 8 rows' 16-byte loads in flight per thread), with
//     8-column tiles while that gives fewer than 16 CTAs per SM (N = 4096:
//     512 CTAs) and 32-column tiles beyond (N = 65536: 2048 CTAs).
//   * matvec_kt: each warp takes kKtRows rows of W_t; its lanes walk the
//     row in 16-byte chunks, a batch of chunks of every row in flight at
//     once, then sum with shuffles.  N = 4096 gives 256 CTAs.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (qwen3tts_tpu_torch/ops/matvec.py).

#include "gemv.cuh"

namespace {

using gemv::kThreads;
using gemv::kWarps;

constexpr int kMaxK = 8192;  // longest x kept in shared memory (matvec)
constexpr int kKtRows = 2;   // rows of W_t per warp (matvec_kt)
constexpr int kKtBatch = 4;  // 16-byte chunks in flight per row and lane (matvec_kt)

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int K,
              int N) {
  __shared__ float a_s[kMaxK];
  __shared__ float red[kWarps * kCols];
  __shared__ float res[kCols];
  for (int k = threadIdx.x; k < K; k += kThreads) a_s[k] = gemv::to_f(x[k]);
  __syncthreads();
  const int col0 = blockIdx.x * kCols;
  gemv::tile_dot<T, kCols, 1>(a_s, K, w, N, {col0}, red, res);
  if (threadIdx.x < kCols) gemv::put(out + col0 + threadIdx.x, res[threadIdx.x]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_kt_kernel(const T* __restrict__ x, const T* __restrict__ wt, float* __restrict__ out,
                 int K, int N) {
  constexpr int V = gemv::kVec<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + warp) * kKtRows;
  const int chunks = K / V;
  float acc[kKtRows];
#pragma unroll
  for (int r = 0; r < kKtRows; ++r) acc[r] = 0.f;
  for (int c0 = lane; c0 < chunks; c0 += 32 * kKtBatch) {
    uint4 xr[kKtBatch], raw[kKtRows][kKtBatch];
#pragma unroll
    for (int u = 0; u < kKtBatch; ++u) {
      const int c = c0 + 32 * u;
      if (c < chunks) {
        xr[u] = gemv::ld16(x + (size_t)c * V);
#pragma unroll
        for (int r = 0; r < kKtRows; ++r)
          if (row0 + r < N) raw[r][u] = gemv::ld16(wt + (size_t)(row0 + r) * K + (size_t)c * V);
      }
    }
#pragma unroll
    for (int u = 0; u < kKtBatch; ++u) {
      if (c0 + 32 * u >= chunks) break;
      float xv[V];
      gemv::cvt16(xr[u], T(), xv);
#pragma unroll
      for (int r = 0; r < kKtRows; ++r) {
        if (row0 + r >= N) continue;
        float wv[V];
        gemv::cvt16(raw[r][u], T(), wv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r] += gemv::rnd<T>(__fmul_rn(wv[v], xv[v]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kKtRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    if (lane == 0 && row0 + r < N) out[row0 + r] = gemv::rnd<T>(acc[r]);
  }
}

template <typename T>
cudaError_t matvec(const void* x, const void* w, void* out, int K, int N, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (N / 8 < 16 * 132 || N % 32 != 0)
    matvec_kernel<T, 8><<<N / 8, kThreads, 0, st>>>(xt, wt, o, K, N);
  else
    matvec_kernel<T, 32><<<N / 32, kThreads, 0, st>>>(xt, wt, o, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t matvec_kt(const void* x, const void* wt, float* out, int K, int N, cudaStream_t st) {
  const int rows_per_cta = kWarps * kKtRows;
  matvec_kt_kernel<T><<<(N + rows_per_cta - 1) / rows_per_cta, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), out, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (x, W and, for matvec, out): 0 = bfloat16, 1 = float32.  Returns
// the launch's cudaError_t (0 on success); cudaErrorInvalidValue for a
// shape without an instance: matvec needs 1 <= K <= 8192 and N % 8 == 0,
// matvec_kt needs K a multiple of 8 (bf16) or 4 (float32).
int qwen3tts_matvec(int dtype, const void* x, const void* w, void* out, int K, int N,
                    void* stream) {
  if (K < 1 || K > kMaxK || N < 8 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)matvec<__nv_bfloat16>(x, w, out, K, N, st);
  if (dtype == 1) return (int)matvec<float>(x, w, out, K, N, st);
  return (int)cudaErrorInvalidValue;
}

int qwen3tts_matvec_kt(int dtype, const void* x, const void* wt, void* out, int K, int N,
                       void* stream) {
  const int vec = dtype == 0 ? 8 : 4;
  if (K < vec || K % vec != 0 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return (int)matvec_kt<__nv_bfloat16>(x, wt, o, K, N, st);
  if (dtype == 1) return (int)matvec_kt<float>(x, wt, o, K, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
