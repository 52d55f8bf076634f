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
// 128 MB, 40 us at 3.35 TB/s; at the talker's qkv shape (1024 x 4096) 8 MB,
// 2.5 us.
//
// Design.  The TPU kernels' bn / bm tiles (full-K column blocks of W, row
// blocks of W_t) do not carry over; the tiling here is chosen for 132 SMs:
//
//   * matvec: a CTA owns a column tile of 32 x kVec<T> columns (256 in bf16,
//     128 in float32) and a slice of K.  A warp reads one 512-byte segment
//     of a row at a time, 16 bytes a lane, so every 32-byte sector it
//     fetches is its own; it takes kRows consecutive rows a batch, their
//     loads all in flight before it converts any, and x for the batch in
//     one or two 16-byte loads.  The 8 warps of a CTA take interleaved
//     batches of the slice.  Nothing is staged in shared memory but the
//     8 KB of the warps' partial sums, so residency is set by registers
//     (80 a thread: 3 CTAs per SM).  Where N / 256 column tiles are too few
//     to fill the card (N 4096 gives 16), K is split across CTAs too
//     (ops/matvec.py:matvec_splits: the most splits that keep the grid
//     within one wave, 16 at N 4096, 1 at N 65536).  A column tile's splits
//     run as one thread block cluster: after a cluster barrier each CTA sums
//     its share of the tile's columns over the splits' shared memory
//     (distributed shared memory), in split order.  No atomic touches a sum
//     and the order never changes, so two runs give the same bits, and there
//     is no workspace.  The first split-K design (8 warps on every 8th
//     row, two K splits at N 65536, a float32 workspace merged by the last
//     CTA to take an atomic ticket) ran 2 waves at N 65536 (512 CTAs, 3
//     resident a SM); consecutive rows per warp and one wave took N 65536
//     from 52.6 to 45.5 us on the H100 (chip_smoke.py), beside 43.7 us for
//     a plain read of the same 134 MB (tools/kernel_probe.py).
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (qwen3tts_tpu_torch/ops/matvec.py).

#include <cooperative_groups.h>

#include "gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using gemv::kThreads;
using gemv::kWarps;

constexpr int kMaxK = 8192;  // longest x the wrapper accepts (matvec)
constexpr int kMaxSplits = 16;  // K splits of matvec: CTAs of a cluster (non-portable 16)
constexpr int kRows = 8;     // rows in flight per lane (matvec): whole 16-byte loads of x
constexpr int kKtRows = 2;   // rows of W_t per warp (matvec_kt)
constexpr int kKtBatch = 4;  // 16-byte chunks in flight per row and lane (matvec_kt)

// 16 bytes of W: read once, through the read-only path, not kept in L1.
__device__ __forceinline__ uint4 ld_w(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Grid (ceil(N / kTile), splits), clusters of (1, splits): column tile
// blockIdx.x, rows [blockIdx.y * kc, min(K, (blockIdx.y + 1) * kc)) with kc =
// ceil(K / splits) rounded up to whole batches of kRows rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int K,
              int N) {
  constexpr int V = gemv::kVec<T>;
  constexpr int kTile = 32 * V;  // columns of one warp load: 512 bytes
  __shared__ float red[kWarps][kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int splits = gridDim.y;
  const int tile0 = blockIdx.x * kTile;
  const int col = tile0 + lane * V;
  const int kc = ((K + splits - 1) / splits + kRows - 1) / kRows * kRows;
  const int k_begin = blockIdx.y * kc;
  const int k_end = min(K, k_begin + kc);
  const T* wc = w + col;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if (col < N) {  // the ragged edge of N (N % 8 == 0: whole loads)
    for (int k0 = k_begin + warp * kRows; k0 < k_end; k0 += kWarps * kRows) {
      uint4 raw[kRows];
      float xv[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (k0 + u < k_end) raw[u] = ld_w(wc + (size_t)(k0 + u) * N);
      if (k0 + kRows <= k_end) {  // x[k0 .. k0 + kRows): whole 16-byte loads (k0 % kRows == 0)
#pragma unroll
        for (int j = 0; j < kRows / V; ++j)
          gemv::cvt16(__ldg(reinterpret_cast<const uint4*>(x + k0) + j), T(), xv + j * V);
      } else {
#pragma unroll
        for (int u = 0; u < kRows; ++u) xv[u] = k0 + u < k_end ? ldg_f(x + k0 + u) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (k0 + u >= k_end) break;
        float wv[V];
        gemv::cvt16(raw[u], T(), wv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(xv[u], wv[v], acc[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) red[warp][lane * V + v] = acc[v];
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][c];
    if (splits == 1) {
      if (tile0 + c < N) gemv::put(out + tile0 + c, s);
    } else {
      red[0][c] = s;  // only this thread reads column c
    }
  }
  if (splits == 1) return;

  // The K splits of this column tile form one cluster: after the barrier,
  // CTA r sums columns [r * per, (r + 1) * per) of the tile over the splits'
  // shared memory, in split order; the second barrier keeps each CTA's
  // shared memory alive until its peers have read it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = kTile / splits;
  for (int c = (int)cluster.block_rank() * per + threadIdx.x;
       c < ((int)cluster.block_rank() + 1) * per && tile0 + c < N; c += kThreads) {
    float v[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      v[j] = j < splits ? cluster.map_shared_rank(&red[0][0], j)[c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < splits) s += v[j];
    gemv::put(out + tile0 + c, s);
  }
  cluster.sync();
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
cudaError_t matvec(const void* x, const void* w, void* out, int K, int N, int splits,
                   cudaStream_t st) {
  static bool non_portable = false;  // clusters above 8 CTAs, once per instance
  if (splits > 8 && !non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        matvec_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  constexpr int kTile = 32 * gemv::kVec<T>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTile - 1) / kTile, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, matvec_kernel<T>, static_cast<const T*>(x),
                            static_cast<const T*>(w), static_cast<T*>(out), K, N);
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
// matvec_kt needs K a multiple of 8 (bf16) or 4 (float32).  matvec splits K
// over `splits` (1 to 16, a power of 2) CTAs per column tile, launched as
// one cluster.
int qwen3tts_matvec(int dtype, const void* x, const void* w, void* out, int K, int N,
                    int splits, void* stream) {
  if (K < 1 || K > kMaxK || N < 8 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) || splits > K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)matvec<__nv_bfloat16>(x, w, out, K, N, splits, st);
  if (dtype == 1) return (int)matvec<float>(x, w, out, K, N, splits, st);
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
