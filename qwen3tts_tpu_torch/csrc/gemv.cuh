// Column-tile matrix-vector product for batch 1 (matvec.cu).
//
// One CTA of kThreads threads computes kCols consecutive output columns of
// a @ W over the whole depth K (W row-major [K, N], a float row in shared
// memory): no atomics, and a fixed summation order, so two runs give the
// same bits.  Each thread reads 16 bytes of a row at a time (8 bf16 or 4
// float32 columns) and puts kBatch rows' raw loads in flight before it
// converts any: at batch 1 latency, not bytes, bounds a CTA.  The row
// groups of a warp are summed with shuffles, the warps through shared
// memory in warp order.  Products are of the row's value and the weight in
// float32 (a bf16 weight converts exactly) with fmaf accumulation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // rows' loads in flight per thread

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// elements of T in one 16-byte load
template <typename T> constexpr int kVec = 16 / sizeof(T);

__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

// the kVec<T> values of a 16-byte load, as float
__device__ __forceinline__ void cvt16(const uint4& r, __nv_bfloat16, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void cvt16(const uint4& r, float, float* o) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}

// For each of kT column tiles t:
//   res[t * kCols + c] = sum_{k < K} a_s[k] * W[k][col0[t] + c],  c < kCols.
// The kT tiles stream in one pass, so their loads are in flight together.
// Needs N % kCols == 0, col0[t] + kCols <= N, and W 16-byte aligned with N
// a multiple of kVec<T>.  red holds kWarps * kT * kCols floats.  Ends with
// a __syncthreads: res is ready to read.
template <typename T, int kCols, int kT>
__device__ void tile_dot(const float* a_s, int K, const T* __restrict__ w, int N,
                         const int (&col0)[kT], float* red, float* res) {
  constexpr int V = kVec<T>;
  constexpr int LPR = kCols / V;        // threads per weight row
  constexpr int RPP = kThreads / LPR;   // rows per pass of the CTA
  static_assert(kCols % V == 0 && 32 % LPR == 0, "column tile must fill whole loads");
  const int tid = threadIdx.x;
  const int cgi = tid % LPR;
  float acc[kT][V];
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
  for (int k0 = tid / LPR; k0 < K; k0 += kBatch * RPP) {
    uint4 raw[kT][kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * RPP;
#pragma unroll
      for (int t = 0; t < kT; ++t)
        if (k < K) raw[t][u] = ld16(w + (size_t)k * N + col0[t] + cgi * V);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * RPP;
      if (k < K) {
        const float a = a_s[k];
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          float wv[V];
          cvt16(raw[t][u], T(), wv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[t][v] = fmaf(a, wv[v], acc[t][v]);
        }
      }
    }
  }
  // the row groups of a warp differ in the lane bits above log2(LPR)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[t][v] += __shfl_xor_sync(0xffffffffu, acc[t][v], off);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < LPR) {
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) red[(warp * kT + t) * kCols + lane * V + v] = acc[t][v];
  }
  __syncthreads();
  if (tid < kT * kCols) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * kT * kCols + tid];
    res[tid] = s;
  }
  __syncthreads();
}

}  // namespace gemv
