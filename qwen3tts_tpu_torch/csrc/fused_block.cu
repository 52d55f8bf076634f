// Fused weight-streaming halves of a decoder block, for decode-shaped
// activations (B <= 32 rows).
//
// Replaces the Pallas kernels of qwen3tts_tpu/ops/fused_block.py:
//
//   fused_norm_matmul (_norm_mm_kernel)
//       out = T(T(rms_norm_f32(x) * w_norm) @ W)                 (qkv half)
//   fused_o_mlp (_o_mlp_kernel)
//       x2  = f32(x) + attn @ Wo                     kept in float32
//       h   = T(rms_norm_f32(x2) * w_norm)
//       [g u] = h @ Wgu;  act = T(silu(g) * u)
//       out = T(x2 + act @ Wd)                                   (o + MLP half)
//
// T is the activation dtype (bfloat16 or float32).  Every product is of two
// values of T (or of T and a dequantized weight) and is accumulated in
// float32.  An int8 weight {q, scale} is dequantized per element as
// T(f32(q) * scale[col]), which is what the Pallas kernels' _tile does.
//
// Bound: bytes.  At B = 1 each call streams its weight matrices once and
// does 2 FLOPs per weight element (2B at batch B): far below the card's
// ridge point.  The 0.6B talker's qkv weight is 8 MB in bf16 (4 MB in int8)
// and its o + MLP weights 23 MB; the activations are a few KB.
//
// Design.  The card's grid has no order, so what the Pallas kernels carry
// from one grid step to the next becomes separate launches:
//
//   * A column tile of kCols = 32 output columns per CTA: 256 threads, 4
//     per weight row, each reading 8 consecutive columns (16 bytes of bf16,
//     8 of int8) of every 64th row.  Latency, not bytes, bounds a CTA at
//     batch 1, so a thread puts the raw loads of a batch of 8 rows (4 in
//     float32) in flight before it converts any, and the gate and up tiles of the
//     MLP stream in one pass.  The 8 row groups of a warp are summed with
//     shuffles and the 8 warps through shared memory, in a fixed order.
//     The talker's N = 4096 gives 128 CTAs.
//   * Each CTA recomputes the RMS norm of its (at most 2048-wide) activation
//     rows into shared memory, as the Pallas kernel does per grid step, with
//     the whole block summing the squares.  Rows are taken kBC at a time (1
//     at batch 1, else 4).
//   * fused_o_mlp is three launches on the stream, with a float32 workspace
//     the wrapper allocates once per shape:
//       1. o-projection partial sums, column tiles x KS row splits of Dq
//          (KS chosen so the grid has >= 128 CTAs), into part1[KS, B, H];
//       2. one CTA per 32-wide tile of the intermediate size: it rebuilds
//          x2 = f32(x) + sum_ks part1 (fixed order) and its norm, computes
//          its 32 gate and 32 up columns, the activation, and the tile's
//          partial down projection act_tile @ Wd[tile, :] into part2[t, B, H]
//          (the tile's 32 rows of Wd split among all 256 threads);
//       3. out = T(x2 + sum_t part2), summed in tile order.
//     No float atomics: two runs on the same inputs give the same bits.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (qwen3tts_tpu_torch/ops/fused_block.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                        // columns per thread
constexpr int kCols = 32;                      // columns per CTA
constexpr int kTPR = kCols / kVec;             // threads per weight row
constexpr int kRowsPerPass = kThreads / kTPR;  // 64
constexpr int kMaxK = 2048;                    // longest activation row in shared memory

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 8 consecutive weight elements, loaded raw (16 bytes of bf16, 32 of float,
// 8 of int8) so that a thread can put a batch of loads in flight before it
// converts any, then converted to float: plain, or int8 dequantized as
// T(f32(q) * scale).
template <typename W> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 v; };
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<int8_t> { uint2 v; };

// rows' loads in flight per thread: a batch of raw loads is 32-128 registers
template <typename W> constexpr int kBatch = sizeof(W) == 4 ? 4 : 8;

__device__ __forceinline__ Raw8<__nv_bfloat16> ld8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Raw8<float> ld8(const float* p) {
  return {*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ Raw8<int8_t> ld8(const int8_t* p) {
  return {*reinterpret_cast<const uint2*>(p)};
}

template <typename T>
__device__ __forceinline__ void cvt8(const Raw8<__nv_bfloat16>& r, const float*, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void cvt8(const Raw8<float>& r, const float*, float* o) {
  o[0] = r.a.x; o[1] = r.a.y; o[2] = r.a.z; o[3] = r.a.w;
  o[4] = r.b.x; o[5] = r.b.y; o[6] = r.b.z; o[7] = r.b.w;
}
template <typename T>
__device__ __forceinline__ void cvt8(const Raw8<int8_t>& r, const float* sc, float* o) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&r.v);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = rnd<T>(static_cast<float>(q[i]) * sc[i]);
}

template <typename W>
__device__ __forceinline__ void load_scales(const float* wscale, int c, float* sc) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if constexpr (sizeof(W) == 1) {
      sc[i] = wscale[c + i];
    } else {
      sc[i] = 1.f;
    }
  }
}

// For each of kT column tiles t (columns col0[t] .. col0[t] + kCols of W):
//   res[t][bc][cc] = sum_{k in [k_lo, k_hi)} a_s[bc * a_stride + k] * W[k][col0[t] + cc]
// for the kBC activation rows in shared memory.  The kT tiles are streamed
// in one pass, so their loads are in flight together.  Columns >= N give 0.
// red holds kWarps * kT * kBC * kCols floats.  Ends with a __syncthreads:
// res is ready to read.
template <typename T, typename W, int kBC, int kT>
__device__ void gemv_tiles(const float* a_s, int a_stride, const W* __restrict__ w,
                           const float* __restrict__ wscale, int N, const int (&col0)[kT],
                           int k_lo, int k_hi, float* red, float* res) {
  constexpr int U = kBatch<W>;
  const int tid = threadIdx.x;
  const int cg = tid % kTPR;
  const int rg = tid / kTPR;
  int c[kT];
  bool live[kT];  // N % 8 == 0: a thread's 8 columns are all in or all out
  float sc[kT][kVec];
  float acc[kT][kBC][kVec];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    c[t] = col0[t] + cg * kVec;
    live[t] = c[t] < N;
    load_scales<W>(wscale, live[t] ? c[t] : 0, sc[t]);
#pragma unroll
    for (int bc = 0; bc < kBC; ++bc)
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[t][bc][v] = 0.f;
  }
  for (int k0 = k_lo + rg; k0 < k_hi; k0 += U * kRowsPerPass) {
    Raw8<W> raw[kT][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kRowsPerPass;
#pragma unroll
      for (int t = 0; t < kT; ++t)
        if (k < k_hi && live[t]) raw[t][u] = ld8(w + (size_t)k * N + c[t]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kRowsPerPass;
      if (k >= k_hi) break;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (!live[t]) continue;
        float wv[kVec];
        cvt8<T>(raw[t][u], sc[t], wv);
#pragma unroll
        for (int bc = 0; bc < kBC; ++bc) {
          const float a = a_s[bc * a_stride + k];
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[t][bc][v] = fmaf(a, wv[v], acc[t][bc][v]);
        }
      }
    }
  }
  // the 8 row groups of a warp differ in lane bits 2..4
#pragma unroll
  for (int off = kTPR; off < 32; off <<= 1)
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int bc = 0; bc < kBC; ++bc)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          acc[t][bc][v] += __shfl_xor_sync(0xffffffffu, acc[t][bc][v], off);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kTPR) {
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int bc = 0; bc < kBC; ++bc)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          red[((warp * kT + t) * kBC + bc) * kCols + lane * kVec + v] = acc[t][bc][v];
  }
  __syncthreads();
  for (int i = tid; i < kT * kBC * kCols; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * kT * kBC * kCols + i];
    res[i] = s;
  }
  __syncthreads();
}

// In place: a_s[bc][k] = T((a_s[bc][k] * rsqrt(mean_k a_s[bc]^2 + eps)) * f32(nw[k])).
// The sums of squares use the whole block: per thread, then per warp, then
// the warps in order.
template <typename T, int kBC>
__device__ void rms_norm_rows(float* a_s, int H, const T* __restrict__ nw, float eps,
                              float* red, float* rstd_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int bc = 0; bc < kBC; ++bc) {
    float ss = 0.f;
    for (int k = tid; k < H; k += kThreads) {
      const float v = a_s[bc * H + k];
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[bc * kWarps + warp] = ss;
  }
  __syncthreads();
  if (tid < kBC) {
    float ss = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) ss += red[tid * kWarps + wi];
    rstd_s[tid] = rsqrtf(ss / (float)H + eps);
  }
  __syncthreads();
  for (int i = tid; i < kBC * H; i += kThreads) {
    const int bc = i / H, k = i % H;
    a_s[i] = rnd<T>((a_s[i] * rstd_s[bc]) * to_f(nw[k]));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B. fused_norm_matmul: grid (ceil(N / kCols)), one launch.
template <typename T, typename W, int kBC>
__global__ void __launch_bounds__(kThreads)
norm_matmul_kernel(const T* __restrict__ x, const T* __restrict__ nw, const W* __restrict__ w,
                   const float* __restrict__ wscale, T* __restrict__ out, int B, int H, int N,
                   float eps) {
  __shared__ float a_s[kBC * kMaxK];
  __shared__ float red[kWarps * kBC * kCols];
  __shared__ float res[kBC * kCols];
  __shared__ float rstd_s[kBC];
  const int col0 = blockIdx.x * kCols;
  for (int b0 = 0; b0 < B; b0 += kBC) {
    for (int i = threadIdx.x; i < kBC * H; i += kThreads) {
      const int b = b0 + i / H;
      a_s[i] = b < B ? to_f(x[(size_t)b * H + i % H]) : 0.f;
    }
    __syncthreads();
    rms_norm_rows<T, kBC>(a_s, H, nw, eps, red, rstd_s);
    gemv_tiles<T, W, kBC, 1>(a_s, H, w, wscale, N, {col0}, 0, H, red, res);
    for (int i = threadIdx.x; i < kBC * kCols; i += kThreads) {
      const int b = b0 + i / kCols, n = col0 + i % kCols;
      if (b < B && n < N) put(out + (size_t)b * N + n, res[i]);
    }
    __syncthreads();  // a_s and res are rewritten by the next row chunk
  }
}

// ---------------------------------------------------------------------------
// C1. o-projection partial sums: grid (ceil(H / kCols), KS).
template <typename T, typename W, int kBC>
__global__ void __launch_bounds__(kThreads)
o_proj_kernel(const T* __restrict__ attn, const W* __restrict__ wo,
              const float* __restrict__ wo_scale, float* __restrict__ part1, int B, int Dq,
              int H, int k_chunk) {
  __shared__ float a_s[kBC * kMaxK];
  __shared__ float red[kWarps * kBC * kCols];
  __shared__ float res[kBC * kCols];
  const int col0 = blockIdx.x * kCols;
  const int ks = blockIdx.y;
  const int k_lo = ks * k_chunk;
  const int k_hi = min(Dq, k_lo + k_chunk);
  for (int b0 = 0; b0 < B; b0 += kBC) {
    for (int i = threadIdx.x; i < kBC * Dq; i += kThreads) {
      const int b = b0 + i / Dq, k = i % Dq;
      if (k >= k_lo && k < k_hi) a_s[i] = b < B ? to_f(attn[(size_t)b * Dq + k]) : 0.f;
    }
    __syncthreads();
    gemv_tiles<T, W, kBC, 1>(a_s, Dq, wo, wo_scale, H, {col0}, k_lo, k_hi, red, res);
    for (int i = threadIdx.x; i < kBC * kCols; i += kThreads) {
      const int b = b0 + i / kCols, n = col0 + i % kCols;
      if (b < B && n < H) part1[((size_t)ks * B + b) * H + n] = res[i];
    }
    __syncthreads();
  }
}

// x2 = f32(x) + sum_ks part1[ks], the partials summed in order: the same
// arithmetic in C2 and C3, so both see the same bits.
template <typename T>
__device__ __forceinline__ float residual_x2(const T* __restrict__ x,
                                            const float* __restrict__ part1, int KS,
                                            size_t BH, size_t i) {
  float s = 0.f;
  for (int ks = 0; ks < KS; ++ks) s += part1[ks * BH + i];
  return to_f(x[i]) + s;
}

// C2. one CTA per kCols-wide tile t of the intermediate size: norm of x2,
// gate/up columns (streamed in one pass), activation, and the tile's partial
// down projection.
template <typename T, typename W, int kBC>
__global__ void __launch_bounds__(kThreads)
mlp_tile_kernel(const T* __restrict__ x, const float* __restrict__ part1, int KS,
                const T* __restrict__ nw, const W* __restrict__ gu,
                const float* __restrict__ gu_scale, const W* __restrict__ wd,
                const float* __restrict__ wd_scale, float* __restrict__ part2, int B, int H,
                int I, float eps) {
  constexpr int U = kBatch<W>;
  __shared__ float a_s[kBC * kMaxK];
  __shared__ float red[kWarps * 2 * kBC * kCols];
  __shared__ float gu_s[2 * kBC * kCols];  // [gate | up][bc][cc]
  __shared__ float act_s[kBC * kCols];
  __shared__ float rstd_s[kBC];
  const int t = blockIdx.x;
  const int i0 = t * kCols;
  const size_t BH = (size_t)B * H;
  // the down tile: kCols rows of Wd split RS ways so that every thread
  // streams (H <= kMaxK, so H / 8 <= kThreads column groups)
  const int n_cg = H / kVec;
  const int RS = min(kThreads / n_cg, kCols);
  const int cgi = threadIdx.x % n_cg, rs = threadIdx.x / n_cg;
  for (int b0 = 0; b0 < B; b0 += kBC) {
    for (int i = threadIdx.x; i < kBC * H; i += kThreads) {
      const int b = b0 + i / H;
      a_s[i] = b < B ? residual_x2(x, part1, KS, BH, (size_t)b * H + i % H) : 0.f;
    }
    __syncthreads();
    rms_norm_rows<T, kBC>(a_s, H, nw, eps, red, rstd_s);
    gemv_tiles<T, W, kBC, 2>(a_s, H, gu, gu_scale, 2 * I, {i0, I + i0}, 0, H, red, gu_s);
    for (int i = threadIdx.x; i < kBC * kCols; i += kThreads) {
      const float g = gu_s[i];
      act_s[i] = rnd<T>(g * (1.f / (1.f + expf(-g))) * gu_s[kBC * kCols + i]);
    }
    __syncthreads();
    // part2[t, b, n] = sum_{c < kCols} act[b][c] * Wd[i0 + c][n]; each thread
    // takes 8 columns of its share of the rows, and the RS partial sums meet
    // in shared memory (a_s is free again), added in order
    if (rs < RS) {
      const int n = cgi * kVec;
      const int r_lo = rs * kCols / RS, r_hi = (rs + 1) * kCols / RS;
      float sc[kVec];
      load_scales<W>(wd_scale, n, sc);
      float acc[kBC][kVec];
#pragma unroll
      for (int bc = 0; bc < kBC; ++bc)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[bc][v] = 0.f;
      for (int r0 = r_lo; r0 < r_hi; r0 += U) {
        Raw8<W> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (r0 + u < r_hi) raw[u] = ld8(wd + (size_t)(i0 + r0 + u) * H + n);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r0 + u >= r_hi) break;
          float wv[kVec];
          cvt8<T>(raw[u], sc, wv);
#pragma unroll
          for (int bc = 0; bc < kBC; ++bc) {
            const float a = act_s[bc * kCols + r0 + u];
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[bc][v] = fmaf(a, wv[v], acc[bc][v]);
          }
        }
      }
#pragma unroll
      for (int bc = 0; bc < kBC; ++bc)
#pragma unroll
        for (int v = 0; v < kVec; ++v) a_s[(rs * kBC + bc) * H + n + v] = acc[bc][v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBC * H; i += kThreads) {
      const int bc = i / H, n = i % H, b = b0 + bc;
      if (b < B) {
        float sum = 0.f;
        for (int r = 0; r < RS; ++r) sum += a_s[(r * kBC + bc) * H + n];
        part2[(size_t)t * BH + (size_t)b * H + n] = sum;
      }
    }
    __syncthreads();
  }
}

// C3. out = T(x2 + sum_t part2[t]), the tiles summed in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
o_mlp_final_kernel(const T* __restrict__ x, const float* __restrict__ part1, int KS,
                   const float* __restrict__ part2, int NT, T* __restrict__ out, int B, int H) {
  const size_t BH = (size_t)B * H;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= BH) return;
  float acc = 0.f;
  for (int t = 0; t < NT; ++t) acc += part2[t * BH + i];
  put(out + i, residual_x2(x, part1, KS, BH, i) + acc);
}

template <typename T, typename W, int kBC>
cudaError_t norm_matmul(const void* x, const void* nw, const void* w, const void* wscale,
                        void* out, int B, int H, int N, float eps, cudaStream_t st) {
  norm_matmul_kernel<T, W, kBC><<<(N + kCols - 1) / kCols, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<const W*>(w),
      static_cast<const float*>(wscale), static_cast<T*>(out), B, H, N, eps);
  return cudaGetLastError();
}

template <typename T, typename W, int kBC>
cudaError_t o_mlp(const void* x, const void* attn, const void* wo, const void* wo_scale,
                  const void* nw, const void* gu, const void* gu_scale, const void* wd,
                  const void* wd_scale, void* out, float* part1, float* part2, int B, int H,
                  int Dq, int I, int KS, int k_chunk, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  o_proj_kernel<T, W, kBC><<<dim3((H + kCols - 1) / kCols, KS), kThreads, 0, st>>>(
      static_cast<const T*>(attn), static_cast<const W*>(wo),
      static_cast<const float*>(wo_scale), part1, B, Dq, H, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int NT = I / kCols;
  mlp_tile_kernel<T, W, kBC><<<NT, kThreads, 0, st>>>(
      xt, part1, KS, static_cast<const T*>(nw), static_cast<const W*>(gu),
      static_cast<const float*>(gu_scale), static_cast<const W*>(wd),
      static_cast<const float*>(wd_scale), part2, B, H, I, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t BH = (size_t)B * H;
  o_mlp_final_kernel<T><<<(unsigned)((BH + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      xt, part1, KS, part2, NT, static_cast<T*>(out), B, H);
  return cudaGetLastError();
}

bool shape_ok(int B, int K, int N) {
  return B >= 1 && K >= 1 && K <= kMaxK && N >= kVec && N % kVec == 0;
}

}  // namespace

extern "C" {

// dtype (x, norm weight, out, and a plain W): 0 = bfloat16, 1 = float32.
// w_int8: 1 = W is int8 with f32 per-column scales.  Returns the launch's
// cudaError_t (0 on success); cudaErrorInvalidValue for a shape without an
// instance.
int qwen3tts_fused_norm_matmul(int dtype, int w_int8, const void* x, const void* nw,
                               const void* w, const void* wscale, void* out, int B, int H,
                               int N, float eps, void* stream) {
  if (!shape_ok(B, H, N) || (w_int8 && wscale == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QWEN3TTS_NM(T, W)                                                          \
  return (int)(B == 1 ? norm_matmul<T, W, 1>(x, nw, w, wscale, out, B, H, N, eps, st) \
                      : norm_matmul<T, W, 4>(x, nw, w, wscale, out, B, H, N, eps, st))
  if (dtype == 0 && !w_int8) QWEN3TTS_NM(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && w_int8) QWEN3TTS_NM(__nv_bfloat16, int8_t);
  if (dtype == 1 && !w_int8) QWEN3TTS_NM(float, float);
  if (dtype == 1 && w_int8) QWEN3TTS_NM(float, int8_t);
#undef QWEN3TTS_NM
  return (int)cudaErrorInvalidValue;
}

// part1: f32 [KS, B, H]; part2: f32 [I / 32, B, H].  Needs I % 32 == 0 and
// KS * k_chunk >= Dq.
int qwen3tts_fused_o_mlp(int dtype, int w_int8, const void* x, const void* attn,
                         const void* wo, const void* wo_scale, const void* nw, const void* gu,
                         const void* gu_scale, const void* wd, const void* wd_scale, void* out,
                         void* part1, void* part2, int B, int H, int Dq, int I, int KS,
                         int k_chunk, float eps, void* stream) {
  if (!shape_ok(B, Dq, H) || !shape_ok(B, H, 2 * I) || I % kCols != 0 || KS < 1 ||
      (long long)KS * k_chunk < Dq ||
      (w_int8 && (wo_scale == nullptr || gu_scale == nullptr || wd_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p1 = static_cast<float*>(part1);
  float* p2 = static_cast<float*>(part2);
#define QWEN3TTS_OM(T, W)                                                                 \
  return (int)(B == 1 ? o_mlp<T, W, 1>(x, attn, wo, wo_scale, nw, gu, gu_scale, wd, wd_scale, \
                                       out, p1, p2, B, H, Dq, I, KS, k_chunk, eps, st)      \
                      : o_mlp<T, W, 4>(x, attn, wo, wo_scale, nw, gu, gu_scale, wd, wd_scale, \
                                       out, p1, p2, B, H, Dq, I, KS, k_chunk, eps, st))
  if (dtype == 0 && !w_int8) QWEN3TTS_OM(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && w_int8) QWEN3TTS_OM(__nv_bfloat16, int8_t);
  if (dtype == 1 && !w_int8) QWEN3TTS_OM(float, float);
  if (dtype == 1 && w_int8) QWEN3TTS_OM(float, int8_t);
#undef QWEN3TTS_OM
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
