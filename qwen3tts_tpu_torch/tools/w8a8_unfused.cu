// The w8a8 pair of the port's first w8a8 design, kept for a comparison:
// quantize_act_kernel writes the int8 activation rows to device memory and
// w8a8_gemv_kernel reads them back, with byte-wise multiply-adds.  The
// shipped design (csrc/w8a8.cu) fuses the quantize into the GEMV and uses
// int8 dot instructions.  Only tools/kernel_probe.py (`w8a8`) builds this
// file; no wrapper of the package calls it.  The C entry points carry an
// `unfused` prefix so that they never shadow the shipped library's.
//
//   quantize_act_kernel  xs[m]    = max(max_k |f32(x[m, k])|, 1e-8) / 127
//                        xq[m, k] = int8(clamp(rint(f32(x[m, k]) / xs[m]), -127, 127))
//   w8a8_gemv_kernel     out[m, n] = T((f32(sum_k xq[m, k] * q8[k, n]) * xs[m]) * scale[n])
//
// x and out are bfloat16 or float32 (T), q8 int8 row-major [K, N], scale
// float32 [N], xs float32 [M]; the same bits as csrc/w8a8.cu.
//
// Design.  A CTA of 256 threads owns a column tile of 32 x V columns (one
// warp row read: V bytes a lane, V = 16, 8 or 4) and a slice of K.  A lane
// keeps MT x V int32 sums (MT = M rounded up to a power of 2, MT * V <= 64
// registers); the 8 warps take interleaved batches of 8 rows, all 8 rows'
// loads in flight before any is used.  The slice's activations are staged
// in shared memory 512 rows at a time, transposed to [row][m].  Each
// product is a byte-wise multiply-add.  The warps' sums meet in shared
// memory by int32 atomics.  Where the column tiles are too few to fill the
// SMs, K is split across up to 16 CTAs of one thread block cluster; after a
// cluster barrier each CTA sums its share of the tile over the splits'
// shared memory and writes it through the epilogue.
// Its geometry (tools/kernel_probe.py:unfused_geometry): mt = M rounded up to a
// power of 2; vec the widest of 16, 8, 4 with mt * vec <= 64 that divides N
// and gives at least one CTA an SM at 16 splits; splits the most, a power
// of 2, that keep the grid within two CTAs an SM, each split >= 64 rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // weight rows in flight per lane
constexpr int kChunk = 512;     // activation rows staged in shared memory at a time
constexpr int kMaxRows = 16;    // rows of the GEMV
constexpr int kMaxSplits = 16;  // K splits: CTAs of a cluster (non-portable 16)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// byte b of w, sign-extended
__device__ __forceinline__ int sbyte(uint32_t w, int b) {
  return static_cast<int>(w << (24 - 8 * b)) >> 24;
}

// V bytes of the weight: read once, through the read-only path, not kept in L1.
template <int V>
__device__ __forceinline__ void ld_w(const int8_t* p, uint32_t* r) {
  if constexpr (V == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "l"(p));
  } else if constexpr (V == 8) {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "l"(p));
  } else {
    static_assert(V == 4, "a lane reads 16, 8 or 4 bytes of a row");
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r[0]) : "l"(p));
  }
}

// the MT activations of one staged row, sign-extended
template <int MT>
__device__ __forceinline__ void ld_acts(const int8_t* p, int* a) {
  if constexpr (MT >= 4) {
#pragma unroll
    for (int j = 0; j < MT / 4; ++j) {
      const uint32_t wd = reinterpret_cast<const uint32_t*>(p)[j];
#pragma unroll
      for (int b = 0; b < 4; ++b) a[4 * j + b] = sbyte(wd, b);
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) a[m] = p[m];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                    int K) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* row = x + (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(to_f(row[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) amax = fmaxf(amax, red[i]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  int8_t* q = xq + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(to_f(row[k]), s)), -127.f), 127.f);
    q[k] = static_cast<int8_t>(static_cast<int>(v));
  }
}

// Grid (ceil(N / (32 V)), splits), clusters of (1, splits): column tile
// blockIdx.x, rows [blockIdx.y * kc, min(K, (blockIdx.y + 1) * kc)) with kc =
// ceil(K / splits) rounded up to whole batches of kRows rows.  Needs N % V
// == 0, q8 16-byte aligned, M <= MT.
template <typename T, int MT, int V>
__global__ void __launch_bounds__(kThreads)
w8a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 T* __restrict__ out, int M, int K, int N) {
  constexpr int kTile = 32 * V;     // columns of the CTA
  constexpr int kAcc = MT * kTile;  // the CTA's int32 sums, [m][column]
  constexpr int kWords = V / 4;     // 32-bit words of a lane's row segment
  static_assert(MT * V <= 64, "a lane keeps MT x V int32 sums");
  __shared__ int red[kAcc];
  __shared__ __align__(16) int8_t a_s[kChunk * MT];  // staged activations, [row][m]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int splits = gridDim.y;
  const int tile0 = blockIdx.x * kTile;
  const int col = tile0 + lane * V;
  const int kc = ((K + splits - 1) / splits + kRows - 1) / kRows * kRows;
  const int k_begin = blockIdx.y * kc;
  const int k_end = min(K, k_begin + kc);

  for (int i = tid; i < kAcc; i += kThreads) red[i] = 0;
  int acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0;

  for (int c0 = k_begin; c0 < k_end; c0 += kChunk) {
    const int rows = min(kChunk, k_end - c0);
    __syncthreads();  // the previous chunk's activations are read
    for (int i = tid; i < rows * MT; i += kThreads) {
      const int m = i / rows, r = i - m * rows;
      a_s[r * MT + m] = m < M ? xq[(size_t)m * K + c0 + r] : 0;
    }
    __syncthreads();
    if (col < N) {
      for (int r0 = warp * kRows; r0 < rows; r0 += kWarps * kRows) {
        uint32_t raw[kRows][kWords];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (r0 + u < rows) ld_w<V>(w + (size_t)(c0 + r0 + u) * N + col, raw[u]);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r0 + u >= rows) break;
          int a[MT];
          ld_acts<MT>(a_s + (r0 + u) * MT, a);
#pragma unroll
          for (int j = 0; j < kWords; ++j)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int wv = sbyte(raw[u][j], b);
#pragma unroll
              for (int m = 0; m < MT; ++m) acc[m][4 * j + b] += a[m] * wv;
            }
        }
      }
    }
  }
  if (col < N) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) atomicAdd(&red[m * kTile + lane * V + v], acc[m][v]);
  }
  __syncthreads();

  auto store = [&](int i, int s) {
    const int m = i / kTile, n = tile0 + i % kTile;
    if (m < M && n < N)
      put(out + (size_t)m * N + n, __fmul_rn(__fmul_rn(__int2float_rn(s), xs[m]), scale[n]));
  };
  if (splits == 1) {
    for (int i = tid; i < kAcc; i += kThreads) store(i, red[i]);
    return;
  }
  // The K splits of this column tile form one cluster: after the barrier,
  // CTA r sums entries [r * per, (r + 1) * per) of the tile over the splits'
  // shared memory; the second barrier keeps each CTA's shared memory alive
  // until its peers have read it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = kAcc / splits;
  const int r = (int)cluster.block_rank();
  for (int i = r * per + tid; i < (r + 1) * per; i += kThreads) {
    int s = 0;
    for (int j = 0; j < splits; ++j) s += cluster.map_shared_rank(red, j)[i];
    store(i, s);
  }
  cluster.sync();
}

template <typename T>
cudaError_t quantize_act(const void* x, void* xq, void* xs, int M, int K, cudaStream_t st) {
  quantize_act_kernel<T><<<M, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                 static_cast<int8_t*>(xq),
                                                 static_cast<float*>(xs), K);
  return cudaGetLastError();
}

template <typename T, int MT, int V>
cudaError_t gemv(const void* xq, const void* xs, const void* w, const void* scale, void* out,
                 int M, int K, int N, int splits, cudaStream_t st) {
  static bool non_portable = false;  // clusters above 8 CTAs, once per instance
  if (splits > 8 && !non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_gemv_kernel<T, MT, V>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 32 * V - 1) / (32 * V), splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8a8_gemv_kernel<T, MT, V>, static_cast<const int8_t*>(xq),
                            static_cast<const float*>(xs), static_cast<const int8_t*>(w),
                            static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
}

template <typename T>
cudaError_t gemv_dispatch(int mt, int vec, const void* xq, const void* xs, const void* w,
                          const void* scale, void* out, int M, int K, int N, int splits,
                          cudaStream_t st) {
#define QWEN3TTS_GEMV(MT_, V_) \
  if (mt == MT_ && vec == V_) return gemv<T, MT_, V_>(xq, xs, w, scale, out, M, K, N, splits, st)
  QWEN3TTS_GEMV(1, 16);
  QWEN3TTS_GEMV(1, 8);
  QWEN3TTS_GEMV(1, 4);
  QWEN3TTS_GEMV(2, 16);
  QWEN3TTS_GEMV(2, 8);
  QWEN3TTS_GEMV(2, 4);
  QWEN3TTS_GEMV(4, 16);
  QWEN3TTS_GEMV(4, 8);
  QWEN3TTS_GEMV(4, 4);
  QWEN3TTS_GEMV(8, 8);
  QWEN3TTS_GEMV(8, 4);
  QWEN3TTS_GEMV(16, 4);
#undef QWEN3TTS_GEMV
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (x, and out of the GEMV): 0 = bfloat16, 1 = float32.  Each returns
// the launch's cudaError_t (0 on success), cudaErrorInvalidValue for a shape
// without an instance.

// x [M, K] -> xq int8 [M, K], xs float32 [M]: one CTA a row.
int qwen3tts_unfused_quantize_act(int dtype, const void* x, void* xq, void* xs, int M, int K,
                          void* stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)quantize_act<__nv_bfloat16>(x, xq, xs, M, K, st);
  if (dtype == 1) return (int)quantize_act<float>(x, xq, xs, M, K, st);
  return (int)cudaErrorInvalidValue;
}

// xq int8 [M, K], xs float32 [M], w int8 [K, N], scale float32 [N] -> out
// [M, N].  mt: M rounded up to a power of 2 (at most 16); vec: bytes a lane
// reads of a row (16, 8 or 4; mt * vec <= 64; N % vec == 0); K split over
// `splits` (1 to 16, a power of 2) CTAs per column tile, one cluster.
int qwen3tts_unfused_w8a8_gemv(int dtype, const void* xq, const void* xs, const void* w,
                       const void* scale, void* out, int M, int K, int N, int mt, int vec,
                       int splits, void* stream) {
  if (M < 1 || M > mt || mt > kMaxRows || K < 1 || N < 1 || N % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) || splits > K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)gemv_dispatch<__nv_bfloat16>(mt, vec, xq, xs, w, scale, out, M, K, N, splits,
                                             st);
  if (dtype == 1)
    return (int)gemv_dispatch<float>(mt, vec, xq, xs, w, scale, out, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
