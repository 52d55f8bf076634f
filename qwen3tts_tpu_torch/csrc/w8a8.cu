// Int8 x int8 products at decode shapes, for the w8a8 modes.
//
// The JAX package's w8a8 mode (qwen3tts_tpu/ops/quant.py:68-85,
// quantize_act and w8a8_matmul) quantizes each activation row to int8 and
// multiplies it by an int8 weight in XLA (dot_general at
// preferred_element_type=int32); no Pallas kernel computes it.  Every
// decode-time product has M = B <= 16 rows (the talker step, the
// predictor's micro-steps, its 2-token prefill at B <= 8); PyTorch's only
// int8 GEMM, torch._int_mm, takes more than 16.  So the mode has a kernel of
// its own for M <= 16, which quantizes and multiplies in one launch:
//
//   fused_w8a8_gemv_kernel  xs[m]     = max(max_k |f32(x[m, k])|, 1e-8) / 127
//                           xq[m, k]  = int8(clamp(rint(f32(x[m, k]) / xs[m]), -127, 127))
//                           out[m, n] = T((f32(sum_k xq[m, k] * q8[k, n]) * xs[m]) * scale[n])
//
// and keeps quantize_act_kernel (xq and xs to device memory) for the route
// above 16 rows, where torch._int_mm takes the product.  x and out are
// bfloat16 or float32 (T), q8 int8 row-major [K, N] (the JAX layout [in,
// out], not relaid: the weight bridge and checkpoints keep it), scale
// float32 [N].  Both divisions are IEEE (the build has no --use_fast_math),
// rintf rounds half to even as jnp.round does, and a max is exact in any
// order, so every CTA of a product gets the plain version's xs and xq.  The
// int32 sum is exact (|sum| <= 127^2 K < 2^31 for every K of the presets),
// so any summation order gives the same bits; the epilogue keeps the plain
// version's order: __int2float_rn (the sum can pass 2^24, so this conversion
// rounds), two __fmul_rn, and a round-to-nearest cast to T.  Tolerance
// against the plain version: 0.
//
// Bound: bytes.  The K x N int8 weight is read once for all M rows (the
// talker's qkv at 0.6B: 4.2 MB, 1.25 us at 3.35 TB/s); 2 M K N int8
// operations are far below the card's 1,979 TOP/s int8 rate.
//
// Design.  A CTA of 8 warps owns a column tile of 128 columns and a slice
// of K; where the tiles are too few to fill the SMs, K is split across the
// CTAs of one thread block cluster (up to 16).  What the first design (two
// kernels, byte-wise multiply-adds; tools/w8a8_unfused.cu) lost time to,
// and what this one does about it:
//   1. Two launches a product, the int8 row through device memory: here
//      each CTA quantizes its own slice.  Its threads load x first thing
//      (16 bytes a load), over its slice or, where x is small (`whole`),
//      over all of K; a CTA of a split K then exchanges its slice's row
//      maxima with the cluster (each pushes them into every CTA's shared
//      memory, one cluster barrier), while a `whole` CTA has the rows'
//      |max| itself and waits for no one.  Each CTA quantizes its slice
//      into shared memory as 32-bit words of 4 K-consecutive values of a
//      row, the dot instructions' operand (the division by xs through the
//      exactly rounded reciprocal, with the IEEE division where the product
//      lies near a rounding boundary).  xq and xs never touch device memory.
//   2. One IMAD a weight byte and row: here a 4 x 4 byte transpose in
//      registers (8 __byte_perm) turns 4 words of 4 columns (4 K rows of the
//      row-major weight) into 4 words of 4 K values of one column, and each
//      goes into an int8 dot instruction: mma.sync m16n8k32 s8 (the rows
//      padded to 8 or 16 with zeros; 4 mma a warp per 32 K rows x 32
//      columns), or __dp4a, one per row and word.  The shape's geometry
//      (ops/w8a8.py) picks one.
//   3. A stream that drained between batches: here one thread starts the
//      CTA's whole weight share at entry, right behind its x loads, as TMA
//      boxes (a 2-D tensor map of the weight, one box of up to 256 K rows x
//      128 columns a stage, each landing on an mbarrier), so it is in
//      flight while x is loaded, exchanged and quantized.  (cp.async, 16
//      bytes a thread, holds the issuing threads for about as long as the
//      copies take; a bulk copy a row queues each row behind the TMA unit.)
//      The boxes land 128-byte swizzled, which the warps' reads undo.
//   4. A heavy tail (int32 atomics a lane, two cluster barriers, reads over
//      16 CTAs' shared memory): here the warps hand their sums to shared
//      memory in one pass, each CTA pushes the 8-column units of its tile
//      to the CTA of the cluster that owns them (plain 16-byte stores into
//      distributed shared memory), and after one cluster barrier each owner
//      adds its units over the splits and writes them through the epilogue,
//      with the column scales loaded at entry.
// No workspace, no allocation, nothing read from the host but the weight's
// tensor map, encoded once per weight and kept: the kernel captures into
// CUDA graphs.  Built with nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface (qwen3tts_tpu_torch/ops/w8a8.py).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // 8 warps: 4 column blocks x 2 halves of each stage's K
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;              // columns of a CTA (32 a column block): bytes of a row
constexpr int kStep = 32;               // K rows of one dot step (the mma's k)
constexpr int kMaxRows = 16;            // rows of the GEMV
constexpr int kMaxSplits = 16;          // K splits: CTAs of a cluster (non-portable 16)
constexpr int kMaxStageRows = 256;      // a stage is one TMA box: at most 256 rows
constexpr int kUnits = kTile / 8;       // 8-column units, the grain of the cluster fold
constexpr int kSmemMax = 232448;        // dynamic shared memory a CTA can have
constexpr int kQuantThreads = 256;      // quantize_act_kernel (the route above 16 rows)
constexpr int kQuantWarps = kQuantThreads / 32;

// Per-CTA phase stamps (%globaltimer), compiled in only for
// tools/kernel_probe.py (`w8a8`): thread 0 of each CTA.
#ifdef QWEN3TTS_STAMPS
constexpr int kStampCTAs = 512, kStampPhases = 16;
__device__ unsigned long long g_stamp[kStampCTAs * kStampPhases];
__device__ __forceinline__ void stamp(int phase) {
  const int cta = blockIdx.x + gridDim.x * blockIdx.y;
  if (threadIdx.x == 0 && cta < kStampCTAs) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[cta * kStampPhases + phase] = t;
  }
}
#define W8A8_STAMP(phase) stamp(phase)
#else
#define W8A8_STAMP(phase)
#endif

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// this thread's arrival, and `bytes` more that the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// one TMA box of the weight's tensor map: rows [row, row + box rows) x
// columns [col, col + kTile), 128-byte swizzled; rows and columns past the
// weight's end land as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int col, int row,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
        "r"(smem_addr(bar))
      : "memory");
}
// The cluster barrier in halves: arrive (relaxed: it orders nothing) and
// wait; and whole (arrive.release, wait.acquire): the remote stores before
// it are visible to every CTA of the cluster after it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// 4 words of 4 columns (word i = K row i) -> 4 words of 4 K rows (word j =
// column j): a 4 x 4 byte transpose, 8 __byte_perm
__device__ __forceinline__ void transpose4(uint32_t (&w)[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t c = __byte_perm(w[0], w[1], 0x7362), d = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(a, b, 0x5410);
  w[1] = __byte_perm(a, b, 0x7632);
  w[2] = __byte_perm(c, d, 0x5410);
  w[3] = __byte_perm(c, d, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// largest |value| of 16 bytes of x
__device__ __forceinline__ float absmax16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ float absmax16(const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)  // a bfloat16 is the top half of its float32
    m = fmaxf(m, fmaxf(__uint_as_float((u[i] & 0x7fffu) << 16),
                       __uint_as_float(u[i] & 0x7fff0000u)));
  return m;
}

// 4 consecutive values of x (8 or 16 bytes, aligned) as float
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xffff0000u);
}

__device__ __forceinline__ int quantize(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}
// The same integer as quantize(v, s), with r = __frcp_rn(s): y = v * r is
// within 2 ulps of the rounded quotient v / s (each of r and y rounds once),
// so where y lies farther than 8 ulps from a half-integer both round to the
// same integer; nearer (a tie among them), the IEEE division decides.
__device__ __forceinline__ int quantize_fast(float v, float s, float r) {
  const float y = __fmul_rn(v, r), n = rintf(y);
  if (0.5f - fabsf(y - n) <= fmaxf(fabsf(y), 1.f) * 1e-6f) return quantize(v, s);
  return (int)fminf(fmaxf(n, -127.f), 127.f);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// Byte offsets of a CTA's dynamic shared memory (host and device).  The
// ring comes first: a 128-byte-swizzled TMA box needs 1024-byte alignment.
struct Layout {
  int kwp;    // 32-bit words of a quantized row (kc / 4, padded to 4 mod 32: no bank conflict)
  int upo;    // 8-column units a CTA owns in the cluster fold
  int stage;  // bytes of a ring stage
  int ring, xsl, sc, xw, part, recv, amax, xs, red, bars, bytes;
};

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int mt, int M, int elt, int kc, int sr, int ring,
                                              int splits) {
  Layout L;
  L.kwp = (kc / 4 + 31) / 32 * 32 + 4;
  L.upo = (kUnits + splits - 1) / splits;
  L.stage = sr * kTile;
  int o = 0;
  L.ring = o;  // [ring][sr][kTile] int8, as the TMA box lands
  o += ring * L.stage;
  L.xsl = o;  // [M][kc] T: this split's slice of x
  o += align16(M * kc * elt);
  L.sc = o;  // [kTile] float: the tile's column scales
  o += kTile * 4;
  L.xw = o;  // [mt][kwp] packed int8 words
  o += align16(mt * L.kwp * 4);
  L.part = o;  // [2][mt][kTile] int32: the sums of each half of the warps
  o += 2 * mt * kTile * 4;
  L.recv = o;  // [splits][mt][upo * 8] int32: the units this CTA owns, from each split
  o += align16(splits * mt * L.upo * 8 * 4);
  L.amax = o;  // [kMaxSplits][kMaxRows] float: each split's row maxima
  o += kMaxSplits * kMaxRows * 4;
  L.xs = o;  // [2][kMaxRows] float: xs and its reciprocal
  o += 2 * kMaxRows * 4;
  L.red = o;  // [kWarps][kMaxRows] float
  o += kWarps * kMaxRows * 4;
  L.bars = o;  // [ring] mbarriers, one a stage
  o += ring * 8;
  L.bytes = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                    int K) {
  __shared__ float red[kQuantWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* row = x + (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) amax = fmaxf(amax, fabsf(to_f(row[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int i = 1; i < kQuantWarps; ++i) amax = fmaxf(amax, red[i]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  int8_t* q = xq + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    q[k] = static_cast<int8_t>(quantize(to_f(row[k]), s));
}

// The sums of a warp's 32 columns.  mma: 4 m16n8k32 tiles; tile j's column
// n' is the tile's column 4 n' + j, so lane (g, t) ends with rows g and
// g + 8, columns 8t..8t+7.  dp4a: lane (g, t) adds, for every row, columns
// 4g..4g+3 over K rows 4t..4t+3 and 16+4t..16+4t+3 of each step.
template <int MT, bool MMA>
struct Acc {
  int v[MMA ? 4 : MT][4];
};

// NS dot steps: 32 K rows each (kTile bytes a row, the 16-byte chunk c of
// row r at chunk c ^ (r & 7): the TMA's 128-byte swizzle), step j at
// `st + j * dst` against the packed words `xw + j * dxw` (+ kwp a row) of
// the same 32 K values.  Every step's weight words are loaded before any is
// used.  The lane reads chunk `cb` of its rows 4t+i and 16+4t+i, word `wd`
// of the chunk.
template <int NS, int MT, bool MMA>
__device__ __forceinline__ void dot_steps(const int8_t* st, int dst, const uint32_t* xw, int dxw,
                                          int kwp, int g, int t, int cb, int wd,
                                          Acc<MT, MMA>& acc) {
  uint32_t b1[NS][4], b2[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * t + i, o = j * dst + ((cb ^ (r & 7)) << 4) + wd;
      b1[j][i] = *reinterpret_cast<const uint32_t*>(st + r * kTile + o);
      b2[j][i] = *reinterpret_cast<const uint32_t*>(st + (16 + r) * kTile + o);
    }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    transpose4(b1[j]);
    transpose4(b2[j]);
    const uint32_t* w = xw + j * dxw;
    if constexpr (MMA) {
      const uint32_t a0 = w[g * kwp + t], a2 = w[g * kwp + 4 + t];
      const uint32_t a1 = MT > 8 ? w[(g + 8) * kwp + t] : 0u;
      const uint32_t a3 = MT > 8 ? w[(g + 8) * kwp + 4 + t] : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) mma_s8(acc.v[c], a0, a1, a2, a3, b1[j][c], b2[j][c]);
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int a1 = (int)w[m * kwp + t], a2 = (int)w[m * kwp + 4 + t];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc.v[m][c] = __dp4a(a2, (int)b2[j][c], __dp4a(a1, (int)b1[j][c], acc.v[m][c]));
      }
    }
  }
}

// Grid (ceil(N / kTile), splits), clusters of (1, splits): column tile
// blockIdx.x, K rows [blockIdx.y * kc, min(K, (blockIdx.y + 1) * kc)),
// every split non-empty.  The ring holds `ring` stages of `sr` K rows, each
// one box of `wmap` (the weight, [K, N] uint8, boxes of sr x kTile,
// 128-byte swizzle).  Needs M <= MT, K % 8 == 0, N % 16 == 0, kc and sr
// multiples of 32, sr <= 256, x, scale and out 16-byte aligned.
template <typename T, int MT, bool MMA>
__global__ void __launch_bounds__(kThreads)
fused_w8a8_gemv_kernel(const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N,
                       int kc, int sr, int ring, int whole) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int splits = gridDim.y;
  const Layout L = make_layout(MT, M, sizeof(T), kc, sr, ring, splits);
  int8_t* ring_s = reinterpret_cast<int8_t*>(smem + L.ring);
  T* xsl = reinterpret_cast<T*>(smem + L.xsl);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem + L.xw);
  int* part = reinterpret_cast<int*>(smem + L.part);
  int* recv = reinterpret_cast<int*>(smem + L.recv);
  float* amax = reinterpret_cast<float*>(smem + L.amax);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile0 = blockIdx.x * kTile;
  const int cols = min(kTile, N - tile0);  // a multiple of 16
  const int rank = blockIdx.y;  // the cluster spans the splits: its block rank
  const int k0 = rank * kc;
  const int rows = min(K, k0 + kc) - k0;
  const int nst = (rows + sr - 1) / sr;
  constexpr int kPer = 16 / sizeof(T);  // x values in 16 bytes

  W8A8_STAMP(0);
  if (tid == 0) prefetch_map(&wmap);  // the descriptor, fetched while x loads
  // x first, by every thread (a load issued after the weight's stream would
  // queue behind it): the rows over all of K (`whole`: each CTA takes the
  // rows' |max| itself, and no CTA waits for another before it quantizes)
  // or over the slice, 16 bytes a load, the first 4 of each thread issued
  // together; the slice's part goes to `xsl`.  The tile's scales too.
  const int span = whole ? K : rows, kbase = whole ? 0 : k0;
  const int cpr = span / kPer, chunks = M * cpr;  // 16-byte chunks to read
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  auto chunk_at = [&](int i) { const int m = i / cpr; return (m * K + kbase) / kPer + i - m * cpr; };
  uint4 pre[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (tid + u * kThreads < chunks) pre[u] = __ldg(x4 + chunk_at(tid + u * kThreads));
  float4 sc4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (4 * tid < cols) sc4 = __ldg(reinterpret_cast<const float4*>(scale + tile0) + tid);

  // Then thread 0 starts the weight's stream: every stage the ring holds,
  // one TMA box each, in flight from here on while the row is quantized.
  auto issue = [&](int s) {  // by thread 0
    uint64_t* bar = &bars[s % ring];
    mbar_expect_tx(bar, sr * kTile);  // a box lands whole, zeros past the weight's end
    tma_box(ring_s + (s % ring) * L.stage, &wmap, tile0, k0 + s * sr, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < ring; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
    for (int s = 0; s < min(nst, ring); ++s) issue(s);
  }
  if (splits > 1) cluster_arrive_relaxed();  // waited on before the first remote store
  W8A8_STAMP(1);

  // Each row's largest |x|: over all of K (`whole`), or over the slice,
  // and then the cluster's CTAs push theirs into every CTA's `amax` (behind
  // the barrier that every CTA of the cluster has started) and after one
  // cluster barrier each takes the max over the splits.  Every CTA gets the
  // same xs: a max is exact in any order.
  const bool exchange = splits > 1 && !whole;
  float mx[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) mx[m] = 0.f;
  auto take = [&](int i, const uint4& v) {
    const int m = i / cpr, k = kbase + (i - m * cpr) * kPer;
    const float a = absmax16(reinterpret_cast<const T*>(&v));
#pragma unroll
    for (int r = 0; r < MT; ++r)
      if (r == m) mx[r] = fmaxf(mx[r], a);
    if (k >= k0 && k < k0 + rows)
      *reinterpret_cast<uint4*>(xsl + (size_t)m * kc + (k - k0)) = v;
  };
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (tid + u * kThreads < chunks) take(tid + u * kThreads, pre[u]);
  for (int i = tid + 4 * kThreads; i < chunks; i += kThreads) take(i, __ldg(x4 + chunk_at(i)));
  if (4 * tid < cols) reinterpret_cast<float4*>(sc)[tid] = sc4;
  W8A8_STAMP(2);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[m] = fmaxf(mx[m], __shfl_xor_sync(0xffffffffu, mx[m], off));
    if (lane == 0) red[warp * kMaxRows + m] = mx[m];
  }
  __syncthreads();
  W8A8_STAMP(3);
  if (exchange) cluster_wait();
  if (tid < M) {
    float a = red[tid];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) a = fmaxf(a, red[i * kMaxRows + tid]);
    if (exchange) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = 0; r < splits; ++r) cluster.map_shared_rank(amax, r)[rank * kMaxRows + tid] = a;
    } else {
      amax[tid] = a;
    }
  }
  if (exchange) cluster_sync(); else __syncthreads();
  W8A8_STAMP(4);
  if (tid < M) {
    float a = amax[tid];
    for (int r = 1; exchange && r < splits; ++r) a = fmaxf(a, amax[r * kMaxRows + tid]);
    const float s = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
    xs[tid] = s;
    xs[kMaxRows + tid] = __frcp_rn(s);
  }
  __syncthreads();
  W8A8_STAMP(5);

  // The slice quantized into words of 4 K-consecutive values of a row;
  // rows M..MT-1 and K past the slice are zeros.
  {
    const int kwq = kc / 4;
    for (int i = tid; i < MT * kwq; i += kThreads) {
      const int m = i / kwq, kw = i - m * kwq;
      uint32_t word = 0u;
      if (m < M && 4 * kw < rows) {
        const float s = xs[m], r = xs[kMaxRows + m];
        float v[4];
        load4(xsl + (size_t)m * kc + 4 * kw, v);
#pragma unroll
        for (int b = 0; b < 4; ++b) word |= (uint32_t)(quantize_fast(v[b], s, r) & 0xff) << (8 * b);
      }
      xw[m * L.kwp + kw] = word;
    }
  }
  __syncthreads();
  W8A8_STAMP(6);

  // The dot steps, stage by stage as the stages land: warp w takes column
  // block w % 4 and every other step (half w / 4).
  const int g = lane >> 2, t = lane & 3, cblk = warp & 3, half = warp >> 2;
  const bool live = tile0 + 32 * cblk < N;
  const int cb = 2 * cblk + (g >> 2), wd = 4 * (g & 3);
  const int steps_all = (rows + kStep - 1) / kStep, steps_stage = sr / kStep;
  Acc<MT, MMA> acc;
#pragma unroll
  for (int a = 0; a < (MMA ? 4 : MT); ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[a][j] = 0;
  for (int s = 0; s < nst; ++s) {
    const int slot = s % ring;
    mbar_wait(&bars[slot], (s / ring) & 1);
    if (s == 0) W8A8_STAMP(7);
    if (live) {  // this half's steps of the stage: every other one, two at a time
      const int8_t* st = ring_s + slot * L.stage;
      const int g0 = s * steps_stage, steps = min(steps_stage, steps_all - g0);
      int q = (half ^ g0) & 1;
      for (; q + 2 < steps; q += 4)
        dot_steps<2, MT, MMA>(st + q * kStep * kTile, 2 * kStep * kTile,
                              xw + (g0 + q) * (kStep / 4), 2 * (kStep / 4), L.kwp, g, t, cb, wd,
                              acc);
      if (q < steps)
        dot_steps<1, MT, MMA>(st + q * kStep * kTile, 0, xw + (g0 + q) * (kStep / 4), 0, L.kwp,
                              g, t, cb, wd, acc);
    }
    if (s + ring < nst) {
      __syncthreads();  // every warp is done with the slot
      if (tid == 0) issue(s + ring);
    }
  }
  W8A8_STAMP(8);

  // The warps' sums to `part` [half][MT][kTile], one pass; the two halves
  // are added as they are read.
  if (live) {
    int* p = part + half * MT * kTile + 32 * cblk;
    if constexpr (MMA) {
#pragma unroll
      for (int h = 0; h < (MT > 8 ? 2 : 1); ++h) {
        int* q = p + (g + 8 * h) * kTile + 8 * t;
        *reinterpret_cast<int4*>(q) = make_int4(acc.v[0][2 * h], acc.v[1][2 * h],
                                                acc.v[2][2 * h], acc.v[3][2 * h]);
        *reinterpret_cast<int4*>(q + 4) = make_int4(acc.v[0][2 * h + 1], acc.v[1][2 * h + 1],
                                                    acc.v[2][2 * h + 1], acc.v[3][2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc.v[m][j] += __shfl_xor_sync(0xffffffffu, acc.v[m][j], 1);
          acc.v[m][j] += __shfl_xor_sync(0xffffffffu, acc.v[m][j], 2);
        }
        if (t == (m & 3))
          *reinterpret_cast<int4*>(p + m * kTile + 4 * g) =
              make_int4(acc.v[m][0], acc.v[m][1], acc.v[m][2], acc.v[m][3]);
      }
    }
  }
  __syncthreads();
  W8A8_STAMP(9);

  auto sum_halves = [&](int i) {  // 4 sums from part entry i
    const int4 a = *reinterpret_cast<const int4*>(part + i);
    const int4 b = *reinterpret_cast<const int4*>(part + MT * kTile + i);
    return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  };
  auto emit = [&](int m, int c, int4 v) {  // 4 columns from tile column c
    const int n = tile0 + c;
    if (n >= N) return;
    const float s = xs[m];
    const float4 f = *reinterpret_cast<const float4*>(sc + c);
    store4(out + (size_t)m * N + n, __fmul_rn(__fmul_rn(__int2float_rn(v.x), s), f.x),
           __fmul_rn(__fmul_rn(__int2float_rn(v.y), s), f.y),
           __fmul_rn(__fmul_rn(__int2float_rn(v.z), s), f.z),
           __fmul_rn(__fmul_rn(__int2float_rn(v.w), s), f.w));
  };
  if (splits == 1) {
    for (int i = tid; i < M * (kTile / 4); i += kThreads) {
      const int m = i / (kTile / 4), c = 4 * (i - m * (kTile / 4));
      emit(m, c, sum_halves(m * kTile + c));
    }
    W8A8_STAMP(11);
    return;
  }
  // Unit u (8 columns) belongs to the CTA of rank u % splits: each CTA
  // stores its sums of every unit into the owner's `recv`, slot `rank`;
  // after the barrier no CTA touches another's shared memory, so each may
  // exit once it has written its own units.  (With `whole`, this barrier's
  // wait is the first remote access's: every CTA of the cluster has started.)
  if (whole) cluster_wait();
  {
    cg::cluster_group cluster = cg::this_cluster();
    for (int i = tid; i < M * kUnits; i += kThreads) {
      const int m = i / kUnits, u = i - m * kUnits;
      int4* dst = reinterpret_cast<int4*>(cluster.map_shared_rank(recv, u % splits) +
                                          ((rank * MT + m) * L.upo + u / splits) * 8);
      dst[0] = sum_halves(m * kTile + 8 * u);
      dst[1] = sum_halves(m * kTile + 8 * u + 4);
    }
  }
  cluster_sync();
  W8A8_STAMP(10);
  for (int i = tid; i < M * L.upo * 2; i += kThreads) {
    const int m = i / (L.upo * 2), h = i - m * (L.upo * 2), lu = h / 2, half = h & 1;
    const int u = lu * splits + rank;
    if (u >= kUnits) continue;
    int4 s = make_int4(0, 0, 0, 0);
    for (int j = 0; j < splits; ++j) {
      const int4 v = *reinterpret_cast<const int4*>(recv + ((j * MT + m) * L.upo + lu) * 8 +
                                                    4 * half);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    emit(m, 8 * u + 4 * half, s);
  }
  W8A8_STAMP(11);
}

template <typename T>
cudaError_t quantize_act(const void* x, void* xq, void* xs, int M, int K, cudaStream_t st) {
  quantize_act_kernel<T><<<M, kQuantThreads, 0, st>>>(static_cast<const T*>(x),
                                                      static_cast<int8_t*>(xq),
                                                      static_cast<float*>(xs), K);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The weight's tensor map: [K, N] uint8, boxes of sr rows x kTile columns,
// 128-byte swizzle, zeros past the ends.  A map is a function of (address,
// K, N, sr) alone, so each is encoded once and kept: no host work per
// launch after the first, and a graph's replays need none.
cudaError_t weight_map(const void* w, int K, int N, int sr, CUtensorMap* map) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CUtensorMap> maps;
  static EncodeTiled encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(w, K, N, sr);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)kTile, (cuuint32_t)sr};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap m;
  if (encode(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  maps.emplace(key, m);
  *map = m;
  return cudaSuccess;
}

template <typename T, int MT, bool MMA>
cudaError_t gemv(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
                 int splits, int kc, int sr, int ring, int whole, cudaStream_t st) {
  auto* kernel = fused_w8a8_gemv_kernel<T, MT, MMA>;
  const Layout L = make_layout(MT, M, (int)sizeof(T), kc, sr, ring, splits);
  if (L.bytes > kSmemMax) return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = weight_map(w, K, N, sr, &map);
  if (err != cudaSuccess) return err;
  static int smem_set = 48 * 1024;  // once per instance and size: no host work per launch
  static bool non_portable = false;
  if (L.bytes > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return err;
    smem_set = L.bytes;
  }
  if (splits > 8 && !non_portable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTile - 1) / kTile, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one CTA a column tile: no cluster
  return cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const T*>(x),
                            static_cast<const float*>(scale), static_cast<T*>(out), M, K, N, kc,
                            sr, ring, whole);
}

template <typename T>
cudaError_t gemv_dispatch(int mt, int mma, const void* x, const void* w, const void* scale,
                          void* out, int M, int K, int N, int splits, int kc, int sr, int ring,
                          int whole, cudaStream_t st) {
#define QWEN3TTS_GEMV(MT_, MMA_)                                                          \
  if (mt == MT_ && mma == MMA_)                                                           \
  return gemv<T, MT_, MMA_ != 0>(x, w, scale, out, M, K, N, splits, kc, sr, ring, whole, st)
  QWEN3TTS_GEMV(1, 0);
  QWEN3TTS_GEMV(2, 0);
  QWEN3TTS_GEMV(4, 0);
  QWEN3TTS_GEMV(8, 0);
  QWEN3TTS_GEMV(16, 0);
  QWEN3TTS_GEMV(8, 1);
  QWEN3TTS_GEMV(16, 1);
#undef QWEN3TTS_GEMV
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (x and out): 0 = bfloat16, 1 = float32.  Each returns the launch's
// cudaError_t (0 on success), cudaErrorInvalidValue for a shape or
// geometry without an instance.

// x [M, K] -> xq int8 [M, K], xs float32 [M]: one CTA a row (the route above
// 16 rows, before torch._int_mm).
int qwen3tts_quantize_act(int dtype, const void* x, void* xq, void* xs, int M, int K,
                          void* stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)quantize_act<__nv_bfloat16>(x, xq, xs, M, K, st);
  if (dtype == 1) return (int)quantize_act<float>(x, xq, xs, M, K, st);
  return (int)cudaErrorInvalidValue;
}

// x [M, K], w int8 [K, N], scale float32 [N] -> out [M, N], quantize
// included.  mt: the rows of the dot (mma: 8 or 16; dp4a: M rounded up to a
// power of 2); mma: 1 for mma.sync, 0 for __dp4a; K split over `splits`
// (1 to 16) CTAs of kc rows each (a multiple of 32), one cluster a column
// tile, no split empty; a ring of `ring` stages of `stage_rows` K rows (a
// multiple of 32, at most 256: one TMA box); whole: 1 where each CTA takes
// the rows' |max| over all of K itself (no exchange over the cluster), 0
// where it takes it over its slice and the cluster exchanges them.  Needs
// K % 8 == 0 and N % 16 == 0.
int qwen3tts_w8a8_gemv(int dtype, const void* x, const void* w, const void* scale, void* out,
                       int M, int K, int N, int mt, int mma, int splits, int kc, int stage_rows,
                       int ring, int whole, void* stream) {
  if (M < 1 || M > mt || mt > kMaxRows || K < 8 || K % 8 || N < 16 || N % 16)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits || kc < kStep || kc % kStep ||
      (long long)(splits - 1) * kc >= K || (long long)splits * kc < K)
    return (int)cudaErrorInvalidValue;
  if (stage_rows < kStep || stage_rows % kStep || stage_rows > kMaxStageRows || ring < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)gemv_dispatch<__nv_bfloat16>(mt, mma, x, w, scale, out, M, K, N, splits, kc,
                                             stage_rows, ring, whole, st);
  if (dtype == 1)
    return (int)gemv_dispatch<float>(mt, mma, x, w, scale, out, M, K, N, splits, kc, stage_rows,
                                     ring, whole, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef QWEN3TTS_STAMPS
int qwen3tts_w8a8_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
}
#endif

}  // extern "C"
