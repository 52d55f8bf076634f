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
// and its o + MLP weights 23 MB; the activations are a few KB.  What a
// call loses time to is latency, not bytes: fused_o_mlp is a chain of three
// dependent products with a norm and an activation between them, and the
// vector between two links has to cross the whole grid.
//
// fused_norm_matmul: one launch, a column tile of kCols = 32 output columns
// per CTA (256 threads, 4 per weight row, each reading 8 consecutive
// columns of every 64th row, a batch of 8 rows' raw loads in flight before
// any is converted).  Each CTA recomputes the RMS norm of its (at most
// 2048-wide) rows into shared memory, as the Pallas kernel does per grid
// step.  Rows are taken kBC at a time (1 at batch 1, else 4).
//
// fused_o_mlp: ONE cooperative launch of one CTA per SM, with the weights
// streamed by wstream.cuh.  A CTA knows its share of all three matrices
// before any activation exists: a 32-column tile of Wo over one of KS row
// splits, the gate and up columns of one tile of the intermediate size
// (24 columns at the 0.6B shapes: 128 tiles on 132 SMs), and that tile's
// rows of Wd.  It starts copying all of it into a ring in shared memory
// at kernel entry and keeps the ring full, so the chain
//       o-projection -> [grid] -> norm -> gate/up -> activation -> down
//       -> [grid] -> sum
// computes out of shared memory and waits for DRAM only once, at entry.
// The vector crosses the grid twice, through workspaces in L2 (part1 [KS,
// B, H]: the o-projection's row splits; part2 [NT, B, H]: the down
// projection's per-tile partial sums), as 8-byte words that carry the
// launch's tag beside the float: a reader takes a word when it finds the
// tag, so no grid barrier stands where the two in the chain above would
// (the brackets).  Every CTA rebuilds x2 = f32(x) + sum_ks part1 with the
// same arithmetic, so all see the same bits; the last phase spreads the
// B * H outputs over the grid and sums the tiles in a fixed order.  No
// float atomics: two runs on the same inputs give the same bits.  More
// than 4 rows are taken 4 at a time, one launch each.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (qwen3tts_tpu_torch/ops/fused_block.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// fused_o_mlp's ring: 32 KB stages (a CTA's whole share is 12 of 16 KB; half
// as many hand-overs measured 1.8 us a call faster at the talker's shapes)
#ifndef QWEN3TTS_STAGE_BYTES
#define QWEN3TTS_STAGE_BYTES 32768
#endif
#include "wstream.cuh"

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

template <typename T, typename W, int kBC>
cudaError_t norm_matmul(const void* x, const void* nw, const void* w, const void* wscale,
                        void* out, int B, int H, int N, float eps, cudaStream_t st) {
  norm_matmul_kernel<T, W, kBC><<<(N + kCols - 1) / kCols, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<const W*>(w),
      static_cast<const float*>(wscale), static_cast<T*>(out), B, H, N, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C. fused_o_mlp: one cooperative launch, the weights through wstream.cuh.

using wstream::Job;

constexpr int kMaxCo = 64;    // widest o-projection column tile
constexpr int kMaxCgu = 256;  // widest gate/up tile (intermediate columns of one CTA)

template <typename T, typename W>
struct OArgs {
  const T* x;     // [B, H]
  const T* attn;  // [B, Dq]
  const W* wo;    // [Dq, H]
  const float* so;
  const T* nw;    // [H]
  const W* gu;    // [H, 2 I]
  const float* sgu;
  const W* wd;    // [I, H]
  const float* sd;
  T* out;         // [B, H]
  uint64_t* part1;  // [KS, B, H] tagged floats
  uint64_t* part2;  // [NT, B, H]
  unsigned* sync;   // wstream.cuh launch_tags
  int B, H, Dq, I;
  int tiles_o, KS, k_chunk, C_o;  // o-projection: column tiles x row splits
  int NT, C_gu;                   // intermediate tiles
  float eps;
};

// floats of shared memory behind the ring
template <int kBC> constexpr int kOmlpFloats =
    3 * kBC * kMaxK + wstream::kRedFloats<kBC> + kBC * kMaxCgu + kMaxCo + 2 * kMaxCgu + kMaxK +
    kBC * wstream::kWarps;
// ring stages: what the vectors of kBC rows leave of the shared memory
template <int kBC> constexpr int kStages =
    wstream::ring_stages(kOmlpFloats<kBC> * (int)sizeof(float));
static_assert(kStages<1> >= 2 && kStages<4> >= 2, "the ring needs two stages");
template <int kBC> constexpr int kOmlpSmem =
    (int)sizeof(wstream::RingMem<kStages<kBC>>) + kOmlpFloats<kBC> * (int)sizeof(float);

struct OSched {
  Job jobs[3];
  __device__ __forceinline__ bool job(int j, Job& out) const {
    if (j >= 3) return false;
    out = jobs[j];
    return true;
  }
};

// x2 = f32(x) + sum_ks part1[ks] for N elements at once, the partials
// summed in split order, each taken once it carries `tag` (other CTAs
// write them in this launch): the same arithmetic wherever x2 is rebuilt,
// so every CTA sees the same bits.  Elements without ok give 0.
template <typename T, int N>
__device__ __forceinline__ void residual_x2(const T* __restrict__ x, const uint64_t* part1, int KS,
                                           size_t BH, const int (&idx)[N], const bool (&ok)[N],
                                           unsigned tag, float (&x2)[N]) {
  float xv[N], s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) xv[i] = ok[i] ? to_f(x[idx[i]]) : 0.f;
  wstream::sum_splits<N>(part1, KS, BH, idx, ok, tag, s);
#pragma unroll
  for (int i = 0; i < N; ++i) x2[i] = ok[i] ? xv[i] + s[i] : 0.f;
}

// Grid: the co-resident CTAs (one per SM).  CTA c owns o-projection item c
// (column tile c % tiles_o, row split c / tiles_o) and intermediate tile c,
// where it has one.  All three weight shares start streaming at entry.  No
// grid barrier: part1 and part2 are tagged words (wstream.cuh), written once
// a launch, and a reader takes each word when it carries the launch's tag.
template <typename T, typename W, int kBC>
__global__ void __launch_bounds__(wstream::kBlock, 1) o_mlp_kernel(const __grid_constant__ OArgs<T, W> a) {
  constexpr int NS = kStages<kBC>;
  extern __shared__ __align__(128) char smem[];
  auto* ring_mem = reinterpret_cast<wstream::RingMem<NS>*>(smem);
  float* a_s = reinterpret_cast<float*>(smem + sizeof(wstream::RingMem<NS>));
  float* x2_s = a_s + kBC * kMaxK;
  float* res = x2_s + kBC * kMaxK;
  float* red = res + kBC * kMaxK;
  float* act_s = red + wstream::kRedFloats<kBC>;
  float* sc_o = act_s + kBC * kMaxCgu;
  float* sc_gu = sc_o + kMaxCo;
  float* sc_d = sc_gu + 2 * kMaxCgu;
  float* nred = sc_d + kMaxK;

  const int tid = threadIdx.x, item = blockIdx.x;
  const int B = a.B, H = a.H, Dq = a.Dq, I = a.I;
  const size_t BH = (size_t)B * H;
  const bool has_o = item < a.tiles_o * a.KS;
  const int ks = item / a.tiles_o, n0 = (item % a.tiles_o) * a.C_o;
  const int Co = min(a.C_o, H - n0);
  const int k_lo = ks * a.k_chunk, k_hi = min(Dq, k_lo + a.k_chunk);
  const bool has_t = item < a.NT;
  const int i0 = item * a.C_gu;
  const int Cg = min(a.C_gu, I - i0);

  OSched sched;
  sched.jobs[0] = has_o ? wstream::make_job(a.wo, H, n0, 0, 1, Co, k_lo, k_hi)
                        : wstream::empty_job();
  sched.jobs[1] = has_t ? wstream::make_job(a.gu, 2 * I, i0, I + i0, 2, Cg, 0, H)
                        : wstream::empty_job();
  sched.jobs[2] = has_t ? wstream::make_job(a.wd + (size_t)i0 * H, H, 0, 0, 1, H, 0, Cg)
                        : wstream::empty_job();
  wstream::ring_init(ring_mem);
  const unsigned tag0 = wstream::launch_tags(a.sync);  // part1 carries tag0 + 1, part2 tag0 + 2
  if (tid >= wstream::kThreads) {  // the producers: all three shares, from here on
    wstream::produce(ring_mem, sched);
    return;
  }
  wstream::Consumer<NS> ring = {ring_mem, 0};
  WSTREAM_STAMP(0, 0);

  if constexpr (sizeof(W) == 1) {
    if (has_o)
      for (int c = tid; c < Co; c += wstream::kThreads) sc_o[c] = a.so[n0 + c];
    if (has_t) {
      for (int c = tid; c < Cg; c += wstream::kThreads) {
        sc_gu[c] = a.sgu[i0 + c];
        sc_gu[Cg + c] = a.sgu[I + i0 + c];
      }
      for (int n = tid; n < H; n += wstream::kThreads) sc_d[n] = a.sd[n];
    }
  }

  // A. this CTA's o-projection partial sums
  if (has_o) {
    const int len = k_hi - k_lo;
    for (int i0 = tid; i0 < kBC * len; i0 += 4 * wstream::kThreads) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * wstream::kThreads;
        v[u] = i < B * len ? to_f(a.attn[(size_t)(i / len) * Dq + k_lo + i % len]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * wstream::kThreads;
        if (i < kBC * len) a_s[(i / len) * Dq + k_lo + i % len] = v[u];
      }
    }
    wstream::cta_sync();
    wstream::stream_job<T, W, kBC>(ring, sched.jobs[0], a_s, Dq, sc_o, red, res, 0);
    for (int i = tid; i < kBC * Co; i += wstream::kThreads) {
      const int bc = i / Co, c = i % Co;
      if (bc < B)
        wstream::put_tagged(a.part1 + ((size_t)ks * B + bc) * H + n0 + c, res[i], tag0 + 1);
    }
  }
  WSTREAM_STAMP(0, 2);

  // B. norm of x2, this tile's gate and up columns, the activation, and the
  // tile's partial down projection
  if (has_t) {
    for (int base = tid; base < kBC * H; base += 4 * wstream::kThreads) {
      int idx[4];
      bool ok[4];
      float x2[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        idx[u] = base + u * wstream::kThreads;
        ok[u] = idx[u] < B * H;
      }
      residual_x2<T, 4>(a.x, a.part1, a.KS, BH, idx, ok, tag0 + 1, x2);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (idx[u] < kBC * H) x2_s[idx[u]] = x2[u];
    }
    WSTREAM_STAMP(1, 0);
    wstream::cta_sync();
    wstream::rms_norm_rows<T, T, kBC>(a_s, x2_s, H, a.nw, a.eps, nred);
    wstream::stream_job<T, W, kBC>(ring, sched.jobs[1], a_s, H, sc_gu, red, res, 1);
    for (int i = tid; i < kBC * Cg; i += wstream::kThreads) {
      const int bc = i / Cg, c = i % Cg;
      const float g = res[bc * 2 * Cg + c], u = res[bc * 2 * Cg + Cg + c];
      act_s[bc * kMaxCgu + c] = rnd<T>(g * (1.f / (1.f + expf(-g))) * u);
    }
    wstream::cta_sync();
    WSTREAM_STAMP(1, 2);
    wstream::stream_job<T, W, kBC>(ring, sched.jobs[2], act_s, kMaxCgu, sc_d, red, res, 2);
    for (int i = tid; i < kBC * H; i += wstream::kThreads)
      if (i / H < B) wstream::put_tagged(a.part2 + (size_t)item * BH + i, res[i], tag0 + 2);
  }
  WSTREAM_STAMP(2, 2);

  // C. out = T(x2 + sum_t part2[t]): the outputs spread over the grid, one
  // warp an output, a lane summing tiles lane, lane + 32, ... in order
  const int per = (int)((BH + gridDim.x - 1) / gridDim.x);
  const int lo = item * per, hi = (int)min((size_t)lo + per, BH);
  const int warp = tid / 32, lane = tid % 32;
  WSTREAM_STAMP(3, 0);
  for (int i = lo + warp; i < hi; i += wstream::kWarps) {
    const int idx[1] = {i};
    const bool ok[1] = {true};
    float x2[1], s[1];
    residual_x2<T, 1>(a.x, a.part1, a.KS, BH, idx, ok, tag0 + 1, x2);
    // this lane's tiles lane, lane + 32, ... as the splits of a sum
    wstream::sum_splits<1>(a.part2 + (size_t)lane * BH, (a.NT - lane + 31) / 32, 32 * BH, idx, ok,
                           tag0 + 2, s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
    if (lane == 0) put(a.out + i, x2[0] + s[0]);
  }
  WSTREAM_STAMP(3, 2);
  wstream::launch_done(a.sync, tag0, 2);
}

template <typename T, typename W, int kBC>
int o_mlp_grid() {
  static const int grid = wstream::coresident_grid(o_mlp_kernel<T, W, kBC>, kOmlpSmem<kBC>);
  return grid;
}

// Rows are taken kBC at a time, one launch each on the stream.
template <typename T, typename W, int kBC>
cudaError_t o_mlp(OArgs<T, W> a, int B, cudaStream_t st) {
  const int grid = o_mlp_grid<T, W, kBC>();
  if (grid > 0 && (a.tiles_o * a.KS > grid || a.NT > grid)) return cudaErrorInvalidValue;
  const T* x = a.x;
  const T* attn = a.attn;
  T* out = a.out;
  for (int b0 = 0; b0 < B; b0 += kBC) {
    a.x = x + (size_t)b0 * a.H;
    a.attn = attn + (size_t)b0 * a.Dq;
    a.out = out + (size_t)b0 * a.H;
    a.B = min(kBC, B - b0);
    const cudaError_t err =
        wstream::launch_cooperative(o_mlp_kernel<T, W, kBC>, grid, kOmlpSmem<kBC>, st, a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, typename W>
int o_mlp_run(void* const* p, const int* d, float eps, cudaStream_t st) {
  OArgs<T, W> a;
  a.x = static_cast<const T*>(p[0]);
  a.attn = static_cast<const T*>(p[1]);
  a.wo = static_cast<const W*>(p[2]);
  a.so = static_cast<const float*>(p[3]);
  a.nw = static_cast<const T*>(p[4]);
  a.gu = static_cast<const W*>(p[5]);
  a.sgu = static_cast<const float*>(p[6]);
  a.wd = static_cast<const W*>(p[7]);
  a.sd = static_cast<const float*>(p[8]);
  a.out = static_cast<T*>(p[9]);
  a.part1 = static_cast<uint64_t*>(p[10]);
  a.part2 = static_cast<uint64_t*>(p[11]);
  a.sync = static_cast<unsigned*>(p[12]);
  const int B = d[0];
  a.B = 0;
  a.H = d[1]; a.Dq = d[2]; a.I = d[3];
  a.KS = d[4]; a.k_chunk = d[5]; a.C_o = d[6]; a.C_gu = d[7];
  a.tiles_o = (a.H + a.C_o - 1) / a.C_o;
  a.NT = (a.I + a.C_gu - 1) / a.C_gu;
  a.eps = eps;
  return (int)(B == 1 ? o_mlp<T, W, 1>(a, B, st) : o_mlp<T, W, 4>(a, B, st));
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

// ptrs: x, attn, wo, wo_scale, norm_w, gu, gu_scale, wd, wd_scale, out,
// part1 and part2 (8-byte words, zeroed once: [KS, min(B, 4), H] and [NT,
// min(B, 4), H]), sync (uint32 [3], {0, 1, 0} once: wstream.cuh launch_tags).  dims: B, H, Dq, I, KS, k_chunk, C_o, C_gu: the
// o-projection runs ceil(H / C_o) column tiles x KS row splits of k_chunk
// rows, the MLP NT = ceil(I / C_gu) tiles; both counts must fit the grid
// (qwen3tts_o_mlp_grid).
int qwen3tts_fused_o_mlp(int dtype, int w_int8, void* const* ptrs, const int* dims, float eps,
                         void* stream) {
  const int B = dims[0], H = dims[1], Dq = dims[2], I = dims[3], KS = dims[4], k_chunk = dims[5],
            C_o = dims[6], C_gu = dims[7];
  if (!shape_ok(B, Dq, H) || !shape_ok(B, H, 2 * I) || I % kVec != 0 || KS < 1 || k_chunk < 1 ||
      (long long)KS * k_chunk < Dq || (long long)(KS - 1) * k_chunk >= Dq || C_o < kVec ||
      C_o % kVec != 0 || C_o > kMaxCo || C_gu < kVec || C_gu % kVec != 0 || C_gu > kMaxCgu ||
      (w_int8 && (ptrs[3] == nullptr || ptrs[6] == nullptr || ptrs[8] == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !w_int8) return o_mlp_run<__nv_bfloat16, __nv_bfloat16>(ptrs, dims, eps, st);
  if (dtype == 0 && w_int8) return o_mlp_run<__nv_bfloat16, int8_t>(ptrs, dims, eps, st);
  if (dtype == 1 && !w_int8) return o_mlp_run<float, float>(ptrs, dims, eps, st);
  if (dtype == 1 && w_int8) return o_mlp_run<float, int8_t>(ptrs, dims, eps, st);
  return (int)cudaErrorInvalidValue;
}

// CTAs of one fused_o_mlp launch (the co-resident grid: one per SM), or
// minus a cudaError_t.
int qwen3tts_o_mlp_grid(int dtype, int w_int8, int B) {
#define QWEN3TTS_OG(T, W) return B == 1 ? o_mlp_grid<T, W, 1>() : o_mlp_grid<T, W, 4>()
  if (dtype == 0 && !w_int8) QWEN3TTS_OG(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && w_int8) QWEN3TTS_OG(__nv_bfloat16, int8_t);
  if (dtype == 1 && !w_int8) QWEN3TTS_OG(float, float);
  if (dtype == 1 && w_int8) QWEN3TTS_OG(float, int8_t);
#undef QWEN3TTS_OG
  return -(int)cudaErrorInvalidValue;
}

#ifdef QWEN3TTS_STAMPS
int qwen3tts_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, wstream::g_stamp, sizeof(wstream::g_stamp));
}
int qwen3tts_stage_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, wstream::g_stage_stamp, sizeof(wstream::g_stage_stamp));
}
#endif

}  // extern "C"
