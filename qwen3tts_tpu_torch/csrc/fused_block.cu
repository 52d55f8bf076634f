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
// fused_norm_matmul: one launch, one CTA per column tile, the tiles as
// narrow as fills the card (32 columns at the talker's N 4096, 16 at the
// predictor's 2048: 128 CTAs on 132 SMs).  Its weights go through
// wstream.cuh's ring: the producer warps copy the CTA's whole column tile
// from kernel entry, all stages in flight, while the consumers, which asked
// for their elements of x before the copies started, compute the RMS norm
// (every CTA the same bits, as the Pallas kernel recomputes it per grid
// step); then they multiply out of shared memory.  Nothing crosses the
// grid.  Rows are taken kBC at a time (1 at batch 1, else 4), the tile
// streamed once for each.
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

using wstream::Job;
using wstream::put;
using wstream::rnd;
using wstream::to_f;

constexpr int kVec = wstream::kVec;
constexpr int kMaxK = 2048;  // longest activation row in shared memory

// ---------------------------------------------------------------------------
// B. fused_norm_matmul: one launch, the weights through wstream.cuh.

// Its ring: stages of 8192 weights (8 KB int8, 16 KB bf16: the faster size
// of each on the H100; a CTA's share is 16-64 KB at the 0.6B shapes), all
// of them in flight: one phase, nothing else in the CTA waits on the memory
// system behind the copies.  The QWEN3TTS_NM_ flags are for
// tools/kernel_probe.py's variants.
#ifndef QWEN3TTS_NM_STAGE_WEIGHTS
#define QWEN3TTS_NM_STAGE_WEIGHTS 8192
#endif
#ifndef QWEN3TTS_NM_IN_FLIGHT
#define QWEN3TTS_NM_IN_FLIGHT 64
#endif
#ifndef QWEN3TTS_NM_CTAS
#define QWEN3TTS_NM_CTAS 1  // CTAs an SM holds at once
#endif
template <typename W> constexpr int kNmStageBytes = QWEN3TTS_NM_STAGE_WEIGHTS * (int)sizeof(W);
constexpr int kNmMaxCols = 256;                   // widest column tile
constexpr int kPer = kMaxK / wstream::kThreads;   // elements of a row per consumer thread

template <typename T, typename W>
struct NArgs {
  const T* x;          // [B, H]
  const T* nw;         // [H]
  const W* w;          // [H, N]
  const float* scale;  // [N] per-column scales of an int8 W
  T* out;              // [B, N]
  int B, H, N;
  int C;               // ceil(N / C) column tiles, one CTA each
  float eps;
};

// floats of shared memory behind the ring: the normalised rows, the fold,
// the results, the scales, the norm's warp sums
template <int kBC> constexpr int kNmFloats =
    kBC * kMaxK + wstream::kRedFloats<kBC> + kBC * kNmMaxCols + kNmMaxCols + kBC * wstream::kWarps;
template <typename W, int kBC> constexpr int kNmStages = wstream::ring_stages(
    kNmFloats<kBC> * (int)sizeof(float) + wstream::kSmemBudget -
        wstream::kSmemBudget / QWEN3TTS_NM_CTAS,
    kNmStageBytes<W>);
template <typename W, int kBC>
using NmRing = wstream::RingMem<kNmStages<W, kBC>, kNmStageBytes<W>>;
template <typename W, int kBC> constexpr int kNmSmem =
    (int)sizeof(NmRing<W, kBC>) + kNmFloats<kBC> * (int)sizeof(float);

// The CTA's share of W, once for each chunk of kBC rows of x.
struct NSched {
  Job jb;
  int reps;
  __device__ __forceinline__ bool job(int j, Job& out) const {
    if (j >= reps) return false;
    out = jb;
    return true;
  }
};

// This consumer thread's elements k = tid, tid + kThreads, ... (k < H) of
// rows b0 .. b0 + kBC of x (zeros past B) and of the norm weight, as float.
template <typename T, int kBC>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, const T* __restrict__ nw, int B,
                                          int b0, int H, float (&xr)[kBC][kPer],
                                          float (&wr)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = threadIdx.x + i * wstream::kThreads;
    wr[i] = k < H ? to_f(nw[k]) : 0.f;
#pragma unroll
    for (int bc = 0; bc < kBC; ++bc)
      xr[bc][i] = k < H && b0 + bc < B ? to_f(x[(size_t)(b0 + bc) * H + k]) : 0.f;
  }
}

// a_s[bc][k] = T((x[bc][k] * rsqrt(mean_k x[bc]^2 + eps)) * nw[k]) from the
// consumers' registers (load_rows).  Sums of squares per thread (k in
// increasing order), per warp, then the warps in order: the same bits in
// every CTA.  red: kBC * kWarps floats.  Ends with a cta_sync.
template <typename T, int kBC>
__device__ __forceinline__ void norm_rows(const float (&xr)[kBC][kPer], const float (&wr)[kPer],
                                          int H, float eps, float* a_s, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int bc = 0; bc < kBC; ++bc) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) ss = fmaf(xr[bc][i], xr[bc][i], ss);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[bc * wstream::kWarps + warp] = ss;
  }
  wstream::cta_sync();
#pragma unroll
  for (int bc = 0; bc < kBC; ++bc) {
    float tot = 0.f;
#pragma unroll
    for (int wi = 0; wi < wstream::kWarps; ++wi) tot += red[bc * wstream::kWarps + wi];
    const float rstd = rsqrtf(tot / (float)H + eps);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = tid + i * wstream::kThreads;
      if (k < H) a_s[bc * H + k] = rnd<T>(__fmul_rn(__fmul_rn(xr[bc][i], rstd), wr[i]));
    }
  }
  wstream::cta_sync();
}

// Grid: one CTA per column tile (ops/fused_block.py norm_matmul_geometry).
// The producers stream the tile's rows of W from kernel entry; the
// consumers have asked for their elements of x and of the norm weight
// before that, normalise while the first stages land, and multiply out of
// the ring.  Rows of x are taken kBC at a time, the tile streamed once for
// each.  No float atomics: the same bits every run.
template <typename T, typename W, int kBC>
__global__ void __launch_bounds__(wstream::kBlock, QWEN3TTS_NM_CTAS)
    norm_matmul_kernel(const __grid_constant__ NArgs<T, W> a) {
  constexpr int NS = kNmStages<W, kBC>;
  extern __shared__ __align__(128) char smem[];
  auto* ring_mem = reinterpret_cast<NmRing<W, kBC>*>(smem);
  float* a_s = reinterpret_cast<float*>(smem + sizeof(NmRing<W, kBC>));
  float* red = a_s + kBC * kMaxK;
  float* res = red + wstream::kRedFloats<kBC>;
  float* sc_s = res + kBC * kNmMaxCols;
  float* nred = sc_s + kNmMaxCols;

  const int tid = threadIdx.x, B = a.B, H = a.H, N = a.N;
  const int n0 = blockIdx.x * a.C, C = min(a.C, N - n0);
  const NSched sched = {wstream::make_job(a.w, N, n0, 0, 1, C, 0, H), (B + kBC - 1) / kBC};

  // asked for before the producers start, so that these few loads do not
  // queue behind the weights
  float xr[kBC][kPer], wr[kPer], sc = 0.f;
  if (tid < wstream::kThreads) {
    load_rows<T, kBC>(a.x, a.nw, B, 0, H, xr, wr);
    if (sizeof(W) == 1 && tid < C) sc = a.scale[n0 + tid];
  }
  wstream::ring_init(ring_mem);
#ifdef QWEN3TTS_NM_EMPTY  // tools/kernel_probe.py: the launch and the ring's set-up alone
  return;
#endif
  if (tid >= wstream::kThreads) {  // the producers
    wstream::produce(ring_mem, sched, QWEN3TTS_NM_IN_FLIGHT);
    return;
  }
  wstream::Consumer<NS, kNmStageBytes<W>> ring = {ring_mem, 0};
  WSTREAM_STAMP(0, 0);
#ifdef QWEN3TTS_STAMPS  // when the first stage lands (the consumers wait for it here)
  ring.acquire();
  WSTREAM_STAMP(0, 1);
#endif
  if (tid < C) sc_s[tid] = sc;

  for (int b0 = 0; b0 < B; b0 += kBC) {
    if (b0 > 0) load_rows<T, kBC>(a.x, a.nw, B, b0, H, xr, wr);
    norm_rows<T, kBC>(xr, wr, H, a.eps, a_s, nred);
    WSTREAM_STAMP(0, 2);
    wstream::stream_job<T, W, kBC>(ring, sched.jb, a_s, H, sc_s, red, res, b0 == 0 ? 1 : -1);
    WSTREAM_STAMP(1, 2);
    for (int i = tid; i < kBC * C; i += wstream::kThreads) {
      const int b = b0 + i / C;
      if (b < B) put(a.out + (size_t)b * N + n0 + i % C, res[i]);
    }
  }
  WSTREAM_STAMP(2, 2);
}

template <typename T, typename W, int kBC>
cudaError_t norm_matmul(const NArgs<T, W>& a, cudaStream_t st) {
  auto* kernel = norm_matmul_kernel<T, W, kBC>;
  constexpr int smem = kNmSmem<W, kBC>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int grid = (a.N + a.C - 1) / a.C;
  kernel<<<grid, wstream::kBlock, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename W>
int norm_matmul_run(const void* x, const void* nw, const void* w, const float* scale, void* out,
                    int B, int H, int N, int C, float eps, cudaStream_t st) {
  const NArgs<T, W> a = {static_cast<const T*>(x), static_cast<const T*>(nw),
                         static_cast<const W*>(w), scale, static_cast<T*>(out), B, H, N, C, eps};
  return (int)(B == 1 ? norm_matmul<T, W, 1>(a, st) : norm_matmul<T, W, 4>(a, st));
}

// ---------------------------------------------------------------------------
// C. fused_o_mlp: one cooperative launch, the weights through wstream.cuh.

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
//
// fused_norm_matmul: ceil(N / C) column tiles of C columns (a multiple of
// 8, at most 256), one CTA each; w_scale only with an int8 W.
int qwen3tts_fused_norm_matmul(int dtype, int w_int8, const void* x, const void* norm_w,
                               const void* w, const float* w_scale, void* out, int B, int H, int N,
                               int C, float eps, void* stream) {
  if (!shape_ok(B, H, N) || C < kVec || C % kVec != 0 || C > kNmMaxCols ||
      (w_int8 && w_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QWEN3TTS_NM(T, W) \
  return norm_matmul_run<T, W>(x, norm_w, w, w_scale, out, B, H, N, C, eps, st)
  if (dtype == 0 && !w_int8) QWEN3TTS_NM(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && w_int8) QWEN3TTS_NM(__nv_bfloat16, int8_t);
  if (dtype == 1 && !w_int8) QWEN3TTS_NM(float, float);
  if (dtype == 1 && w_int8) QWEN3TTS_NM(float, int8_t);
#undef QWEN3TTS_NM
  return (int)cudaErrorInvalidValue;
}

// fused_o_mlp.  ptrs: x, attn, wo, wo_scale, norm_w, gu, gu_scale, wd, wd_scale, out,
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
