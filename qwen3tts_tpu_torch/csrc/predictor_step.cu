// One code-predictor micro-step (proj + every decoder block + final norm)
// as ONE persistent, cooperative kernel launch.
//
// Replaces the Pallas kernel qwen3tts_tpu/ops/predictor_step.py:
// fused_micro_step (body _kernel).  For one token (batch 1), with T the
// activation, weight and cache dtype (bfloat16 or float32):
//
//   xp  = f32(x_emb @ Wp) + bp                       residual, float32 throughout
//   per layer l:
//     h   = T(rms(xp) * w_in)          q|k|v = h @ Wqkv (float32)
//     q,k = rope(headnorm(q|k) * w_q|k) in float32; v raw
//     cache[l, pos] = T(k), T(v)
//     attn = softmax(q . T(k_s) * D^-0.5 over slots s <= pos) @ T(v_s)   (float32)
//     xp += T(attn) @ Wo
//     h   = T(rms(xp) * w_post)        [g u] = h @ Wgu
//     xp += T(silu(g) * u) @ Wd
//   out = T(rms(xp) * w_final)
//
// This is the Pallas kernel's arithmetic, not the unfused block's: the
// residual is never rounded to T, q is not rounded before the scores, and
// the probabilities are not rounded before the value product.  Norm
// weights and the proj bias arrive in float32 (ops/predictor_step.py:
// micro_step_weights converts them once).
//
// Bound: bytes.  At the 0.6B predictor's shapes (Ht = Hp = 1024, 16/8
// heads of 64, I = 3072, 5 layers) one micro-step reads 127.9 MB of bf16
// weights (proj 2.1 MB; per layer qkv 4.19 + o 2.10 + gate|up 12.58 + down
// 6.29 MB), more than the 50 MB L2: ~38 us at 3.35 TB/s.  The cache (5 x 17
// slots) and the activations are a few hundred KB.
//
// Design.  The Pallas kernel walks its phases in a sequential grid and
// keeps the vectors in VMEM scratch between them.  Here the whole grid
// walks the phases together and meets at a grid-wide barrier
// (cooperative_groups grid sync) after each one: proj, then per layer
// qkv, attention, o, gate|up, down, and the final norm (2 + 5 L phases,
// 1 + 5 L barriers).  The vectors live in a float32 global workspace
// (xp [Hp], qkv [QT], attn [NH * D], act [I]) that the wrapper caches per
// shape; a phase re-reads its input row into shared memory through L2
// (__ldcg: L1 is not coherent across SMs) and, where a norm comes first,
// every CTA recomputes it, as the Pallas kernel does per grid step.
//
//   * Matrix phases: each CTA takes column tiles of the output over the
//     whole depth (gemv.cuh tile_dot), in turn over the grid, the tile
//     width chosen per phase so that at the 0.6B shapes each phase is one
//     round of tiles (a round waits out a DRAM latency); the owner of
//     a column is its only writer, so the residual add needs no atomics and
//     two runs give the same bits.  gate and up stream in one pass per
//     tile, and the activation is formed in the epilogue.
//   * Attention: one warp per query head (16 warps of the first CTAs).  A
//     lane holds D / 32 elements, so head-norm sums are shuffles and
//     rotate-half pairs lie in the same lane (D a multiple of 64).  Each
//     warp recomputes its kv head's k / v row; the first query head of the
//     group writes it to the cache, and every warp uses its own copy for
//     slot pos, so no warp reads a slot another writes in the launch.  The
//     scores take one slot per lane, so that the slots' loads overlap (a
//     warp that walks the slots one by one waits out a cache load per slot).
//   * The grid is the co-resident CTAs (occupancy x SMs, at most 2 per SM;
//     at ~180 registers a thread the H100 holds one: 132 CTAs), launched
//     with cudaLaunchKernelEx and the cooperative attribute, which stream
//     capture accepts.  A grid that cannot be co-resident fails the launch.
//
// pos comes from device memory (no host sync; graph-capturable).  It must
// lie in [0, S); the kernel writes no cache slot for a pos outside it.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (qwen3tts_tpu_torch/ops/predictor_step.py).

#include <cooperative_groups.h>
#include <math.h>

#include "gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using gemv::kThreads;
using gemv::kWarps;
using gemv::put;
using gemv::rnd;
using gemv::to_f;

// output columns per work item, per phase: at the 0.6B shapes each matrix
// phase is one round of tiles on the 132-CTA grid (proj, o, down: 1024 / 8;
// qkv: 2048 / 16; gate|up: 3072 / 32 column pairs)
constexpr int kCols = 8;
constexpr int kColsQKV = 16;
constexpr int kColsGU = 32;
constexpr int kMaxK = 4096;      // longest activation row in shared memory
constexpr int kMaxS = 64;        // most cache slots
constexpr int kMaxD = 128;       // largest head_dim
constexpr int kBlocksPerSM = 2;  // grid = SMs x min(occupancy, this)

template <typename T>
struct Args {
  const T* x;            // [Ht]
  const T* proj_w;       // [Ht, Hp]
  const float* proj_b;   // [Hp]
  const float* in_norm;  // [L, Hp]
  const float* post_norm;
  const float* q_norm;   // [L, D]
  const float* k_norm;
  const float* final_norm;  // [Hp]
  const T* qkv_w;        // [L, Hp, QT]
  const T* o_w;          // [L, NH * D, Hp]
  const T* gu_w;         // [L, Hp, 2 I]
  const T* dn_w;         // [L, I, Hp]
  const float* cos;      // [D]
  const float* sin;
  T* kv_k;               // [L, S, KVH, D], written in place
  T* kv_v;
  const int* pos;        // [1]
  T* out;                // [Hp]
  float* xp;             // workspace [Hp]
  float* qkv;            // [QT]
  float* attn;           // [NH * D]
  float* act;            // [I]
  int Ht, Hp, NH, KVH, D, I, L, S;
  float eps, scale;
};

// a_s[k] = T((v[k] * rstd) * w[k]) for the float32 row v (read through L2),
// rstd = rsqrt(mean(v^2) + eps).  Sums: per thread, per warp, warps in order.
template <typename T>
__device__ void load_normed(float* a_s, const float* v, int H, const float* w, float eps,
                            float* red) {
  const int tid = threadIdx.x;
  float ss = 0.f;
  for (int k = tid; k < H; k += kThreads) {
    const float x = __ldcg(v + k);
    a_s[k] = x;
    ss = fmaf(x, x, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) red[tid / 32] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) tot += red[wi];
  const float rstd = rsqrtf(tot / (float)H + eps);
  for (int k = tid; k < H; k += kThreads) a_s[k] = rnd<T>(__fmul_rn(__fmul_rn(a_s[k], rstd), w[k]));
  __syncthreads();
}

// a_s[k] = T(v[k]) for the float32 row v (read through L2).
template <typename T>
__device__ void load_rounded(float* a_s, const float* v, int K) {
  for (int k = threadIdx.x; k < K; k += kThreads) a_s[k] = rnd<T>(__ldcg(v + k));
  __syncthreads();
}

enum Epilogue { kSet, kAddBias, kAddResidual, kSwiGLU };

// dst[n] (n < N) from a_s @ W over depth K, one tile of C columns per CTA
// in turn.  kSwiGLU streams W's gate columns n and up columns N + n
// together (W is [K, 2N]) and stores silu(g) * u.
template <typename T, Epilogue E, int C = kCols>
__device__ void matvec_phase(const float* a_s, int K, const T* __restrict__ w, int N,
                             float* dst, const float* bias, float* red, float* res) {
  constexpr int kT = E == kSwiGLU ? 2 : 1;
  const int ldw = kT * N;
  for (int tile = blockIdx.x; tile < N / C; tile += gridDim.x) {
    const int n0 = tile * C;
    int col0[kT];
    col0[0] = n0;
    if (kT == 2) col0[kT - 1] = N + n0;
    gemv::tile_dot<T, C, kT>(a_s, K, w, ldw, col0, red, res);
    const int c = threadIdx.x;
    if (c < C) {
      const int n = n0 + c;
      if (E == kSet) dst[n] = res[c];
      if (E == kAddBias) dst[n] = res[c] + bias[n];
      if (E == kAddResidual) dst[n] = __ldcg(dst + n) + res[c];
      if (E == kSwiGLU) {
        const float g = res[c], u = res[C + c];
        dst[n] = __fmul_rn(__fmul_rn(g, 1.f / (1.f + expf(-g))), u);
      }
    }
  }
}

// x[j] (element lane + 32 j of a D-row) <- rope(x * rsqrt(mean(x^2) + eps) * w)
template <int E>
__device__ __forceinline__ void head_norm_rope(float (&x)[E], const float* w, const float* cos,
                                               const float* sin, float eps, int D) {
  const int lane = threadIdx.x % 32;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) ss = fmaf(x[j], x[j], ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rstd = rsqrtf(ss / (float)D + eps);
  float n[E];
#pragma unroll
  for (int j = 0; j < E; ++j) n[j] = __fmul_rn(__fmul_rn(x[j], rstd), w[lane + 32 * j]);
  // rotate_half: element d pairs with d +- D/2, i.e. j +- E/2 in this lane
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int d = lane + 32 * j;
    const float r = j < E / 2 ? -n[j + E / 2] : n[j - E / 2];
    x[j] = __fadd_rn(__fmul_rn(n[j], cos[d]), __fmul_rn(r, sin[d]));
  }
}

// One warp per query head h: q/k head-norm + rope, the cache write of slot
// pos, softmax attention over slots 0..pos; attn[h * D + d] in float32.
// Scores take one slot per lane, with the slot's row read in 16-byte loads
// that are all in flight at once; the value sum walks the slots unrolled, so
// that their loads overlap too.
template <typename T, int E>
__device__ void attention_phase(const Args<T>& a, int l, int pos, float* sc_all,
                                float* qk_all) {
  constexpr int D = 32 * E;
  constexpr int V = gemv::kVec<T>;
  constexpr int kChunk = 8;  // 16-byte loads of a row in flight per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x * kWarps + warp;
  if (h >= a.NH) return;
  const int KVH = a.KVH;
  const int kh = h / (a.NH / KVH);
  float q[E], k[E], v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int d = lane + 32 * j;
    q[j] = __ldcg(a.qkv + h * D + d);
    k[j] = __ldcg(a.qkv + (a.NH + kh) * D + d);
    v[j] = __ldcg(a.qkv + (a.NH + KVH + kh) * D + d);
  }
  head_norm_rope<E>(q, a.q_norm + l * D, a.cos, a.sin, a.eps, D);
  head_norm_rope<E>(k, a.k_norm + l * D, a.cos, a.sin, a.eps, D);
  // slot pos as the cache holds it
#pragma unroll
  for (int j = 0; j < E; ++j) {
    k[j] = rnd<T>(k[j]);
    v[j] = rnd<T>(v[j]);
  }
  const size_t layer_off = (size_t)l * a.S * KVH * D;
  const T* kc = a.kv_k + layer_off;
  const T* vc = a.kv_v + layer_off;
  const bool in_range = pos >= 0 && pos < a.S;
  if (h % (a.NH / KVH) == 0 && in_range) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const size_t i = layer_off + ((size_t)pos * KVH + kh) * D + lane + 32 * j;
      put(a.kv_k + i, k[j]);
      put(a.kv_v + i, v[j]);
    }
  }
  float* q_s = qk_all + warp * 2 * kMaxD;
  float* k_s = q_s + kMaxD;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    q_s[lane + 32 * j] = q[j];
    k_s[lane + 32 * j] = k[j];
  }
  __syncwarp();
  const int live = (pos < 0 ? -1 : min(pos, a.S - 1)) + 1;
  float* sc = sc_all + warp * kMaxS;
  for (int s = lane; s < live; s += 32) {
    float dot = 0.f;
    if (s == pos) {
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[d], k_s[d], dot);
    } else {
      const T* row = kc + ((size_t)s * KVH + kh) * D;
#pragma unroll
      for (int c0 = 0; c0 < D / V; c0 += kChunk) {
        uint4 raw[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (c0 + c < D / V) raw[c] = gemv::ld16(row + (c0 + c) * V);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c0 + c >= D / V) break;
          float kv[V];
          gemv::cvt16(raw[c], T(), kv);
#pragma unroll
          for (int i = 0; i < V; ++i) dot = fmaf(q_s[(c0 + c) * V + i], kv[i], dot);
        }
      }
    }
    sc[s] = dot * a.scale;
  }
  __syncwarp();
  float m = -INFINITY;
  for (int s = lane; s < live; s += 32) m = fmaxf(m, sc[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sum = 0.f;
  for (int s = lane; s < live; s += 32) {
    const float p = expf(sc[s] - m);
    sc[s] = p;
    sum += p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  __syncwarp();
  float o[E];
#pragma unroll
  for (int j = 0; j < E; ++j) o[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float p = sc[s] / sum;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float vs = s == pos ? v[j] : to_f(vc[((size_t)s * KVH + kh) * D + lane + 32 * j]);
      o[j] = fmaf(p, vs, o[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) a.attn[h * D + lane + 32 * j] = o[j];
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads) micro_step_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float a_s[kMaxK];
  __shared__ float red[kWarps * 2 * kColsGU];
  __shared__ float res[2 * kColsGU];
  __shared__ float sc[kWarps * kMaxS];
  __shared__ float qk[kWarps * 2 * kMaxD];
  const int pos = *a.pos;
  const int Hp = a.Hp, D = a.D, I = a.I;
  const int Dq = a.NH * D, QT = Dq + 2 * a.KVH * D;

  // proj: xp = x @ Wp + bp
  for (int k = threadIdx.x; k < a.Ht; k += kThreads) a_s[k] = to_f(a.x[k]);
  __syncthreads();
  matvec_phase<T, kAddBias>(a_s, a.Ht, a.proj_w, Hp, a.xp, a.proj_b, red, res);
  grid.sync();
  for (int l = 0; l < a.L; ++l) {
    // qkv = T(rms(xp) * w_in) @ Wqkv
    load_normed<T>(a_s, a.xp, Hp, a.in_norm + (size_t)l * Hp, a.eps, red);
    matvec_phase<T, kSet, kColsQKV>(a_s, Hp, a.qkv_w + (size_t)l * Hp * QT, QT, a.qkv, nullptr,
                                    red, res);
    grid.sync();
    attention_phase<T, E>(a, l, pos, sc, qk);
    grid.sync();
    // xp += T(attn) @ Wo
    load_rounded<T>(a_s, a.attn, Dq);
    matvec_phase<T, kAddResidual>(a_s, Dq, a.o_w + (size_t)l * Dq * Hp, Hp, a.xp, nullptr, red,
                                  res);
    grid.sync();
    // act = silu(g) * u, [g u] = T(rms(xp) * w_post) @ Wgu
    load_normed<T>(a_s, a.xp, Hp, a.post_norm + (size_t)l * Hp, a.eps, red);
    matvec_phase<T, kSwiGLU, kColsGU>(a_s, Hp, a.gu_w + (size_t)l * Hp * 2 * I, I, a.act,
                                      nullptr, red, res);
    grid.sync();
    // xp += T(act) @ Wd
    load_rounded<T>(a_s, a.act, I);
    matvec_phase<T, kAddResidual>(a_s, I, a.dn_w + (size_t)l * I * Hp, Hp, a.xp, nullptr, red,
                                  res);
    grid.sync();
  }
  if (blockIdx.x == 0) {
    load_normed<T>(a_s, a.xp, Hp, a.final_norm, a.eps, red);
    for (int k = threadIdx.x; k < Hp; k += kThreads) put(a.out + k, a_s[k]);
  }
}

// n grid-wide barriers and nothing else, on the micro-step's grid: the
// barrier's share of a micro-step, measured apart.
__global__ void __launch_bounds__(kThreads) barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

template <typename K>
int grid_for(K kernel) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return sms * (occ < kBlocksPerSM ? occ : kBlocksPerSM);
}

template <typename K, typename... A>
cudaError_t launch_cooperative(K kernel, int grid, cudaStream_t st, A... args) {
  if (grid <= 0) return grid < 0 ? (cudaError_t)(-grid) : cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int E>
cudaError_t micro_step(const Args<T>& a, cudaStream_t st) {
  static const int grid = grid_for(micro_step_kernel<T, E>);
  return launch_cooperative(micro_step_kernel<T, E>, grid, st, a);
}

template <typename T>
int run(int D, void* const* p, const int* dims, float eps, float scale, cudaStream_t st) {
  Args<T> a;
  a.x = static_cast<const T*>(p[0]);
  a.proj_w = static_cast<const T*>(p[1]);
  a.proj_b = static_cast<const float*>(p[2]);
  a.in_norm = static_cast<const float*>(p[3]);
  a.post_norm = static_cast<const float*>(p[4]);
  a.q_norm = static_cast<const float*>(p[5]);
  a.k_norm = static_cast<const float*>(p[6]);
  a.final_norm = static_cast<const float*>(p[7]);
  a.qkv_w = static_cast<const T*>(p[8]);
  a.o_w = static_cast<const T*>(p[9]);
  a.gu_w = static_cast<const T*>(p[10]);
  a.dn_w = static_cast<const T*>(p[11]);
  a.cos = static_cast<const float*>(p[12]);
  a.sin = static_cast<const float*>(p[13]);
  a.kv_k = static_cast<T*>(p[14]);
  a.kv_v = static_cast<T*>(p[15]);
  a.pos = static_cast<const int*>(p[16]);
  a.out = static_cast<T*>(p[17]);
  float* ws = static_cast<float*>(p[18]);
  a.Ht = dims[0]; a.Hp = dims[1]; a.NH = dims[2]; a.KVH = dims[3];
  a.D = dims[4]; a.I = dims[5]; a.L = dims[6]; a.S = dims[7];
  a.eps = eps;
  a.scale = scale;
  const int QT = (a.NH + 2 * a.KVH) * a.D;
  a.xp = ws;
  a.qkv = ws + a.Hp;
  a.attn = a.qkv + QT;
  a.act = a.attn + a.NH * a.D;
  if (D == 64) return (int)micro_step<T, 2>(a, st);
  return (int)micro_step<T, 4>(a, st);
}

}  // namespace

extern "C" {

// dtype (x, weights, cache, out): 0 = bfloat16, 1 = float32.  ptrs: x,
// proj_w, proj_b, in_norm, post_norm, q_norm, k_norm, final_norm, qkv_w,
// o_w, gu_w, dn_w, cos, sin, kv_k, kv_v, pos, out, workspace (float32,
// Hp + QT + NH * D + I).  dims: Ht, Hp, NH, KVH, D, I, L, S.  Returns the
// launch's cudaError_t (0 on success); cudaErrorInvalidValue for a shape
// without an instance.
int qwen3tts_micro_step(int dtype, void* const* ptrs, const int* dims, float eps, float scale,
                        void* stream) {
  const int Ht = dims[0], Hp = dims[1], NH = dims[2], KVH = dims[3], D = dims[4], I = dims[5],
            L = dims[6], S = dims[7];
  const int QT = (NH + 2 * KVH) * D;
  if ((D != 64 && D != 128) || KVH < 1 || NH % KVH != 0 || L < 1 || S < 1 || S > kMaxS ||
      Ht < 1 || Ht > kMaxK || Hp < kCols || Hp > kMaxK || Hp % kCols != 0 ||
      NH * D > kMaxK || QT % kColsQKV != 0 || I < kColsGU || I > kMaxK || I % kColsGU != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<__nv_bfloat16>(D, ptrs, dims, eps, scale, st);
  if (dtype == 1) return run<float>(D, ptrs, dims, eps, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The grid (CTAs) a micro-step launches with, or minus a cudaError_t.
int qwen3tts_micro_step_grid(int dtype, int D) {
  if (dtype == 0)
    return D == 64 ? grid_for(micro_step_kernel<__nv_bfloat16, 2>)
                   : grid_for(micro_step_kernel<__nv_bfloat16, 4>);
  return D == 64 ? grid_for(micro_step_kernel<float, 2>) : grid_for(micro_step_kernel<float, 4>);
}

// n grid barriers on a grid of `grid` CTAs (a cooperative launch).
int qwen3tts_grid_barriers(int grid, int n, void* stream) {
  return (int)launch_cooperative(barrier_kernel, grid, static_cast<cudaStream_t>(stream), n);
}

}  // extern "C"
