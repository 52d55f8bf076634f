// Single-token GQA decode attention over the layer-stacked static KV cache,
// split across CTAs along the live range (split-K).
//
// Replaces qwen3tts_tpu/ops/flash_decode.py:flash_decode_stacked (its Pallas
// kernel _kernel), for a float cache and for the int8 cache with
// per-(slot, kv head) f32 scales.  Same function, not a block-by-block copy:
//
//   out[b, h] = sum_s softmax_s(q[b,h] . k[layer,b,s,h/G] * D^-0.5) v[layer,b,s,h/G]
//
// over the live slots s in [max(pad[b], pos - window + 1), pos], with an online
// softmax in float32.  A row with no live slot (pad > pos) returns exact zeros.
// With an int8 cache, k = f32(k_int8) * k_scale[layer,b,h/G,s] and likewise v
// (flash_decode.py:117-123); the kernel folds the scales into the products:
// score = k_scale * (q . f32(k_int8)), and p * v_scale multiplies v_int8.
//
// Bound: bytes.  A call reads the live K/V prefix of one layer once,
// p * KVH * D * 2 tensors * (2 bytes bf16 | 1 byte int8 + 4/D of scale): for
// the 0.6B talker (KVH 8, D 128) at pos 2000 that is 8.2 MB in bf16 (2.45 us
// at 3.35 TB/s), half that in int8.  The arithmetic (4 * G FLOPs per cached
// row element pair) is far below the card's ridge point.
//
// Design for the H100's 132 SMs.  The Pallas kernel walks a row's live
// blocks in order on one TPU core (grid (B,), a fori_loop over 256-slot
// blocks); carried over, that is KVH CTAs at batch 1, each walking its
// whole live range one DRAM latency after another.  Here:
//
//   * The grid is (KVH, B, splits).  The host chooses splits from S, B, KVH
//     and the SM count, never from pos (ops/flash_decode.py:num_splits):
//     about one CTA per SM, 16 splits at batch 1 on the 0.6B talker.  Each
//     CTA derives its own slice of the live range on the device from
//     pos/pad/window (split_bounds below, the formula of
//     ops/flash_decode.py:split_range), so a captured CUDA graph replays
//     right at every position.  A split with no live slot contributes
//     m = -inf, l = 0.
//   * In a CTA, each of the kWarps warps takes a pair of slots at a time, a
//     half-warp per slot: 16 lanes read a 256-byte bf16 row (16 bytes a
//     lane; 8 in int8), so one load instruction fetches two rows.  A tile is
//     kU pairs: 16 warps x 2 x 4 = 128 slots a round in bf16 or int8, so one
//     round of loads covers a CTA's slice at pos 2000 (126 slots).  Compute,
//     not bytes, set the first split design's time (a warp per slot: 10
//     shuffles and 2 expf per slot, all 8 slots of a tile folded even when
//     dead).  So a warp folds a tile whose pairs are all live without a
//     branch, skips the pairs past its slice in a partial one, and sums a
//     tile's 8 dot products by a reduce-scatter butterfly (8 shuffles where
//     8 all-reduces took 32), after which each lane exponentiates one score
//     and broadcasts it (fold_tile).  Each half-warp carries its own running
//     (max, sum, acc); the two merge by shuffles at the end.  Where a CTA
//     walks more than one tile (more rows, fewer splits), the next tile's
//     raw loads are issued before the current tile's dot products and
//     softmax (double-buffered registers).
//   * The probabilities stay expf(score - max) with q * D^-0.5, the
//     arithmetic of the plain version and of the kernel before.  An int8 KV
//     cache re-quantizes every new K/V row, so a last-bit change of an
//     attention output can flip one int8 rounding a layer later and move a
//     small model's output by 1e-4: a base-2 softmax (q * log2 e,
//     ex2.approx), 0.2 us faster at pos 2000, flips one cache entry of
//     chip_smoke.py's int8 parity model (tools/kernel_probe.py).  For the same reason a split takes
//     at least kMinChunk = 32 slots, so a short live range is folded by one
//     CTA, bit for bit as with one split.
//   * The merge runs in a fixed order.  A CTA merges its warps through
//     shared memory in warp order and writes its (m, l, acc[G][D]) in
//     float32 to a workspace.  The last CTA of each (kv head, row) to finish
//     merges the splits in split order and writes out.  It is found by an
//     atomic ticket, which it resets to 0 for the next launch or graph
//     replay; no atomic touches a sum, so two runs give the same bits.
//     What costs here is latency, not bytes (tools/kernel_probe.py stamps
//     each phase with %globaltimer): the merge issues every split's loads at
//     once, computes each weight exp(m_s - max m) once, and sums in
//     registers; the release is one thread's fence.acq_rel after the CTA
//     barrier (as CUTLASS's semaphores do), not a fence in every thread.  A
//     second merge kernel would add a launch (about 1 us for an empty kernel
//     in a graph).  A thread block cluster per (kv head, row), merging
//     through distributed shared memory, fits badly: the card holds only 7
//     clusters of 16 such CTAs at once (cudaOccupancyMaxActiveClusters), one
//     short of the 8 kv heads, and 8-CTA clusters halve the SMs that stream
//     the cache.
//   * No tensor cores: there are G = 2 query rows per kv head, against the
//     16 rows of an mma tile (64 of a wgmma), and the work is bytes-bound.
//   * A plain launch.  Programmatic dependent launch (this kernel's launch
//     overlapping its predecessor's tail) takes 0.7 us off each call of a
//     chain of flash-decode calls but adds 0.2 us where a PyTorch kernel
//     precedes each call, as in a decode step (tools/kernel_probe.py).
//
// Instantiated for the Qwen3 talker's head layout (head_dim 128, two query
// heads per kv head): q/out bfloat16 or float32, the cache in q's dtype or
// int8; and, as flash_decode_kernel_d64g4 at the end of this file, for
// head_dim 64 with four query heads per kv head, float cache only.  Built with nvcc -gencode
// arch=compute_90a,code=sm_90a into a shared library with a plain C interface
// (qwen3tts_tpu_torch/ops/flash_decode.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;    // head_dim
constexpr int kG = 2;      // query heads per kv head
constexpr int kEPL = 8;    // elements of a row per lane
constexpr int kLPR = kD / kEPL;  // lanes per row: a half-warp
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kWarps * 32 / kLPR;  // slots a CTA reads per load instruction
constexpr int kMaxSplits = 16;  // the final merge holds every split in registers
constexpr int kMinChunk = 32;  // slots a split takes at least

// One lane's kEPL elements of a cache row: the raw load and its conversion.
// kU: slot pairs per warp tile, sized so that two tiles of raw K/V loads fit
// the 128 registers a thread has at 512 threads.
template <typename KV> struct Lane;

template <> struct Lane<__nv_bfloat16> {
  using Raw = uint4;  // 16 bytes
  static constexpr int kU = 4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <> struct Lane<float> {
  struct Raw {
    float4 a, b;  // 32 bytes
  };
  static constexpr int kU = 2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float* o) {
    o[0] = r.a.x;
    o[1] = r.a.y;
    o[2] = r.a.z;
    o[3] = r.a.w;
    o[4] = r.b.x;
    o[5] = r.b.y;
    o[6] = r.b.z;
    o[7] = r.b.w;
  }
};

template <> struct Lane<int8_t> {
  using Raw = uint2;  // 8 bytes
  static constexpr int kU = 4;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float* o) {
    const char4 a = *reinterpret_cast<const char4*>(&r.x);
    const char4 b = *reinterpret_cast<const char4*>(&r.y);
    o[0] = static_cast<float>(a.x);
    o[1] = static_cast<float>(a.y);
    o[2] = static_cast<float>(a.z);
    o[3] = static_cast<float>(a.w);
    o[4] = static_cast<float>(b.x);
    o[5] = static_cast<float>(b.y);
    o[6] = static_cast<float>(b.z);
    o[7] = static_cast<float>(b.w);
  }
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// The live slots of row b, [lo, hi] inclusive (empty when lo > hi), and the
// slice [a, e] of it that split `split` of `splits` takes: ceil(n / splits)
// slots each but at least kMinChunk, in order, the last ones short or empty.
// The same formula as ops/flash_decode.py:live_range / split_range, which
// the CPU tests check.
__device__ __forceinline__ void split_bounds(int pos, int pad, int window, int S, int split,
                                             int splits, int& a, int& e) {
  int lo = pad;
  if (window > 0 && pos - window + 1 > lo) lo = pos - window + 1;
  if (lo < 0) lo = 0;
  const int hi = pos < S - 1 ? pos : S - 1;
  const int n = hi - lo + 1;
  if (n <= 0) {
    a = 0;
    e = -1;
    return;
  }
  const int chunk = max((n + splits - 1) / splits, kMinChunk);
  a = lo + split * chunk;
  e = a + chunk - 1 < hi ? a + chunk - 1 : hi;
}

// The raw K/V loads (and int8 scales) of a lane's slots s + u * kStride,
// u < U; slots past e are not loaded but zeroed, so that their p = 0 never
// meets a stale NaN or Inf in fold_tile.
template <typename KV, int U>
__device__ __forceinline__ void load_tile(const KV* kb, const KV* vb, const float* ks,
                                          const float* vs, size_t slot_stride, int s, int e,
                                          typename Lane<KV>::Raw (&kr)[U],
                                          typename Lane<KV>::Raw (&vr)[U], float (&ksc)[U],
                                          float (&vsc)[U]) {
  constexpr bool kQuant = sizeof(KV) == 1;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int su = s + u * kStride;
    if (su <= e) {
      kr[u] = Lane<KV>::load(kb + (size_t)su * slot_stride);
      vr[u] = Lane<KV>::load(vb + (size_t)su * slot_stride);
      if constexpr (kQuant) {
        ksc[u] = __ldg(ks + su);
        vsc[u] = __ldg(vs + su);
      }
    } else {
      kr[u] = typename Lane<KV>::Raw{};
      vr[u] = typename Lane<KV>::Raw{};
      ksc[u] = vsc[u] = 0.f;
    }
  }
}

// Folds one tile into a half-warp's running softmax.  Each half-warp holds
// one slot of a pair.  Its U * G dot products (NV of them) are summed over
// the 16 lanes by a reduce-scatter butterfly: at each level a lane keeps one
// half of its values and adds its partner's copy of that half, so NV values
// take NV - 1 + log2(kRep) shuffles, and then each lane holds one (pair,
// head) score, repeated on kRep lanes.  A lane exponentiates its own score;
// the tile's max and sum per head take two more butterflies, and the
// probabilities are broadcast for the value products.  s0 is the warp's
// first slot of the tile (live), s the lane's; pairs past e are skipped
// (warp-uniform: kFull says none is), a dead slot contributes p = 0.
template <typename KV, int U, bool kFull>
__device__ __forceinline__ void fold_tile(const typename Lane<KV>::Raw (&kr)[U],
                                          const typename Lane<KV>::Raw (&vr)[U],
                                          const float (&ksc)[U], const float (&vsc)[U], int s0,
                                          int s, int e, const float (&qr)[kG][kEPL],
                                          float (&m)[kG], float (&l)[kG],
                                          float (&acc)[kG][kEPL]) {
  static_assert(kG == 2, "one head bit in the butterfly");
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int NV = U * kG;        // dot products a lane starts with
  constexpr int kRep = kLPR / NV;   // lanes that end up holding each score
  constexpr unsigned kAll = 0xffffffffu;
  const int nu = kFull ? U : min(U, (e - s0) / kStride + 1);  // live pairs, >= 1
  const int hl = threadIdx.x % kLPR;  // lane within the half-warp
  float v[NV];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kk[kEPL];
    Lane<KV>::cvt(kr[u], kk);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float x = 0.f;
      if (u < nu) {
#pragma unroll
        for (int i = 0; i < kEPL; ++i) x = fmaf(qr[g][i], kk[i], x);
      }
      v[u * kG + g] = x;
    }
  }
  // reduce-scatter: after the level at offset `off` a lane keeps the upper
  // half of its values if its lane bit `off` is set
#pragma unroll
  for (int n = NV, off = kLPR / 2; n > 1; n /= 2, off /= 2) {
    const bool up = hl & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = up ? v[i + n / 2] : v[i];
      const float send = up ? v[i] : v[i + n / 2];
      v[i] = keep + __shfl_xor_sync(kAll, send, off);
    }
  }
#pragma unroll
  for (int off = kRep / 2; off > 0; off /= 2) v[0] += __shfl_xor_sync(kAll, v[0], off);
  const int j = hl / kRep, uo = j / kG, go = j % kG;  // this lane's (pair, head)
  float sc = v[0];
  float ks_u = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) ks_u = u == uo ? ksc[u] : ks_u;  // no dynamic register index
  if (uo >= nu || s + uo * kStride > e) {
    sc = -INFINITY;  // past the slice: contributes nothing
  } else if constexpr (kQuant) {
    sc *= ks_u;
  }
  // the tile's max per head: over the pair bits, then swap the head bit
  float mt = sc;
#pragma unroll
  for (int off = kRep * kG; off < kLPR; off *= 2) mt = fmaxf(mt, __shfl_xor_sync(kAll, mt, off));
  const float mt_o = __shfl_xor_sync(kAll, mt, kRep);
  float m_use[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float m_new = fmaxf(m[g], g == go ? mt : mt_o);
    // a half-warp with no live slot yet keeps m = -inf, l = 0, acc = 0
    m_use[g] = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m[g] - m_use[g]);
    l[g] *= corr;
#pragma unroll
    for (int i = 0; i < kEPL; ++i) acc[g][i] *= corr;
    m[g] = m_new;
  }
  const float p = expf(sc - (go == 0 ? m_use[0] : m_use[1]));  // 0 for a dead slot
  float ps = p;
#pragma unroll
  for (int off = kRep * kG; off < kLPR; off *= 2) ps += __shfl_xor_sync(kAll, ps, off);
  const float ps_o = __shfl_xor_sync(kAll, ps, kRep);
#pragma unroll
  for (int g = 0; g < kG; ++g) l[g] += g == go ? ps : ps_o;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u >= nu) break;
    float vv[kEPL];
    Lane<KV>::cvt(vr[u], vv);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      // the probability of (pair u, head g), from a lane that holds it
      const float pu = __shfl_sync(kAll, p, (u * kG + g) * kRep, kLPR);
      const float pv = kQuant ? pu * vsc[u] : pu;
#pragma unroll
      for (int i = 0; i < kEPL; ++i) acc[g][i] = fmaf(pv, vv[i], acc[g][i]);
    }
  }
}

// The last CTA's merge of one (kv head, row): out[g][d] = sum_s acc_s c_s /
// sum_s l_s c_s with c_s = exp(m_s - max_s m_s), the splits taken in split
// order.  Every split's (m, l) and a thread's acc of every split are loaded
// at once; each weight c_s and each denominator is computed once.
// G, D: the instance's query heads per kv head and head_dim (both instances
// merge alike).
template <typename T, int G = kG, int D = kD>
__device__ __forceinline__ void merge_splits(const float* __restrict__ ws_acc,
                                             const float* __restrict__ ws_ml, size_t row,
                                             int splits, T* __restrict__ out) {
  constexpr int GD = G * D;
  __shared__ float sm_m[kMaxSplits][G], sm_l[kMaxSplits][G], sm_mx[G], sm_den[G];
  const int tid = threadIdx.x;
  if (tid < splits * G) {  // split s = tid / G, head g = tid % G: (m, l) adjacent
    const float2 m_l = __ldcg(reinterpret_cast<const float2*>(ws_ml) + row * splits * G + tid);
    sm_m[tid / G][tid % G] = m_l.x;
    sm_l[tid / G][tid % G] = m_l.y;
  }
  float av[kMaxSplits];
  const float* acc = ws_acc + row * splits * GD + tid;  // split s at acc[s * GD]
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) av[s] = s < splits && tid < GD ? __ldcg(acc + s * GD) : 0.f;
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, sm_m[s][tid]);
    sm_mx[tid] = mx;
  }
  __syncthreads();
  if (tid < splits * G) {  // no live slot anywhere: every c_s = 0, the row exact zeros
    const float mx = sm_mx[tid % G];
    sm_m[tid / G][tid % G] = mx == -INFINITY ? 0.f : expf(sm_m[tid / G][tid % G] - mx);
  }
  __syncthreads();
  if (tid < G) {
    float den = 0.f;
    for (int s = 0; s < splits; ++s) den += sm_l[s][tid] * sm_m[s][tid];
    sm_den[tid] = den;
  }
  __syncthreads();
  if (tid >= GD) return;
  const int g = tid / D;
  float num = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < splits) num += av[s] * sm_m[s][g];
  store(out + tid, num / fmaxf(sm_den[g], 1e-30f));
}

// T: q/out dtype.  KV: cache dtype (T, or int8_t with scales).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(const T* __restrict__ q,      // [B, NH, D]
                    const KV* __restrict__ k,     // [L, B, S, KVH, D]
                    const KV* __restrict__ v,     // [L, B, S, KVH, D]
                    const float* __restrict__ ks,  // [L, B, KVH, S] (int8 cache only)
                    const float* __restrict__ vs,  // [L, B, KVH, S]
                    T* __restrict__ out,          // [B, NH, D]
                    const int* __restrict__ pos_p,  // [1]
                    const int* __restrict__ pad_p,  // [B]
                    float* __restrict__ ws_acc,   // [B, KVH, splits, G, D]
                    float* __restrict__ ws_ml,    // [B, KVH, splits, G, 2]
                    unsigned* __restrict__ ticket,  // [B, KVH], 0 between launches
                    int layer, int B, int S, int KVH, int window, float scale) {
  constexpr int D = kD, G = kG, EPL = kEPL, U = Lane<KV>::kU;
  constexpr int kStep = kStride * U;  // slots a CTA covers per round
  using Raw = typename Lane<KV>::Raw;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
  __shared__ float sm_c[kWarps][G];  // the warps' weights in the CTA's merge
  __shared__ float sm_mx[G];
  __shared__ bool sm_last;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane / kLPR;        // which slot of the warp's pair
  const int e0 = (lane % kLPR) * EPL;  // the lane's elements of a row
  const int NH = KVH * G;

  int a, e;
  split_bounds(*pos_p, pad_p[b], window, S, split, splits, a, e);

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * NH + (size_t)kvh * G + g) * D + e0;
#pragma unroll
    for (int i = 0; i < EPL; ++i) qr[g][i] = to_float(qp[i]) * scale;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  const size_t slot_stride = (size_t)KVH * D;
  const size_t base = ((size_t)layer * B + b) * (size_t)S * slot_stride
                      + (size_t)kvh * D + (size_t)e0;
  const KV* kb = k + base;
  const KV* vb = v + base;
  const size_t sbase = (((size_t)layer * B + b) * KVH + kvh) * (size_t)S;
  const float* ksb = ks ? ks + sbase : nullptr;
  const float* vsb = vs ? vs + sbase : nullptr;

  // Warp w owns the slot pairs a + 2w + kStride * j of the slice (a
  // half-warp per slot), U pairs at a time; the next tile's loads are in
  // flight while this one is folded.
  Raw kc[U], vc[U], kn[U], vn[U];
  float ksc[U], vsc[U], ksn[U], vsn[U];
  int s0 = a + 2 * warp;
  if (s0 <= e) load_tile<KV, U>(kb, vb, ksb, vsb, slot_stride, s0 + half, e, kc, vc, ksc, vsc);
  for (; s0 <= e; s0 += kStep) {
    const int s1 = s0 + kStep;
    if (s1 <= e) load_tile<KV, U>(kb, vb, ksb, vsb, slot_stride, s1 + half, e, kn, vn, ksn, vsn);
    if (s0 + (U - 1) * kStride <= e)  // every pair of the tile is live
      fold_tile<KV, U, true>(kc, vc, ksc, vsc, s0, s0 + half, e, qr, m, l, acc);
    else
      fold_tile<KV, U, false>(kc, vc, ksc, vsc, s0, s0 + half, e, qr, m, l, acc);
    if (s1 <= e) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        kc[u] = kn[u];
        vc[u] = vn[u];
        ksc[u] = ksn[u];
        vsc[u] = vsn[u];
      }
    }
  }

  // The warp's two half-warp states merged (lanes of half 0 keep the sum),
  // then the warps' states to shared memory.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m[g], kLPR);
    const float l_o = __shfl_xor_sync(0xffffffffu, l[g], kLPR);
    const float mx = fmaxf(m[g], m_o);
    const float c = mx == -INFINITY ? 0.f : expf(m[g] - mx);
    const float c_o = mx == -INFINITY ? 0.f : expf(m_o - mx);
    l[g] = l[g] * c + l_o * c_o;
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      acc[g][i] = acc[g][i] * c + __shfl_xor_sync(0xffffffffu, acc[g][i], kLPR) * c_o;
    m[g] = mx;
  }
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) sm_acc[warp][g][e0 + i] = acc[g][i];
    }
  }
  __syncthreads();

  // The CTA's state, its warps merged in warp order: (mx, den, num[d]) per
  // query head, num and den relative to mx.  A CTA with no live slot keeps
  // mx = -inf, den = 0, num = 0.  Each warp's weight is computed once.
  if (threadIdx.x < kWarps * G) {
    const int w = threadIdx.x / G, g = threadIdx.x % G;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, sm_m[i][g]);
    // a warp with no slot has m = -inf: c = 0
    sm_c[w][g] = mx == -INFINITY ? 0.f : expf(sm_m[w][g] - mx);
    if (w == 0) sm_mx[g] = mx;
  }
  __syncthreads();
  const size_t row = (size_t)b * KVH + kvh;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      num += sm_acc[w][g][d] * sm_c[w][g];
      den += sm_l[w][g] * sm_c[w][g];
    }
    if (splits == 1) {
      store(out + ((size_t)b * NH + (size_t)kvh * G + g) * D + d, num / fmaxf(den, 1e-30f));
    } else {
      const size_t part = row * splits + split;
      ws_acc[(part * G + g) * D + d] = num;
      if (d == 0) {
        ws_ml[(part * G + g) * 2] = sm_mx[g];
        ws_ml[(part * G + g) * 2 + 1] = den;
      }
    }
  }
  if (splits == 1) return;

  // The last CTA of this (kv head, row) to finish merges the splits.
  __syncthreads();  // every thread's partial stores are issued
  if (threadIdx.x == 0) {
    // release: the CTA's stores (ordered before by the barrier) are visible
    // at gpu scope before the ticket
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    sm_last = atomicAdd(ticket + row, 1u) == (unsigned)splits - 1;
    if (sm_last) asm volatile("fence.acq_rel.gpu;" ::: "memory");  // acquire
  }
  __syncthreads();
  if (!sm_last) return;
  merge_splits(ws_acc, ws_ml, row, splits, out + ((size_t)b * NH + (size_t)kvh * G) * D);
  if (threadIdx.x == 0) ticket[row] = 0u;  // ready for the next launch or replay
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, void* out, const int* pos, const int* pad, float* ws_acc,
                   float* ws_ml, unsigned* ticket, int layer, int B, int S, int KVH,
                   int window, float scale, int splits, cudaStream_t st) {
  flash_decode_kernel<T, KV><<<dim3(KVH, B, splits), kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<T*>(out),
      pos, pad, ws_acc, ws_ml, ticket, layer, B, S, KVH, window, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The instance for head_dim 64 with four query heads per kv head (the hybrid
// LFM2 talker's attention layers: 32 heads over 8), float cache only: a
// kernel of its own, flash_decode_kernel_d64g4, beside the instance above.
// The same function, the same split of the live range (split_bounds) and
// the same last-CTA merge (the ticket, merge_splits<T, 4, 64>); inside a
// CTA, each of the kWarps warps takes four slots at a time, a quarter-warp
// (8 lanes of 8 elements) per 128-byte bf16 row, kU such passes' loads in
// flight before the first is folded.  A quarter-warp sums its 4 heads' dot products by
// 3-level butterflies (every lane ends with all 4 scores) and keeps its own
// running (max, sum, acc) per head; the quarters merge by shuffles, the
// warps in warp order through shared memory.  The loop is warp-uniform
// (a dead slot scores -inf), so the shuffles never diverge.
namespace g4 {

constexpr int kD = 64, kG = 4, kEPL = 8, kLPR = kD / kEPL;  // 8 lanes a row
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kPer = 32 / kLPR;            // slots a warp reads per pass
constexpr int kStride = kWarps * kPer;     // slots a CTA reads per pass
constexpr int kU = 4;                      // passes in flight

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel_d64g4(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          const int* __restrict__ pos_p, const int* __restrict__ pad_p,
                          float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                          unsigned* __restrict__ ticket, int layer, int B, int S, int KVH,
                          int window, float scale) {
  constexpr int D = kD, G = kG, EPL = kEPL;
  using Raw = typename Lane<T>::Raw;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G], sm_acc[kWarps][G][D];
  __shared__ float sm_c[kWarps][G], sm_mx[G];
  __shared__ bool sm_last;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quarter = lane / kLPR, e0 = (lane % kLPR) * EPL;
  const int NH = KVH * G;
  int a, e;
  split_bounds(*pos_p, pad_p[b], window, S, split, splits, a, e);
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * NH + (size_t)kvh * G + g) * D + e0;
#pragma unroll
    for (int i = 0; i < EPL; ++i) qr[g][i] = to_float(qp[i]) * scale;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }
  const size_t slot_stride = (size_t)KVH * D;
  const size_t base = ((size_t)layer * B + b) * (size_t)S * slot_stride + (size_t)kvh * D + e0;
  // the warp's passes start at a + kPer w + kStride j; the quarter's slot is
  // the pass's start + quarter
  for (int s0 = a + kPer * warp; s0 <= e; s0 += kStride * kU) {
    Raw kr[kU], vr[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = s0 + u * kStride + quarter;
      if (s <= e) {
        kr[u] = Lane<T>::load(k + base + (size_t)s * slot_stride);
        vr[u] = Lane<T>::load(v + base + (size_t)s * slot_stride);
      } else {
        kr[u] = Raw{};
        vr[u] = Raw{};
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (s0 + u * kStride > e) break;  // warp-uniform: no slot of the pass is live
      const bool live = s0 + u * kStride + quarter <= e;
      float kk[EPL], vv[EPL], sc[G];
      Lane<T>::cvt(kr[u], kk);
      Lane<T>::cvt(vr[u], vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) x = fmaf(qr[g][i], kk[i], x);
#pragma unroll
        for (int off = kLPR / 2; off > 0; off /= 2) x += __shfl_xor_sync(kAll, x, off);
        sc[g] = live ? x : -INFINITY;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m_new = fmaxf(m[g], sc[g]);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = expf(m[g] - m_use);
        const float p = expf(sc[g] - m_use);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i] * corr);
        m[g] = m_new;
      }
    }
  }
  // the warp's four quarter states merged (every lane keeps the sum)
#pragma unroll
  for (int off = kLPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(kAll, m[g], off);
      const float l_o = __shfl_xor_sync(kAll, l[g], off);
      const float mx = fmaxf(m[g], m_o);
      const float c = mx == -INFINITY ? 0.f : expf(m[g] - mx);
      const float c_o = mx == -INFINITY ? 0.f : expf(m_o - mx);
      l[g] = l[g] * c + l_o * c_o;
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        acc[g][i] = acc[g][i] * c + __shfl_xor_sync(kAll, acc[g][i], off) * c_o;
      m[g] = mx;
    }
  }
  if (quarter == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) sm_acc[warp][g][e0 + i] = acc[g][i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kWarps * G) {
    const int w = threadIdx.x / G, g = threadIdx.x % G;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, sm_m[i][g]);
    sm_c[w][g] = mx == -INFINITY ? 0.f : expf(sm_m[w][g] - mx);
    if (w == 0) sm_mx[g] = mx;
  }
  __syncthreads();
  const size_t row = (size_t)b * KVH + kvh;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      num += sm_acc[w][g][d] * sm_c[w][g];
      den += sm_l[w][g] * sm_c[w][g];
    }
    if (splits == 1) {
      store(out + ((size_t)b * NH + (size_t)kvh * G + g) * D + d, num / fmaxf(den, 1e-30f));
    } else {
      const size_t part = row * splits + split;
      ws_acc[(part * G + g) * D + d] = num;
      if (d == 0) {
        ws_ml[(part * G + g) * 2] = sm_mx[g];
        ws_ml[(part * G + g) * 2 + 1] = den;
      }
    }
  }
  if (splits == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    sm_last = atomicAdd(ticket + row, 1u) == (unsigned)splits - 1;
    if (sm_last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (!sm_last) return;
  merge_splits<T, kG, kD>(ws_acc, ws_ml, row, splits,
                          out + ((size_t)b * NH + (size_t)kvh * G) * D);
  if (threadIdx.x == 0) ticket[row] = 0u;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* pos,
                   const int* pad, float* ws_acc, float* ws_ml, unsigned* ticket, int layer,
                   int B, int S, int KVH, int window, float scale, int splits, cudaStream_t st) {
  flash_decode_kernel_d64g4<T><<<dim3(KVH, B, splits), kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), pos, pad, ws_acc, ws_ml, ticket, layer, B, S, KVH, window, scale);
  return cudaGetLastError();
}

}  // namespace g4

}  // namespace

extern "C" {

// dtype (q and out): 0 = bfloat16, 1 = float32.  kv_int8: 0 = the cache is
// in q's dtype (ks/vs unused), 1 = int8 cache with f32 scales ks/vs
// [L, B, KVH, S].  window <= 0 means full attention.  splits (1 to 16) CTAs
// per (kv head, row); with splits > 1, ws_acc [B, KVH, splits, G, D] and ws_ml
// [B, KVH, splits, G, 2] are float32 scratch and ticket [B, KVH] uint32
// zeros, which every launch leaves at zero.  Returns the launch's
// cudaError_t (0 on success).
int qwen3tts_flash_decode(int dtype, int kv_int8, const void* q, const void* k,
                          const void* v, const void* ks, const void* vs, void* out,
                          const void* pos, const void* pad, void* ws_acc, void* ws_ml,
                          void* ticket, int layer, int B, int S, int NH, int KVH, int D,
                          int window, float scale, int splits, void* stream) {
  if (D == g4::kD && NH == g4::kG * KVH && !kv_int8 && splits >= 1 && splits <= kMaxSplits &&
      (splits == 1 || (ws_acc && ws_ml && ticket))) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pos_i = static_cast<const int*>(pos);
    const int* pad_i = static_cast<const int*>(pad);
    float* wa = static_cast<float*>(ws_acc);
    float* wm = static_cast<float*>(ws_ml);
    unsigned* tk = static_cast<unsigned*>(ticket);
    if (dtype == 0)
      return (int)g4::launch<__nv_bfloat16>(q, k, v, out, pos_i, pad_i, wa, wm, tk, layer, B, S,
                                            KVH, window, scale, splits, st);
    if (dtype == 1)
      return (int)g4::launch<float>(q, k, v, out, pos_i, pad_i, wa, wm, tk, layer, B, S, KVH,
                                    window, scale, splits, st);
    return (int)cudaErrorInvalidValue;
  }
  if (D != kD || NH != kG * KVH) return (int)cudaErrorInvalidValue;
  if (kv_int8 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos_i = static_cast<const int*>(pos);
  const int* pad_i = static_cast<const int*>(pad);
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  unsigned* tk = static_cast<unsigned*>(ticket);
  if (dtype == 0 && !kv_int8)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, out, pos_i, pad_i, wa,
                                                     wm, tk, layer, B, S, KVH, window, scale,
                                                     splits, st);
  if (dtype == 1 && !kv_int8)
    return (int)launch<float, float>(q, k, v, ks, vs, out, pos_i, pad_i, wa, wm, tk, layer, B,
                                     S, KVH, window, scale, splits, st);
  if (dtype == 0 && kv_int8)
    return (int)launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, out, pos_i, pad_i, wa, wm, tk,
                                              layer, B, S, KVH, window, scale, splits, st);
  if (dtype == 1 && kv_int8)
    return (int)launch<float, int8_t>(q, k, v, ks, vs, out, pos_i, pad_i, wa, wm, tk, layer,
                                      B, S, KVH, window, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
