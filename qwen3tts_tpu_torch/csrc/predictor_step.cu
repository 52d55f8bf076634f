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
// slots) and the activations are a few hundred KB.  What the step loses
// time to beyond that is its 21 dependent matrix phases: each needs the
// whole vector of the phase before it, so a vector crosses the grid 21
// times, and a weight load issued only after that waits out a DRAM round
// trip while the memory system idles.
//
// Design.  The grid is one CTA per SM, launched cooperatively.  The phases
// are proj, then per layer qkv, o (with the attention folded in), gate|up
// and down: 1 + 4 L matrix phases, then the final norm.
//
//   * One weight stream through all phases (wstream.cuh).  In each phase a
//     CTA owns at most one item: a column tile (32 columns; 24 gate and 24
//     up columns at the 0.6B shapes) over one of KS row splits, chosen on
//     the host so that every phase has about one item per SM
//     (ops/predictor_step.py:phase_geometry).  The sequence of a CTA's items
//     is known at launch, so a ring of shared-memory stages filled by
//     cp.async runs ahead of the computation across the phases: when a
//     CTA gets to a phase its weights are already in shared memory and the
//     next phase's are in flight.  A phase waits only for the activation
//     vector and for its stage.
//   * The vectors between phases are float32 partial sums in a global
//     workspace, one row per row split, each float in an 8-byte word with
//     the tag of the phase that made it (wstream.cuh): a reader takes a
//     word when it carries the tag and sums the splits in split order.
//     Where every phase has the same number of items (the 0.6B and 1.7B
//     shapes: 128) every CTA hands something on in every phase, so the
//     tags alone order the phases and no grid barrier is left; other
//     shapes keep one after every phase (a CTA that skipped a phase could
//     fall behind the workspace's reuse).  Every CTA keeps its own copy of the float32 residual xp in
//     shared memory and adds each phase's partial sums to it with the same
//     arithmetic, so all copies hold the same bits and no CTA writes xp.
//     The owner of an output column is its only writer: no atomics, two
//     runs give the same bits.
//   * Attention is part of the o phase: a CTA needs only the heads whose
//     columns lie in its row split of Wo (4 of 16 at the 0.6B shapes), one
//     warp per head.  A lane holds D / 32 elements, so head-norm sums are
//     shuffles and rotate-half pairs lie in the same lane (D a multiple of
//     64).  Each warp recomputes its kv head's k / v row and uses its own
//     copy for slot pos; the CTA of column tile 0 whose split holds the
//     first query head of a group writes the row to the cache.  No CTA
//     reads a slot another writes in the launch.  The earlier slots' rows
//     are copied into shared memory (cp.async) at the end of the qkv
//     phase, so they have landed when the qkv vector has.
//
// pos comes from device memory (no host sync; graph-capturable).  It must
// lie in [0, S); the kernel writes no cache slot for a pos outside it.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (qwen3tts_tpu_torch/ops/predictor_step.py).

#include <math.h>

#include "wstream.cuh"

namespace {

using wstream::Job;
using wstream::kThreads;
using wstream::kWarps;
using wstream::put;
using wstream::rnd;
using wstream::to_f;

constexpr int kMaxK = 4096;   // longest activation row in shared memory
constexpr int kMaxHp = 2048;  // widest residual
constexpr int kMaxS = 64;     // most cache slots
constexpr int kMaxD = 128;    // largest head_dim
constexpr int kMaxO = 2048;   // most outputs of one item (columns x ranges)
constexpr int kKvBytes = 24576;  // the cache rows an o-phase item's attention reads
constexpr int kAttnWarps = 8;    // warps that take attention heads

enum Kind { kProj, kQKV, kO, kGU, kDown, kKinds };

// column tiles of C columns x KS row splits of chunk rows
struct Geo {
  int C, KS, chunk;
};

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
  uint64_t* px;          // workspace of tagged floats: proj / down partial sums [KS, Hp]
  uint64_t* pq;          // qkv partial sums [KS, QT]
  uint64_t* po;          // o partial sums [KS, Hp]
  uint64_t* act;         // silu(g) * u [I]
  unsigned* sync;        // the grid barrier's word, the next launch's tags, the CTAs done
  int Ht, Hp, NH, KVH, D, I, L, S;
  Geo geo[kKinds];
  int barriers;          // 1: a grid barrier after every phase; 0: the tags alone order them
  int items;             // without barriers: every phase has this many items
  float eps, scale;
};

constexpr int kSmemFloats = kMaxK + kMaxHp + kMaxO + wstream::kRedFloats<1> +
                            kAttnWarps * kMaxS + kAttnWarps * 2 * kMaxD + kWarps;
// ring stages: what the vectors and the cache rows leave of the shared memory
constexpr int kStages = wstream::ring_stages(kSmemFloats * (int)sizeof(float) + kKvBytes);
static_assert(kStages >= 2, "the ring needs two stages");
constexpr int kSmem =
    (int)sizeof(wstream::RingMem<kStages>) + kSmemFloats * (int)sizeof(float) + kKvBytes;

// depth K and width N of a phase kind
template <typename T>
__device__ __forceinline__ void kind_dims(const Args<T>& a, int kind, int& K, int& N) {
  const int Dq = a.NH * a.D;
  K = kind == kProj ? a.Ht : kind == kO ? Dq : kind == kDown ? a.I : a.Hp;
  N = kind == kQKV ? Dq + 2 * a.KVH * a.D : kind == kGU ? a.I : a.Hp;
}

// This CTA's item of phase p, or an empty job.  tile and ks as out
// parameters for the epilogue.
template <typename T>
struct Sched {
  const Args<T>* a;
  __device__ __forceinline__ static int kind_of(int p) { return p == 0 ? kProj : 1 + (p - 1) % 4; }
  __device__ __forceinline__ bool item(int p, Job& out, int& n0, int& C, int& ks) const {
    const Args<T>& A = *a;
    const int kind = kind_of(p), l = p == 0 ? 0 : (p - 1) / 4;
    int K, N;
    kind_dims(A, kind, K, N);
    const Geo g = A.geo[kind];
    const int tiles = (N + g.C - 1) / g.C;
    out = wstream::empty_job();
    n0 = C = ks = 0;
    if ((int)blockIdx.x >= tiles * g.KS) return true;
    ks = blockIdx.x / tiles;
    n0 = (blockIdx.x % tiles) * g.C;
    C = min(g.C, N - n0);
    const int k_lo = ks * g.chunk, k_hi = min(K, k_lo + g.chunk);
    const int ld = kind == kGU ? 2 * N : N;
    const T* w = kind == kProj ? A.proj_w
                 : kind == kQKV ? A.qkv_w + (size_t)l * K * ld
                 : kind == kO   ? A.o_w + (size_t)l * K * ld
                 : kind == kGU  ? A.gu_w + (size_t)l * K * ld
                                : A.dn_w + (size_t)l * K * ld;
    out = wstream::make_job(w, ld, n0, N + n0, kind == kGU ? 2 : 1, C, k_lo, k_hi);
    return true;
  }
  __device__ __forceinline__ bool job(int p, Job& out) const {
    if (p > 4 * a->L) return false;
    int n0, C, ks;
    return item(p, out, n0, C, ks);
  }
};

// xp_s[k] += sum_ks part[ks][k] (splits in order, each once it carries tag), then
// a_s[k] = T((xp_s[k] * rstd) * w[k]), rstd = rsqrt(mean(xp_s^2) + eps).
// Sums: per thread, per warp, warps in order.  With w == nullptr only the
// residual is brought up to date.
template <typename T>
__device__ void residual_norm(float* xp_s, float* a_s, const uint64_t* part, int KS, int H,
                              unsigned tag, const float* w, float eps, float* red,
                              wstream::RingMem<kStages>* ring_mem) {
  const int tid = threadIdx.x;
  constexpr int N = 4;  // elements a thread has in flight (times up to 4 splits)
  float ss = 0.f;
  for (int base = tid; base < H; base += N * kThreads) {
    int idx[N];
    bool ok[N];
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      idx[i] = base + i * kThreads;
      ok[i] = idx[i] < H;
    }
    wstream::sum_splits<N>(part, KS, (size_t)H, idx, ok, tag, s);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (ok[i]) {
        const float x = xp_s[idx[i]] + s[i];
        xp_s[idx[i]] = x;
        ss = fmaf(x, x, ss);
      }
    }
  }
  wstream::set_quiet(ring_mem, 0);  // what crossed the grid has been read
  if (w == nullptr) return;  // uniform over the CTA
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tid % 32 == 0) red[tid / 32] = ss;
  wstream::cta_sync();
  float tot = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) tot += red[wi];
  const float rstd = rsqrtf(tot / (float)H + eps);
  for (int k = tid; k < H; k += kThreads) a_s[k] = rnd<T>(__fmul_rn(__fmul_rn(xp_s[k], rstd), w[k]));
  wstream::cta_sync();
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

// Slots 0 .. min(pos, S) - 1 of kv heads [kh_lo, kh_lo + nkv) of layer l's
// cache, copied into kv_s as [k | v][nkv][S][D] with cp.async: issued
// before the barrier that opens the o phase (this launch writes none of
// these slots), waited for after it (kv_ready).
template <typename T>
__device__ void prefetch_kv(const Args<T>& a, int l, int pos, int kh_lo, int nkv, T* kv_s) {
  constexpr int V = 16 / (int)sizeof(T);
  const int D = a.D, S = a.S, KVH = a.KVH;
  const int rows = min(max(pos, 0), S), vpr = D / V;
  const size_t layer_off = (size_t)l * S * KVH * D;
  const int total = 2 * nkv * rows * vpr;
  for (int v = threadIdx.x; v < total; v += kThreads) {
    const int c = v % vpr, s = (v / vpr) % rows, hk = (v / vpr / rows) % nkv;
    const int t = v / vpr / rows / nkv;
    const T* src = (t ? a.kv_v : a.kv_k) + layer_off + ((size_t)s * KVH + kh_lo + hk) * D + c * V;
    wstream::cp_async16(wstream::smem_addr(kv_s + ((size_t)(t * nkv + hk) * S + s) * D + c * V),
                        src);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void kv_ready() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  wstream::cta_sync();
}

// One warp per query head h in [h_lo, h_hi]: q/k head-norm + rope, softmax
// attention over slots 0..pos; a_s[h * D + d] = T(attn).  The warp of the
// first query head of a group writes slot pos of the cache when `writer`
// and the head starts at or after column k_lo (each head starts in exactly
// one row split).  The cache rows of the earlier slots come from kv_s
// (prefetch_kv, for kv heads h_lo / G on).  Scores take one slot per lane.
template <typename T, int E>
__device__ void attention_heads(const Args<T>& a, int l, int pos, int h_lo, int h_hi, int k_lo,
                                bool writer, unsigned tag, const T* kv_s, float* a_s,
                                float* sc_all, float* qk_all) {
  constexpr int D = 32 * E;
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kChunk = 8;  // 16-byte loads of a row in flight per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KVH = a.KVH, G = a.NH / KVH;
  const int QT = (a.NH + 2 * KVH) * D;
  if (warp >= kAttnWarps) return;
  for (int h = h_lo + warp; h <= h_hi; h += kAttnWarps) {
    const int kh = h / G;
    // the head's q, k and v elements: the qkv phase's row splits, summed in order
    float q[E], k[E], v[E];
    {
      int idx[3 * E];
      bool ok[3 * E];
      float s[3 * E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int d = lane + 32 * j;
        idx[j] = h * D + d;
        idx[E + j] = (a.NH + kh) * D + d;
        idx[2 * E + j] = (a.NH + KVH + kh) * D + d;
        ok[j] = ok[E + j] = ok[2 * E + j] = true;
      }
      wstream::sum_splits<3 * E, 2>(a.pq, a.geo[kQKV].KS, (size_t)QT, idx, ok, tag, s);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        q[j] = s[j];
        k[j] = s[E + j];
        v[j] = s[2 * E + j];
      }
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
    const int kh_lo = h_lo / G, nkv = h_hi / G - kh_lo + 1;
    const T* kc = kv_s + (size_t)(kh - kh_lo) * a.S * D;           // [S][D] of this kv head
    const T* vc = kv_s + (size_t)(nkv + kh - kh_lo) * a.S * D;
    const bool in_range = pos >= 0 && pos < a.S;
    if (writer && h % G == 0 && h * D >= k_lo && in_range) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const size_t i = layer_off + ((size_t)pos * KVH + kh) * D + lane + 32 * j;
        put(a.kv_k + i, k[j]);
        put(a.kv_v + i, v[j]);
      }
    }
    float* q_s = qk_all + warp * 2 * kMaxD;
    float* k_s = q_s + kMaxD;
    __syncwarp();
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
        const T* row = kc + (size_t)s * D;
#pragma unroll
        for (int c0 = 0; c0 < D / V; c0 += kChunk) {
          uint4 raw[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            if (c0 + c < D / V) raw[c] = *reinterpret_cast<const uint4*>(row + (c0 + c) * V);
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            if (c0 + c >= D / V) break;
            const T* kv = reinterpret_cast<const T*>(&raw[c]);
#pragma unroll
            for (int i = 0; i < V; ++i) dot = fmaf(q_s[(c0 + c) * V + i], to_f(kv[i]), dot);
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
        const float vs = s == pos ? v[j] : to_f(vc[(size_t)s * D + lane + 32 * j]);
        o[j] = fmaf(p, vs, o[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) a_s[h * D + lane + 32 * j] = rnd<T>(o[j]);
    __syncwarp();  // sc, q_s and k_s are rewritten by the warp's next head
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(wstream::kBlock, 1) micro_step_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(128) char smem[];
  auto* ring_mem = reinterpret_cast<wstream::RingMem<kStages>*>(smem);
  float* a_s = reinterpret_cast<float*>(smem + sizeof(wstream::RingMem<kStages>));
  float* xp_s = a_s + kMaxK;
  float* res = xp_s + kMaxHp;
  float* red = res + kMaxO;
  float* sc = red + wstream::kRedFloats<1>;
  float* qk = sc + kAttnWarps * kMaxS;
  float* nred = qk + kAttnWarps * 2 * kMaxD;
  T* kv_s = reinterpret_cast<T*>(nred + kWarps);

  const int tid = threadIdx.x;
  const int Hp = a.Hp, D = a.D, I = a.I;
  const int QT = (a.NH + 2 * a.KVH) * D;
  Sched<T> sched = {&a};
  wstream::ring_init(ring_mem);
  const unsigned tag0 = wstream::launch_tags(a.sync);  // phase p's output carries tag0 + 1 + p
  if (tid >= kThreads) {  // the producers: every phase's item, from here on
    wstream::produce(ring_mem, sched);
    return;
  }
  wstream::Consumer<kStages> ring = {ring_mem, 0};
  WSTREAM_STAMP(0, 0);

  const int pos = *a.pos;
  for (int k = tid; k < Hp; k += kThreads) xp_s[k] = a.proj_b[k];
  const int phases = 1 + 4 * a.L;
  // without barriers a CTA reads only what its own items need, in time: one
  // without items would fall behind the buffers' reuse, and has nothing to do
  const int run = a.barriers || (int)blockIdx.x < a.items ? phases : 0;
  for (int p = 0; p < run; ++p) {
    const int kind = Sched<T>::kind_of(p), l = p == 0 ? 0 : (p - 1) / 4;
    Job jb;
    int n0, C, ks;
    sched.item(p, jb, n0, C, ks);
    const bool has = jb.k_lo < jb.k_hi;

    // the phase's activation row, a_s[k] for k in the item's row split
    if (kind == kProj) {
      for (int k = jb.k_lo + tid; k < jb.k_hi; k += kThreads) a_s[k] = to_f(a.x[k]);
    } else if (kind == kQKV) {
      residual_norm<T>(xp_s, a_s, a.px, l == 0 ? a.geo[kProj].KS : a.geo[kDown].KS, Hp, tag0 + p,
                       has ? a.in_norm + (size_t)l * Hp : nullptr, a.eps, nred, ring_mem);
    } else if (kind == kO) {
      kv_ready();
      if (has)
        attention_heads<T, E>(a, l, pos, jb.k_lo / D, (jb.k_hi - 1) / D, jb.k_lo, n0 == 0,
                              tag0 + p, kv_s, a_s, sc, qk);
#ifdef QWEN3TTS_ATTENTION_BARRIER  // tools/kernel_probe.py: what a phase of its own would add
      wstream::grid_barrier(a.sync);
#endif
    } else if (kind == kGU) {
      residual_norm<T>(xp_s, a_s, a.po, a.geo[kO].KS, Hp, tag0 + p,
                       has ? a.post_norm + (size_t)l * Hp : nullptr, a.eps, nred, ring_mem);
    } else {
      for (int k0 = jb.k_lo + tid; k0 < jb.k_hi; k0 += 4 * kThreads) {
        int idx[4];
        bool ok[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          idx[u] = k0 + u * kThreads;
          ok[u] = idx[u] < jb.k_hi;
        }
        wstream::sum_splits<4>(a.act, 1, 0, idx, ok, tag0 + p, v);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (ok[u]) a_s[idx[u]] = rnd<T>(v[u]);
      }
    }
    wstream::set_quiet(ring_mem, 0);  // what crossed the grid has been read
    wstream::cta_sync();

    if (has) {
      wstream::stream_job<T, T, 1>(ring, jb, a_s, 0, nullptr, red, res, p + 1);
      // the owner of a column (and split) is its only writer
      for (int c = tid; c < C; c += kThreads) {
        if (kind == kGU) {
          const float g = res[c], u = res[C + c];
          wstream::put_tagged(a.act + n0 + c, __fmul_rn(__fmul_rn(g, 1.f / (1.f + expf(-g))), u),
                              tag0 + 1 + p);
        } else {
          uint64_t* dst = kind == kQKV ? a.pq + (size_t)ks * QT
                          : kind == kO ? a.po + (size_t)ks * Hp
                                       : a.px + (size_t)ks * Hp;
          wstream::put_tagged(dst + n0 + c, res[c], tag0 + 1 + p);
        }
      }
    }
    if (kind == kQKV) {  // the cache rows of this CTA's o-phase item, ahead of the barrier
      Job jn;
      int n0n, Cn, ksn;
      sched.item(p + 1, jn, n0n, Cn, ksn);
      if (jn.k_lo < jn.k_hi) {
        const int G = a.NH / a.KVH, kh_lo = jn.k_lo / D / G;
        prefetch_kv<T>(a, l, pos, kh_lo, (jn.k_hi - 1) / D / G - kh_lo + 1, kv_s);
      }
    }
    WSTREAM_STAMP(p + 1, 2);
    if (a.barriers) {
      wstream::set_quiet(ring_mem, 1);
      wstream::grid_barrier(a.sync);
    }
    WSTREAM_STAMP(p + 2, 0);
  }
  if (blockIdx.x == 0) {
    residual_norm<T>(xp_s, a_s, a.px, a.geo[kDown].KS, Hp, tag0 + phases, a.final_norm, a.eps,
                     nred, ring_mem);
    for (int k = tid; k < Hp; k += kThreads) put(a.out + k, a_s[k]);
  }
  wstream::launch_done(a.sync, tag0, phases);
}

// n grid-wide barriers and nothing else, on the micro-step's grid: the
// barrier's share of a micro-step, measured apart.
__device__ unsigned g_probe_bar;
__global__ void __launch_bounds__(wstream::kBlock) barrier_kernel(int n) {
  if (threadIdx.x >= kThreads) return;
  for (int i = 0; i < n; ++i) wstream::grid_barrier(&g_probe_bar);
}

template <typename T, int E>
int grid_of() {
  static const int grid = wstream::coresident_grid(micro_step_kernel<T, E>, kSmem);
  return grid;
}

// every phase must fit the grid with one item per CTA
template <typename T>
bool fits(const Args<T>& a, int grid) {
  const int Dq = a.NH * a.D, QT = Dq + 2 * a.KVH * a.D;
  const int K[kKinds] = {a.Ht, a.Hp, Dq, a.Hp, a.I};
  const int N[kKinds] = {a.Hp, QT, a.Hp, a.I, a.Hp};
  // the cache rows of an o-phase item: its heads' kv heads x S slots
  const int G = a.NH / a.KVH, chunk = a.geo[kO].chunk;
  int nkv = 0;
  for (int k_lo = 0; k_lo < Dq; k_lo += chunk) {
    const int k_hi = k_lo + chunk < Dq ? k_lo + chunk : Dq;
    const int n = (k_hi - 1) / a.D / G - k_lo / a.D / G + 1;
    nkv = n > nkv ? n : nkv;
  }
  if ((long long)2 * nkv * a.S * a.D * (int)sizeof(T) > kKvBytes) return false;
  int items[kKinds];
  for (int k = 0; k < kKinds; ++k) {
    const Geo g = a.geo[k];
    items[k] = g.C >= 8 ? ((N[k] + g.C - 1) / g.C) * g.KS : 0;
    if (!a.barriers && items[k] != items[0]) return false;  // the tags alone need every CTA
    if (g.C < 8 || g.C % 8 != 0 || g.KS < 1 || g.chunk < 1 || (k == kGU && g.KS != 1) ||
        (long long)g.KS * g.chunk < K[k] || (long long)(g.KS - 1) * g.chunk >= K[k] ||
        (k == kGU ? 2 : 1) * g.C > kMaxO ||
        (long long)((N[k] + g.C - 1) / g.C) * g.KS > grid)
      return false;
  }
  return true;
}

template <typename T, int E>
cudaError_t micro_step(const Args<T>& a, cudaStream_t st) {
  const int grid = grid_of<T, E>();
  if (grid > 0 && !fits(a, grid)) return cudaErrorInvalidValue;
  return wstream::launch_cooperative(micro_step_kernel<T, E>, grid, kSmem, st, a);
}

template <typename T>
int run(int D, void* const* p, const int* dims, const int* geo, float eps, float scale,
        cudaStream_t st) {
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
  uint64_t* ws = static_cast<uint64_t*>(p[18]);
  a.sync = static_cast<unsigned*>(p[19]);
  a.Ht = dims[0]; a.Hp = dims[1]; a.NH = dims[2]; a.KVH = dims[3];
  a.D = dims[4]; a.I = dims[5]; a.L = dims[6]; a.S = dims[7];
  for (int k = 0; k < kKinds; ++k) a.geo[k] = {geo[3 * k], geo[3 * k + 1], geo[3 * k + 2]};
  a.barriers = geo[3 * kKinds];
#if defined(QWEN3TTS_FORCE_BARRIERS) || defined(QWEN3TTS_ATTENTION_BARRIER)
  a.barriers = 1;  // tools/kernel_probe.py: what the barriers cost
#endif
  a.items = a.geo[kProj].C >= 8 ? ((a.Hp + a.geo[kProj].C - 1) / a.geo[kProj].C) * a.geo[kProj].KS
                                : 0;
  a.eps = eps;
  a.scale = scale;
  const int QT = (a.NH + 2 * a.KVH) * a.D;
  const int ksx = a.geo[kProj].KS > a.geo[kDown].KS ? a.geo[kProj].KS : a.geo[kDown].KS;
  a.px = ws;
  a.pq = a.px + (size_t)ksx * a.Hp;
  a.po = a.pq + (size_t)a.geo[kQKV].KS * QT;
  a.act = a.po + (size_t)a.geo[kO].KS * a.Hp;
  if (D == 64) return (int)micro_step<T, 2>(a, st);
  return (int)micro_step<T, 4>(a, st);
}

}  // namespace

extern "C" {

// dtype (x, weights, cache, out): 0 = bfloat16, 1 = float32.  ptrs: x,
// proj_w, proj_b, in_norm, post_norm, q_norm, k_norm, final_norm, qkv_w,
// o_w, gu_w, dn_w, cos, sin, kv_k, kv_v, pos, out, workspace (8-byte words,
// zeroed once: max(KS_proj, KS_down) * Hp + KS_qkv * QT + KS_o * Hp + I),
// sync (uint32 [3], {0, 1, 0} once: wstream.cuh launch_tags).  dims: Ht, Hp,
// NH, KVH, D, I, L, S.  geo: (C, KS, chunk) for proj, qkv, o, gate|up,
// down: column tiles of C columns x KS row splits of chunk rows, at most one
// item per CTA of the grid (qwen3tts_micro_step_grid); then 1 for a grid
// barrier after every phase, or 0 where every phase has the same number of
// items and the tags alone order the phases.  Returns the launch's cudaError_t (0 on
// success); cudaErrorInvalidValue for a shape without an instance.
int qwen3tts_micro_step(int dtype, void* const* ptrs, const int* dims, const int* geo, float eps,
                        float scale, void* stream) {
  const int Ht = dims[0], Hp = dims[1], NH = dims[2], KVH = dims[3], D = dims[4], I = dims[5],
            L = dims[6], S = dims[7];
  if ((D != 64 && D != 128) || KVH < 1 || NH % KVH != 0 || L < 1 || S < 1 || S > kMaxS ||
      Ht < 1 || Ht > kMaxK || Ht % 8 != 0 || Hp < 8 || Hp > kMaxHp || Hp % 8 != 0 ||
      NH * D > kMaxK || I < 8 || I > kMaxK || I % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<__nv_bfloat16>(D, ptrs, dims, geo, eps, scale, st);
  if (dtype == 1) return run<float>(D, ptrs, dims, geo, eps, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The grid (CTAs) a micro-step launches with, or minus a cudaError_t.
int qwen3tts_micro_step_grid(int dtype, int D) {
  if (dtype == 0) return D == 64 ? grid_of<__nv_bfloat16, 2>() : grid_of<__nv_bfloat16, 4>();
  return D == 64 ? grid_of<float, 2>() : grid_of<float, 4>();
}

// n grid barriers on a grid of `grid` CTAs (a cooperative launch).
int qwen3tts_grid_barriers(int grid, int n, void* stream) {
  return (int)wstream::launch_cooperative(barrier_kernel, grid, 0,
                                          static_cast<cudaStream_t>(stream), n);
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
