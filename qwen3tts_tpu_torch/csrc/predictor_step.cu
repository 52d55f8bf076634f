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
using wstream::kVec;
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
  // R > 1 rows (micro_step_kernel_rows); every array above gains a row axis after
  // its split axis: x [R, Ht], kv_k [L, R, S, KVH, D], out [R, Hp], px [KS, R, Hp], ...
  int R;
  int owners, own_cols;  // CTA c < owners keeps the residual's columns [c own_cols, +own_cols)
  int workers;           // CTAs that take (row, head) attention pairs, pair i on CTA i % workers
  uint64_t* xr;          // the residual after each update [R, Hp], from its owners
  uint64_t* ssp;         // each owner's sums of squares of its columns [R, owners]
  uint64_t* at;          // attention output [R, NH * D]
  int as_stride;         // the row stride of the rows' activations in shared memory
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
    out.align = A.R > 1 ? 16 : 1;  // micro_step_kernel_rows's stages: whole 16-row k-steps
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

// ---------------------------------------------------------------------------
// R > 1 rows: micro_step_kernel_rows.  The same phases, items and weight stream as
// micro_step_kernel; what changes is what crosses the grid, which grows with R.
//
//   * Products: each weight tile is read from device memory once and used
//     by every row.  The rows' activations over the item's row split lie in
//     shared memory as T, row-major [16][AS] (rows R .. 15 zero, AS the
//     longest split plus 16 bytes, so that ldmatrix's 8 rows hit 8 bank
//     groups).  In bfloat16 a warp multiplies them on the tensor cores
//     (mma.sync m16n8k16, float32 accumulators: stream_mma): the rows are
//     the A operand, padded to 16; the stage's weight rows, read with
//     ldmatrix.trans, the B operand.  The warps take the stage's 16-row
//     k-steps in turn and fold their sums in warp order.  In float32 the
//     CUDA cores multiply (stream_rows: a thread's 8-column weight vector
//     times 4 rows, the 4-row groups dealt among the threads of a weight
//     row), so no product is rounded below float32.
//   * The residual is not kept by every CTA (R x Hp floats of shared memory
//     each, and every phase's partial sums read by every CTA: KS x R x Hp
//     tagged words, 512 KB a CTA at R 16 and the 0.6B shapes, which L2
//     could not serve each phase).  Its columns are dealt out to owner CTAs:
//     after proj, o and down each owner sums its columns' row splits in
//     split order into its residual and publishes the result (xr) and each
//     row's sum of squares over its columns (ssp), tagged.  A norm sums the
//     owners' ssp of each row in a fixed order and reads only the item's row
//     split of xr.  One hop more than at R 1.  (Owners that also normalize
//     their columns, after exchanging the sums of squares among themselves,
//     so that an item reads packed bf16, were slower: 291 against 243 us at
//     R 16; the exchange lengthens the path through the slowest owner.)
//   * Attention is a step of its own between qkv and o: (row, head) pair i
//     goes to warp i / workers of CTA i % workers, which sums the pair's
//     q / k / v from the qkv splits, writes the cache slot (the first head
//     of a group), attends over the earlier slots (prefetched into shared
//     memory after the qkv phase) and publishes the head's output (at,
//     tagged) for the o phase's items.  At R 1 each o item recomputes its
//     heads instead (no hop), which at R 16 would be 64 heads a CTA.
//   * The prologues read a column (k) of every row per thread, the rows'
//     words in flight together: no division by the row count.
//   * Tags: phase p's outputs carry tag0 + 1 + 2p, the step after it (the
//     owners' residual, the attention) tag0 + 2 + 2p.  Without barriers
//     every CTA with items has one in every phase, so the tags alone order
//     the phases as at R 1: a CTA rewrites a buffer only after reading
//     something that every reader of the buffer's last contents made after
//     reading them.
//   * Arithmetic per row is micro_step_kernel's: the residual in float32
//     (bias plus splits in split order, then each update), each activation
//     rounded to T before its product, products summed in float32; only the
//     order of the sums (the k-sums within an item, the norms' sums of
//     squares: per owner, then the owners in a fixed order) differs.
//
// Shared memory (bytes, besides the ring): activations, and the fold after
// an item, 66 K (kActBytes: bf16 rows of up to 2,104, float32 1,052; the
// gate|up phase's whole Hp of 1,024 at the 0.6B shapes); an item's outputs
// 8 K; the owned residual 4 K; attention 10 K; the pairs' cache rows 24 K:
// ~113 KB, which leaves 7 ring stages of 16 KB (9 at R 1).

constexpr int kRows = 16;           // most rows of one launch; the mma's rows
constexpr int kRB = 4;              // rows a float32 consumer thread multiplies at once
constexpr int kActBytes = 67584;    // activations [16][AS] of T over an item's rows; the fold after it
constexpr int kResFloats = 2048;    // an item's outputs [16][columns]
constexpr int kOwnFloats = 1024;    // an owner's residual columns [R][own_cols]
constexpr int kMaxNT = 8;           // 8-column tiles of one item's outputs, bfloat16
constexpr int kRowsSmemFloats = kActBytes / 4 + kResFloats + kOwnFloats + kAttnWarps * kMaxS +
                                kAttnWarps * 2 * kMaxD + kRows;
constexpr int kRowsStages = wstream::ring_stages(kRowsSmemFloats * (int)sizeof(float) + kKvBytes);
static_assert(kRowsStages >= 2, "the ring needs two stages");
constexpr int kRowsSmem = (int)sizeof(wstream::RingMem<kRowsStages>) +
                          kRowsSmemFloats * (int)sizeof(float) + kKvBytes;

// Stages a CTA's producers have in flight at once.  micro_step_kernel keeps
// one (a barrier's atomic or a partial sum waits behind every copy issued);
// here the prologues are long, and more did a little better (R 16: 246 us
// with 1, 242-244 with 2 to 4; R 2: 187 against 181-184).
constexpr int kRowsInFlight = 4;

__device__ __forceinline__ unsigned out_tag(unsigned tag0, int p) { return tag0 + 1 + 2 * p; }
__device__ __forceinline__ unsigned step_tag(unsigned tag0, int p) { return tag0 + 2 + 2 * p; }

// res[r * O1 + c] = sum over the job's rows k of a_s[r][k - k_lo] * W[k][column c],
// r < RP = kRB * BG, O1 = the job's columns (float32).  Thread (rg, bg, j)
// takes weight vector j of rows rg, rg + RG, ... of each stage, times rows
// bg kRB .. bg kRB + kRB - 1.  The row groups are then folded through shared
// memory in place of a_s (so a_s is spent), in a fixed order.
template <typename T, int NS>
__device__ void stream_rows(wstream::Consumer<NS>& ring, const Job& jb, float* a_s, int AS, int BG,
                            float* res, int stamp_phase) {
  constexpr int VB = kVec * (int)sizeof(T);
  constexpr int U = 4;  // weight rows a thread has in flight from shared memory
  const int RP = kRB * BG, rowbytes = jb.nt * jb.seg;
  const int LPR = rowbytes / VB, TG = LPR * BG, RG = kThreads / TG;
  const int tid = threadIdx.x, j = tid % LPR, bg = (tid / LPR) % BG, rg = tid / TG;
  const bool active = rg < RG;
  float acc[kRB][kVec];
#pragma unroll
  for (int b = 0; b < kRB; ++b)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[b][v] = 0.f;
  const float* arows = a_s + (size_t)bg * kRB * AS - jb.k_lo;
  const int rps = wstream::rows_per_stage(jb, wstream::kStageBytes);
  for (int row0 = jb.k_lo; row0 < jb.k_hi; row0 += rps) {
    const int rows = min(rps, jb.k_hi - row0);
    const char* mine = ring.acquire() + j * VB;
    if (row0 == jb.k_lo) WSTREAM_STAMP(stamp_phase, 1);
#ifdef QWEN3TTS_NO_COMPUTE  // tools/kernel_probe.py: the stream alone
    const int r_first = rows;
#else
    const int r_first = active ? rg : rows;
#endif
    for (int r0 = r_first; r0 < rows; r0 += U * RG) {
      wstream::Raw8<T> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * RG;
        if (r < rows) raw[u] = *reinterpret_cast<const wstream::Raw8<T>*>(mine + r * rowbytes);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * RG;
        if (r < rows) {
          float wv[kVec];
          wstream::cvt8<T>(raw[u], nullptr, wv);
#pragma unroll
          for (int b = 0; b < kRB; ++b) {
            const float ab = arows[(size_t)b * AS + row0 + r];
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[b][v] = fmaf(ab, wv[v], acc[b][v]);
          }
        }
      }
    }
    ring.release();
  }
  const int O1 = LPR * kVec, O = RP * O1, stride = O + 4;
  wstream::cta_sync();  // every thread is done with a_s
  float* red = a_s;
  if (active) {
#pragma unroll
    for (int b = 0; b < kRB; ++b) {
      float4* dst = reinterpret_cast<float4*>(red + rg * stride + (bg * kRB + b) * O1 + j * kVec);
      dst[0] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      dst[1] = make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
    }
  }
  wstream::cta_sync();
  // each output by P threads over the groups p, p + P, ... in order, then a
  // butterfly over the P neighbouring lanes (stream_job's fold)
  int P = 1;
  while (P < 32 && 2 * P * O <= kThreads) P *= 2;
  const int p = tid % P;
  for (int o0 = 0; o0 < O; o0 += kThreads / P) {
    const int o = o0 + tid / P;
    float s = 0.f;
    if (o < O)
      for (int g = p; g < RG; g += P) s += red[g * stride + o];
    for (int off = P >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (o < O && p == 0) res[o] = s;
  }
  wstream::cta_sync();
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the bf16 pair (k, k + 1) of a fragment word, zeroed where k >= v
__device__ __forceinline__ uint32_t keep_k(uint32_t w, int k, int v) {
  return k + 1 < v ? w : k < v ? (w & 0xffffu) : 0u;
}

// res[r * O1 + c] = sum over the job's rows k of a_s[r][k - k_lo] * W[k][column c]
// for all 16 rows (bfloat16, float32 sums; O1 = the job's columns, a multiple
// of 16, at most 8 tiles of 8).  Each stage's rows are cut into 16-row
// k-steps, step s to warp s % kWarps (the stage's last step masked to its
// rows); a warp keeps one m16n8 accumulator per 8-column tile over all its
// steps.  The warps' sums are then folded in warp order through shared
// memory in place of a_s (so a_s is spent).
template <int NS>
__device__ void stream_mma(wstream::Consumer<NS>& ring, const Job& jb, const __nv_bfloat16* a_s,
                           int AS, float* res, int stamp_phase) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rowbytes = jb.nt * jb.seg, O1 = rowbytes / 2, NT = O1 / 8;
  float acc[kMaxNT][4];
#pragma unroll
  for (int n = 0; n < kMaxNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // this lane's ldmatrix rows: A (x4: rows 0-7 / 8-15, k 0-7 / 8-15) and B
  // (x4.trans: k rows 0-7 / 8-15 of two 8-column tiles)
  const int lr = lane % 8 + ((lane / 8) & 1) * 8, lc = (lane / 16) * 8;
  const unsigned a_addr = wstream::smem_addr(a_s + (size_t)lr * AS + lc);
  const int t2 = (lane % 4) * 2;  // the k of this lane's first fragment element
  const int rps = wstream::rows_per_stage(jb, wstream::kStageBytes);
  for (int row0 = jb.k_lo; row0 < jb.k_hi; row0 += rps) {
    const int rows = min(rps, jb.k_hi - row0);
    const char* slot = ring.acquire();
    if (row0 == jb.k_lo) WSTREAM_STAMP(stamp_phase, 1);
#ifndef QWEN3TTS_NO_COMPUTE
    const unsigned b_base = wstream::smem_addr(slot) + lr * rowbytes + lc * 2;
    for (int k0 = warp * 16; k0 < rows; k0 += kWarps * 16) {
      const int v = rows - k0;  // the step's rows (16 or fewer)
      uint32_t a[4];
      ldsm_x4(a_addr + (unsigned)(row0 - jb.k_lo + k0) * 2, a);
      if (v < 16) {
        a[0] = keep_k(a[0], t2, v);
        a[1] = keep_k(a[1], t2, v);
        a[2] = keep_k(a[2], t2 + 8, v);
        a[3] = keep_k(a[3], t2 + 8, v);
      }
      const unsigned b_row = b_base + (unsigned)k0 * rowbytes;
#pragma unroll
      for (int n = 0; n < kMaxNT; n += 2) {
        if (n < NT) {
          uint32_t b[4];
          ldsm_x4_trans(b_row + n * 16, b);
          if (v < 16) {
            b[0] = keep_k(b[0], t2, v);
            b[1] = keep_k(b[1], t2 + 8, v);
            b[2] = keep_k(b[2], t2, v);
            b[3] = keep_k(b[3], t2 + 8, v);
          }
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }
#endif
    ring.release();
  }
  wstream::cta_sync();  // every warp is done with a_s
  float* red = reinterpret_cast<float*>(const_cast<__nv_bfloat16*>(a_s));
  const int g = lane / 4, O = kRows * O1;
#pragma unroll
  for (int n = 0; n < kMaxNT; ++n) {
    if (n < NT) {
      float* d = red + (size_t)warp * O + g * O1 + n * 8 + t2;
      *reinterpret_cast<float2*>(d) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(d + 8 * O1) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  wstream::cta_sync();
  for (int o = tid; o < O; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * O + o];
    res[o] = s;
  }
  wstream::cta_sync();
}

// v[r] = the float at p[r * W] once it carries `tag`, for the rows r < n (0
// past them): a thread's column of every row, every load in flight at once;
// where some are not ready, the thread waits on the first of them alone,
// then asks for the rest again together (sum_splits' way, with no index
// arrays).  More words at once spill registers: two columns took 243 to 340
// us at R 16, a column with the norm's sums of squares 406.
__device__ __forceinline__ void take_strided(const uint64_t* p, int W, int n, unsigned tag,
                                             float (&v)[kRows]) {
  uint64_t w[kRows];
  unsigned pending = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < n) w[i] = wstream::ld_tagged(p + (size_t)i * W);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < n && (unsigned)(w[i] >> 32) != tag) pending |= 1u << i;
  while (pending) {
    const uint64_t* one = p + (size_t)(__ffs(pending) - 1) * W;
    while ((unsigned)(wstream::ld_tagged(one) >> 32) != tag) {
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (pending >> i & 1) {
        w[i] = wstream::ld_tagged(p + (size_t)i * W);
        if ((unsigned)(w[i] >> 32) == tag) pending &= ~(1u << i);
      }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) v[i] = i < n ? __uint_as_float((unsigned)w[i]) : 0.f;
}

// a_s[r][k - k_lo] = T((x[r][k] * rstd_r) * w[k]) for k in [k_lo, k_hi), rows
// R .. 15 zero; x is the residual in xr, rstd_r = rsqrt(ss_r / Hp + eps) with
// ss_r the owners' sums of squares of row r (ssp), summed in a fixed order
// (thread q of the row's TPR over owners q, q + TPR, ..., then a butterfly).
// Words tagged `tag`; a thread reads column k of every row, all in flight.
template <typename T>
__device__ void norm_rows(const Args<T>& a, unsigned tag, const float* w, int k_lo, int k_hi,
                          T* a_s, int AS, float* rstd) {
  const int R = a.R, H = a.Hp, tid = threadIdx.x;
  int TPR = 32;
  while (TPR * R > kThreads) TPR >>= 1;
  {
    constexpr int N = 8;
    const int r = tid / TPR, q = tid % TPR;
    float ss = 0.f;
    for (int o0 = q; o0 < a.owners; o0 += N * TPR) {
      int idx[N];
      bool ok[N];
      float v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ok[i] = r < R && o0 + i * TPR < a.owners;
        idx[i] = r * a.owners + o0 + i * TPR;
      }
      wstream::sum_splits<N, 1>(a.ssp, 1, 0, idx, ok, tag, v);
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (ok[i]) ss += v[i];
    }
    for (int off = TPR >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (q == 0 && r < R) rstd[r] = rsqrtf(ss / (float)H + a.eps);
  }
  wstream::cta_sync();
  for (int k = k_lo + tid; k < k_hi; k += kThreads) {
    float v[kRows];
    take_strided(a.xr + k, H, R, tag, v);
    const float wk = w[k];
    T* dst = a_s + (k - k_lo);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      put(dst + (size_t)r * AS, r < R ? rnd<T>(__fmul_rn(__fmul_rn(v[r], rstd[r]), wk)) : 0.f);
  }
}

// a_s[r][k - k_lo] = T(src[r * W + k]) for k in [k_lo, k_hi), the words tagged
// `tag`; rows R .. 15 zero.
template <typename T>
__device__ void take_rows(const uint64_t* src, int W, int R, int k_lo, int k_hi, unsigned tag,
                          T* a_s, int AS) {
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) {
    float v[kRows];
    take_strided(src + k, W, R, tag, v);
    T* dst = a_s + (k - k_lo);
#pragma unroll
    for (int r = 0; r < kRows; ++r) put(dst + (size_t)r * AS, v[r]);
  }
}

// The owner's step after proj, o and down: for its columns c and every row,
// x[r][c] = (after proj: the bias; else x[r][c]) + the row splits of
// part[ks][r][c] (words tagged tag_in) summed in split order; published in
// xr, and each row's sum of squares over the owner's columns (a fixed tree
// over the OC lanes of the row) in ssp, with tag_out.
// Thread t takes row t / OC + i kThreads / OC, column t % OC (OC the owned
// columns rounded up to a power of two): the same elements at every step.
template <typename T>
__device__ void own_residual(const Args<T>& a, float* xo, const uint64_t* part, int KS,
                             unsigned tag_in, unsigned tag_out, bool first) {
  const int c0 = blockIdx.x * a.own_cols, nc = min(a.Hp, c0 + a.own_cols) - c0;
  if ((int)blockIdx.x >= a.owners || nc <= 0) return;
  const int R = a.R, H = a.Hp, tid = threadIdx.x;
  int OC = 1;
  while (OC < a.own_cols) OC *= 2;
  const int c = tid % OC;
  for (int r0 = 0; r0 < R; r0 += kThreads / OC) {
    const int r = r0 + tid / OC;
    const bool ok1 = r < R && c < nc;
    int idx[1] = {r * H + c0 + c};
    bool ok[1] = {ok1};
    float s[1];
    wstream::sum_splits<1>(part, KS, (size_t)R * H, idx, ok, tag_in, s);
    float ss = 0.f;
    if (ok1) {
      float* x = xo + r * a.own_cols + c;
      *x = (first ? a.proj_b[c0 + c] : *x) + s[0];
      wstream::put_tagged(a.xr + idx[0], *x, tag_out);
      ss = __fmul_rn(*x, *x);
    }
    for (int off = 1; off < OC; off <<= 1) ss += __shfl_down_sync(0xffffffffu, ss, off, OC);
    if (c == 0 && r < R) wstream::put_tagged(a.ssp + r * a.owners + blockIdx.x, ss, tag_out);
  }
}

// Slots 0 .. min(pos, S) - 1 of layer l's cache rows of this CTA's pairs'
// kv heads into kv_s [pair][k | v][S][D] (cp.async; kv_ready waits).
template <typename T>
__device__ void prefetch_pairs(const Args<T>& a, int l, int pos, T* kv_s) {
  constexpr int V = 16 / (int)sizeof(T);
  const int D = a.D, S = a.S, KVH = a.KVH, G = a.NH / KVH, R = a.R;
  const int rows = min(max(pos, 0), S), vpr = D / V, pairs = R * a.NH;
  const int ppc = (pairs + a.workers - 1) / a.workers;
  const int total = ppc * 2 * rows * vpr;
  for (int v = threadIdx.x; v < total; v += kThreads) {
    const int c = v % vpr, s = (v / vpr) % rows, t = (v / vpr / rows) % 2;
    const int pp = v / vpr / rows / 2, i = blockIdx.x + pp * a.workers;
    if (i >= pairs) continue;
    const int r = i / a.NH, kh = (i % a.NH) / G;
    const T* src = (t ? a.kv_v : a.kv_k) + ((((size_t)l * R + r) * S + s) * KVH + kh) * D + c * V;
    wstream::cp_async16(wstream::smem_addr(kv_s + ((size_t)(pp * 2 + t) * S + s) * D + c * V),
                        src);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One warp: the attention of row r's query head h at layer l (attention_heads'
// arithmetic for one head), kv_s this pair's earlier slots [k | v][S][D].
// Writes the cache slot pos of (r, h / G) when h is the group's first head;
// publishes at[r][h D + d] = T(attn) with tag_out.
template <typename T, int E>
__device__ void attend_pair(const Args<T>& a, int l, int pos, int r, int h, unsigned tag_in,
                            unsigned tag_out, const T* kv_s, float* sc, float* qk) {
  constexpr int D = 32 * E;
  constexpr int V = 16 / (int)sizeof(T);
  const int lane = threadIdx.x % 32;
  const int KVH = a.KVH, G = a.NH / KVH, kh = h / G, R = a.R;
  const int QT = (a.NH + 2 * KVH) * D;
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
    wstream::sum_splits<3 * E, 2>(a.pq + (size_t)r * QT, a.geo[kQKV].KS, (size_t)R * QT, idx,
                                  ok, tag_in, s);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      q[j] = s[j];
      k[j] = s[E + j];
      v[j] = s[2 * E + j];
    }
  }
  head_norm_rope<E>(q, a.q_norm + l * D, a.cos, a.sin, a.eps, D);
  head_norm_rope<E>(k, a.k_norm + l * D, a.cos, a.sin, a.eps, D);
#pragma unroll
  for (int j = 0; j < E; ++j) {
    k[j] = rnd<T>(k[j]);
    v[j] = rnd<T>(v[j]);
  }
  if (h % G == 0 && pos >= 0 && pos < a.S) {
    const size_t i0 = ((((size_t)l * R + r) * a.S + pos) * KVH + kh) * D + lane;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      put(a.kv_k + i0 + 32 * j, k[j]);
      put(a.kv_v + i0 + 32 * j, v[j]);
    }
  }
  const T* kc = kv_s;
  const T* vc = kv_s + (size_t)a.S * D;
  float* q_s = qk;
  float* k_s = qk + kMaxD;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    q_s[lane + 32 * j] = q[j];
    k_s[lane + 32 * j] = k[j];
  }
  __syncwarp();
  const int live = (pos < 0 ? -1 : min(pos, a.S - 1)) + 1;
  for (int s = lane; s < live; s += 32) {
    float dot = 0.f;
    if (s == pos) {
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[d], k_s[d], dot);
    } else {
      const T* row = kc + (size_t)s * D;
#pragma unroll
      for (int c = 0; c < D / V; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + c * V);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(q_s[c * V + i], to_f(kv[i]), dot);
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
    const float e = expf(sc[s] - m);
    sc[s] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  __syncwarp();
  float o[E];
#pragma unroll
  for (int j = 0; j < E; ++j) o[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float pr = sc[s] / sum;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float vs = s == pos ? v[j] : to_f(vc[(size_t)s * D + lane + 32 * j]);
      o[j] = fmaf(pr, vs, o[j]);
    }
  }
  uint64_t* dst = a.at + (size_t)r * a.NH * D + h * D + lane;
#pragma unroll
  for (int j = 0; j < E; ++j) wstream::put_tagged(dst + 32 * j, rnd<T>(o[j]), tag_out);
}

// Row r's final norm: out[r][k] = T((x[k] * rstd) * w_final[k]), x the
// residual in xr, rstd from the owners' sums of squares (ssp), summed in a
// fixed order (words tagged `tag`).  The whole CTA, one row.
template <typename T>
__device__ void final_row(const Args<T>& a, int r, unsigned tag, float* rstd) {
  constexpr int N = kMaxHp / kThreads;
  const int H = a.Hp, tid = threadIdx.x;
  if (tid < 32) {
    constexpr int M = 8;
    float ss = 0.f;
    for (int o0 = tid; o0 < a.owners; o0 += M * 32) {
      int idx[M];
      bool ok[M];
      float v[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        ok[i] = o0 + i * 32 < a.owners;
        idx[i] = r * a.owners + o0 + i * 32;
      }
      wstream::sum_splits<M, 1>(a.ssp, 1, 0, idx, ok, tag, v);
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (ok[i]) ss += v[i];
    }
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (tid == 0) rstd[0] = rsqrtf(ss / (float)H + a.eps);
  }
  int idx[N];
  bool ok[N];
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ok[i] = tid + i * kThreads < H;
    idx[i] = r * H + tid + i * kThreads;
  }
  wstream::sum_splits<N, 1>(a.xr, 1, 0, idx, ok, tag, v);
  wstream::cta_sync();
  const float rs = rstd[0];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int k = tid + i * kThreads;
    if (ok[i]) put(a.out + (size_t)r * H + k, rnd<T>(__fmul_rn(__fmul_rn(v[i], rs), a.final_norm[k])));
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(wstream::kBlock, 1) micro_step_kernel_rows(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(128) char smem[];
  using Ring = wstream::RingMem<kRowsStages>;
  auto* ring_mem = reinterpret_cast<Ring*>(smem);
  T* a_s = reinterpret_cast<T*>(smem + sizeof(Ring));  // [16][AS]; the fold after an item
  float* res = reinterpret_cast<float*>(smem + sizeof(Ring) + kActBytes);
  float* xo = res + kResFloats;
  float* sc = xo + kOwnFloats;
  float* qk = sc + kAttnWarps * kMaxS;
  float* rstd = qk + kAttnWarps * 2 * kMaxD;
  T* kv_s = reinterpret_cast<T*>(rstd + kRows);

  const int tid = threadIdx.x;
  const int R = a.R, AS = a.as_stride;
  const int Hp = a.Hp, D = a.D, I = a.I, Dq = a.NH * a.D;
  const int QT = Dq + 2 * a.KVH * D;
  Sched<T> sched = {&a};
  wstream::ring_init(ring_mem);
  const unsigned tag0 = wstream::launch_tags(a.sync);
  if (tid >= kThreads) {
    wstream::produce(ring_mem, sched, kRowsInFlight);
    return;
  }
  wstream::Consumer<kRowsStages> ring = {ring_mem, 0};
  WSTREAM_STAMP(0, 0);

  const int pos = *a.pos;
  const int phases = 1 + 4 * a.L, pairs = R * a.NH;
  const int run = a.barriers || (int)blockIdx.x < a.items ? phases : 0;
  for (int p = 0; p < run; ++p) {
    const int kind = Sched<T>::kind_of(p), l = p == 0 ? 0 : (p - 1) / 4;
    Job jb;
    int n0, C, ks;
    sched.item(p, jb, n0, C, ks);
    const bool has = jb.k_lo < jb.k_hi;
    WSTREAM_STAMP(p + 1, 0);

    if (has) {  // the item's activations over its row split, a_s[r][k - k_lo]
      if (kind == kProj) {
        for (int k = jb.k_lo + tid; k < jb.k_hi; k += kThreads) {
          float v[kRows];  // every row's load in flight before the first store
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] = r < R ? to_f(a.x[(size_t)r * a.Ht + k]) : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) put(a_s + (size_t)r * AS + k - jb.k_lo, v[r]);
        }
      } else if (kind == kQKV || kind == kGU) {
        norm_rows<T>(a, step_tag(tag0, p - 1),
                     (kind == kQKV ? a.in_norm : a.post_norm) + (size_t)l * Hp, jb.k_lo, jb.k_hi,
                     a_s, AS, rstd);
      } else if (kind == kO) {
        take_rows<T>(a.at, Dq, R, jb.k_lo, jb.k_hi, step_tag(tag0, p - 1), a_s, AS);
      } else {
        take_rows<T>(a.act, I, R, jb.k_lo, jb.k_hi, out_tag(tag0, p - 1), a_s, AS);
      }
    }
    wstream::cta_sync();

    if (has) {
      if constexpr (sizeof(T) == 2) {
        stream_mma(ring, jb, a_s, AS, res, p + 1);
      } else {
        stream_rows<T>(ring, jb, reinterpret_cast<float*>(a_s), AS, (R + kRB - 1) / kRB, res,
                       p + 1);
      }
      const int O1 = kind == kGU ? 2 * C : C;
      for (int e = tid; e < R * C; e += kThreads) {
        const int r = e / C, c = e % C;
        if (kind == kGU) {
          const float g = res[r * O1 + c], u = res[r * O1 + C + c];
          wstream::put_tagged(a.act + (size_t)r * I + n0 + c,
                              __fmul_rn(__fmul_rn(g, 1.f / (1.f + expf(-g))), u), out_tag(tag0, p));
        } else {
          uint64_t* dst = kind == kQKV ? a.pq + ((size_t)ks * R + r) * QT
                          : kind == kO ? a.po + ((size_t)ks * R + r) * Hp
                                       : a.px + ((size_t)ks * R + r) * Hp;
          wstream::put_tagged(dst + n0 + c, res[r * O1 + c], out_tag(tag0, p));
        }
      }
    }
    if (kind == kQKV && (int)blockIdx.x < a.workers) prefetch_pairs<T>(a, l, pos, kv_s);
    WSTREAM_STAMP(p + 1, 2);
    if (a.barriers) wstream::grid_barrier(a.sync);

    if (kind == kQKV) {  // attention: one warp per (row, head) pair
      kv_ready();
      const int warp = tid / 32, i = blockIdx.x + warp * a.workers;
      if (warp < kAttnWarps && (int)blockIdx.x < a.workers && i < pairs)
        attend_pair<T, E>(a, l, pos, i / a.NH, i % a.NH, out_tag(tag0, p), step_tag(tag0, p),
                          kv_s + (size_t)warp * 2 * a.S * D, sc + warp * kMaxS,
                          qk + warp * 2 * kMaxD);
    } else if (kind != kGU) {  // the owners' residual
      own_residual<T>(a, xo, kind == kO ? a.po : a.px, a.geo[kind].KS, out_tag(tag0, p),
                      step_tag(tag0, p), p == 0);
    }
    if (a.barriers) wstream::grid_barrier(a.sync);
  }
  WSTREAM_STAMP(phases + 1, 0);
  if (run && (int)blockIdx.x < R) final_row<T>(a, blockIdx.x, step_tag(tag0, phases - 1), rstd);
  WSTREAM_STAMP(phases + 1, 2);
  wstream::launch_done(a.sync, tag0, 2 * phases);
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
template <typename T, int E>
int rows_grid_of() {
  static const int grid = wstream::coresident_grid(micro_step_kernel_rows<T, E>, kRowsSmem);
  return grid;
}

// every phase must fit the grid with one item per CTA, and what an item
// keeps in shared memory must fit there
template <typename T>
bool fits(const Args<T>& a, int grid) {
  const int Dq = a.NH * a.D, QT = Dq + 2 * a.KVH * a.D;
  const int K[kKinds] = {a.Ht, a.Hp, Dq, a.Hp, a.I};
  const int N[kKinds] = {a.Hp, QT, a.Hp, a.I, a.Hp};
  const int G = a.NH / a.KVH;
  if (a.R == 1) {  // the cache rows of an o-phase item: its heads' kv heads x S slots
    const int chunk = a.geo[kO].chunk;
    int nkv = 0;
    for (int k_lo = 0; k_lo < Dq; k_lo += chunk) {
      const int k_hi = k_lo + chunk < Dq ? k_lo + chunk : Dq;
      const int n = (k_hi - 1) / a.D / G - k_lo / a.D / G + 1;
      nkv = n > nkv ? n : nkv;
    }
    if ((long long)2 * nkv * a.S * a.D * (int)sizeof(T) > kKvBytes) return false;
  } else {  // the rows' activations, outputs and fold; the owners; the attention pairs
    const int RP = kRB * ((a.R + kRB - 1) / kRB);
    const int ppc = (a.R * a.NH + a.workers - 1) / a.workers;
    if (a.R > kRows || a.workers < a.R || a.workers > grid || a.owners > grid ||
        a.own_cols < 1 || a.own_cols > 32 || (long long)a.owners * a.own_cols < a.Hp ||
        a.R * a.own_cols > kOwnFloats || ppc > kAttnWarps ||
        (long long)ppc * 2 * a.S * a.D * (int)sizeof(T) > kKvBytes ||
        (long long)kRows * a.as_stride * (int)sizeof(T) > kActBytes ||
        (!a.barriers && (a.workers != a.items || a.owners > a.items)))
      return false;
    for (int k = 0; k < kKinds; ++k) {
      const Geo g = a.geo[k];
      const int O1 = (k == kGU ? 2 : 1) * g.C, TG = O1 / kVec * (RP / kRB);
      if (g.chunk + 16 / (int)sizeof(T) > a.as_stride || kRows * O1 > kResFloats) return false;
      if (sizeof(T) == 2 ? O1 % 16 != 0 || O1 / 8 > kMaxNT || kWarps * kRows * O1 > kActBytes / 4
                         : TG > kThreads ||
                               (long long)(kThreads / TG) * (RP * O1 + 4) > kActBytes / 4)
        return false;
    }
  }
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

// a's shapes, geometry and rows from the C interface's dims and geo (see
// qwen3tts_micro_step), for a launch on `grid` CTAs.  At R > 1 the residual's
// columns and the (row, head) attention pairs are dealt among the CTAs that
// run: every CTA with an item, or the whole grid where the phases meet at
// barriers.  CTA c < owners keeps the columns [c own_cols, (c + 1) own_cols),
// a multiple of 8; pair i goes to CTA i % workers.
template <typename T>
void shape(Args<T>& a, const int* dims, const int* geo, int R, int grid) {
  a.Ht = dims[0]; a.Hp = dims[1]; a.NH = dims[2]; a.KVH = dims[3];
  a.D = dims[4]; a.I = dims[5]; a.L = dims[6]; a.S = dims[7];
  for (int k = 0; k < kKinds; ++k) a.geo[k] = {geo[3 * k], geo[3 * k + 1], geo[3 * k + 2]};
  a.barriers = geo[3 * kKinds];
#if defined(QWEN3TTS_FORCE_BARRIERS) || defined(QWEN3TTS_ATTENTION_BARRIER)
  a.barriers = 1;  // tools/kernel_probe.py: what the barriers cost
#endif
  a.items = a.geo[kProj].C >= 8 ? ((a.Hp + a.geo[kProj].C - 1) / a.geo[kProj].C) * a.geo[kProj].KS
                                : 0;
  a.R = R;
  a.owners = a.own_cols = a.workers = 0;
  if (R > 1) {
    a.workers = a.barriers ? grid : a.items;
    a.own_cols = a.workers < 1 ? 0 : kVec * ((a.Hp + kVec * a.workers - 1) / (kVec * a.workers));
    a.owners = a.own_cols < 1 ? 0 : (a.Hp + a.own_cols - 1) / a.own_cols;
  }
  a.as_stride = 0;
  for (int k = 0; k < kKinds; ++k)
    a.as_stride = a.geo[k].chunk > a.as_stride ? a.geo[k].chunk : a.as_stride;
  a.as_stride += 16 / (int)sizeof(T);  // 16 bytes: ldmatrix's rows in 8 bank groups
}

// the dims every instance needs, whatever the grid
bool dims_ok(const int* dims, int R) {
  const int Ht = dims[0], Hp = dims[1], NH = dims[2], KVH = dims[3], D = dims[4], I = dims[5],
            L = dims[6], S = dims[7];
  return (D == 64 || D == 128) && KVH >= 1 && NH % KVH == 0 && L >= 1 && S >= 1 &&
         S <= kMaxS && Ht >= 1 && Ht <= kMaxK && Ht % 8 == 0 && Hp >= 8 && Hp <= kMaxHp &&
         Hp % 8 == 0 && NH * D <= kMaxK && I >= 8 && I <= kMaxK && I % 8 == 0 && R >= 1 &&
         R <= kRows;
}

template <typename T, int E>
int grid_for(int R) {
  return R > 1 ? rows_grid_of<T, E>() : grid_of<T, E>();
}

// the owners of the residual's columns of a fitting launch (0 at R 1), or -1
template <typename T>
int instance(const int* dims, const int* geo, int R) {
  if (!dims_ok(dims, R)) return -1;
  const int grid = dims[4] == 64 ? grid_for<T, 2>(R) : grid_for<T, 4>(R);
  if (grid <= 0) return -1;
  Args<T> a;
  shape(a, dims, geo, R, grid);
  return fits(a, grid) ? a.owners : -1;
}

template <typename T>
int run(void* const* p, const int* dims, const int* geo, int R, float eps, float scale,
        cudaStream_t st) {
  const int D = dims[4];
  const int grid = D == 64 ? grid_for<T, 2>(R) : grid_for<T, 4>(R);
  if (grid <= 0) return grid < 0 ? -grid : (int)cudaErrorCooperativeLaunchTooLarge;
  Args<T> a;
  shape(a, dims, geo, R, grid);
  if (!fits(a, grid)) return (int)cudaErrorInvalidValue;
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
  a.eps = eps;
  a.scale = scale;
  const size_t rows = a.R, QT = (size_t)(a.NH + 2 * a.KVH) * a.D;
  const int ksx = a.geo[kProj].KS > a.geo[kDown].KS ? a.geo[kProj].KS : a.geo[kDown].KS;
  a.px = ws;
  a.pq = a.px + (size_t)ksx * rows * a.Hp;
  a.po = a.pq + (size_t)a.geo[kQKV].KS * rows * QT;
  a.act = a.po + (size_t)a.geo[kO].KS * rows * a.Hp;
  a.xr = a.act + rows * a.I;
  a.ssp = a.xr + rows * a.Hp;
  a.at = a.ssp + rows * a.owners;
  if (D == 64)
    return R > 1 ? (int)wstream::launch_cooperative(micro_step_kernel_rows<T, 2>, grid,
                                                     kRowsSmem, st, a)
                 : (int)wstream::launch_cooperative(micro_step_kernel<T, 2>, grid, kSmem, st, a);
  return R > 1 ? (int)wstream::launch_cooperative(micro_step_kernel_rows<T, 4>, grid, kRowsSmem,
                                                   st, a)
               : (int)wstream::launch_cooperative(micro_step_kernel<T, 4>, grid, kSmem, st, a);
}

}  // namespace

extern "C" {

// dtype (x, weights, cache, out): 0 = bfloat16, 1 = float32.  ptrs: x [R,
// Ht], proj_w, proj_b, in_norm, post_norm, q_norm, k_norm, final_norm,
// qkv_w, o_w, gu_w, dn_w, cos, sin, kv_k, kv_v [L, R, S, KVH, D], pos, out
// [R, Hp], workspace (8-byte words, zeroed once: max(KS_proj, KS_down) R Hp +
// KS_qkv R QT + KS_o R Hp + R I, and at R > 1 R (Hp + owners + NH D) more), sync
// (uint32 [3], {0, 1, 0} once: wstream.cuh launch_tags).  dims: Ht, Hp, NH,
// KVH, D, I, L, S.  geo: (C, KS, chunk) for proj, qkv, o, gate|up, down:
// column tiles of C columns x KS row splits of chunk rows, at most one item
// per CTA of the grid (qwen3tts_micro_step_grid); then 1 for a grid barrier
// after every phase, or 0 where every phase has the same number of items
// and the tags alone order the phases.  R: the rows (1-16).  The grid, and at
// R > 1 the owners of the residual's columns and the CTAs that take attention
// pairs, follow from these (shape).  Returns the launch's cudaError_t (0 on
// success); cudaErrorInvalidValue for a shape without an instance
// (qwen3tts_micro_step_instance).
int qwen3tts_micro_step(int dtype, void* const* ptrs, const int* dims, const int* geo, int R,
                        float eps, float scale, void* stream) {
  if (!dims_ok(dims, R)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<__nv_bfloat16>(ptrs, dims, geo, R, eps, scale, st);
  if (dtype == 1) return run<float>(ptrs, dims, geo, R, eps, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Whether qwen3tts_micro_step has an instance for dtype, dims, geo and R (as
// there): the owners of the residual's columns (0 at R 1), which size the
// workspace, or -1 where it has none.  The one check of a shape: the launch
// makes the same.
int qwen3tts_micro_step_instance(int dtype, const int* dims, const int* geo, int R) {
  if (dtype == 0) return instance<__nv_bfloat16>(dims, geo, R);
  if (dtype == 1) return instance<float>(dims, geo, R);
  return -1;
}

// The grid (CTAs) a micro-step of one row (rows 1) or of 2-16 rows (rows 2)
// launches with, or minus a cudaError_t.
int qwen3tts_micro_step_grid(int dtype, int D, int rows) {
  if (rows > 1) {
    if (dtype == 0)
      return D == 64 ? rows_grid_of<__nv_bfloat16, 2>() : rows_grid_of<__nv_bfloat16, 4>();
    return D == 64 ? rows_grid_of<float, 2>() : rows_grid_of<float, 4>();
  }
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
