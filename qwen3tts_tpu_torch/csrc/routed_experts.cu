// The decode step's routed-expert FFN of the hybrid (LFM2) talker, for 1 to
// 16 rows, as three launches on fixed grids, routing on the device:
//
//   s   = sigmoid(h @ W_router)                     (float32)
//   idx = top_k(s + expert_bias)                    (the bias only chooses)
//   g   = s[idx] / (sum s[idx] + 1e-6) * scale      (norm_topk_prob)
//   out = x + sum_k g_k W2_k(silu(W1_k h) * W3_k h)
//
// with W1|W3 stored [E, H, 2I] (gate columns, then up columns) and W2
// [E, I, H], matrices [in, out].  Plain version:
// ops/routed_experts.py:routed_experts_plain.
//
// Bound: bytes.  A step reads every touched expert's 3 H I weights once
// (2 bytes each); at 16 rows, top 4 of 32, about 28 experts a layer are
// touched (32 (1 - (28/32)^16)), 616 MB a layer at the LFM2-8B-A1B widths,
// 184 us at 3.35 TB/s.  The products (at most 16 rows) are far below the
// tensor cores' ridge point.
//
// Design:
//
//   * routed_experts_route_kernel (one CTA of 16 warps): the router's logits
//     for every (row, expert), bf16 products summed in float32 on the tensor
//     cores as below (each warp a slice of H, the slices summed in order; a
//     CUDA-core loop over the router read in place cost a device-memory
//     latency a row, 164 us a call on the H100, and 40 us with the router in shared
//     memory), the
//     sigmoid, the top k per row (ties to the lower expert), the weights g,
//     and the lists the other two launches read: each expert's rows in row
//     order with their g, each row's experts in expert order with the row's
//     place in the expert's list.  It also adds to the layer's counters
//     (rows per expert, experts touched, calls): one CTA writes them, so
//     plain adds suffice and a captured graph accumulates them on replay.
//   * routed_experts_gateup_kernel, grid (I / 64, E): CTA (c, e) computes
//     columns [64 c, 64 c + 64) of expert e's gate and up for its rows and
//     writes g * silu(gate) * up, rounded to bf16, to a workspace [E, 16, I].
//     A CTA of an untouched expert returns at once: no weight of it is read.
//     Its 8 warps split H; a warp multiplies on the tensor cores (mma.sync
//     m16n8k16, float32 accumulators): the expert's rows (gathered from h
//     into shared memory; rows past its count are never stored) are the A
//     operand, read with ldmatrix; the weights are the B operand, read
//     straight from device memory into registers (a ring of k-steps, the
//     loads a few steps ahead of the products), 16 bytes a load: lane
//     (g, t) loads rows 2t, 2t+1, 2t+8, 2t+9 of the k-step at columns
//     8g .. 8g+7 and pairs the rows with byte permutes, so that mma tile j
//     takes columns 8n + j (n the mma's column): a warp reads each k-step
//     as 16 whole 128-byte row segments.  The warps' sums are folded in
//     warp order through shared memory.
//   * routed_experts_down_kernel, grid (H / 64, E): the same product over
//     the workspace rows and W2's columns, each (expert, column block)
//     partial sum in float32 to a workspace; the last CTA of a column block
//     to finish (an atomic ticket, reset for the next launch or replay)
//     adds, per row, x and the row's experts' partials in expert order and
//     writes out in x's dtype.  No atomic touches a sum: two runs give the
//     same bits.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (ops/routed_experts.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // most rows of one call: the mma's rows
constexpr int kMaxE = 32;     // experts (one warp's lanes in the router)
constexpr int kMaxK = 8;      // experts a token
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;     // output columns of a CTA (8 mma tiles of 8)
constexpr int kRouteThreads = 512;
constexpr int kRouteWarps = kRouteThreads / 32;  // each a slice of the router's rows

// the routing lists in one int32 workspace
struct Lists {
  int* cnt;    // [E] rows routed to each expert
  int* rows;   // [E][16] each expert's rows, in row order
  int* sel;    // [16][K] each row's experts, in expert order
  int* slot;   // [16][K] the row's place in that expert's list
};

__device__ __forceinline__ Lists lists(int* ws, int E, int K) {
  return {ws, ws + E, ws + E + E * kRows, ws + E + E * kRows + kRows * K};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
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

__device__ __forceinline__ uint4 ld_stream(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The B operand of mma tile j from two rows' 16-byte loads (columns
// 8g .. 8g+7): the bf16 pair (row a, row b) of column 8g + j.
__device__ __forceinline__ uint32_t pair(const uint4& a, const uint4& b, int j) {
  const uint32_t wa = word(a, j / 2), wb = word(b, j / 2);
  return (j & 1) ? __byte_perm(wa, wb, 0x7632) : __byte_perm(wa, wb, 0x5410);
}

// One k-step's raw weight loads of a warp: rows 2t, 2t+1, 2t+8, 2t+9 of
// the k-step at columns col[h] + 8g .. + 7 of each column block h (zeros
// at columns N and past: a block wider than the matrix, the router's).
template <int NH>
__device__ __forceinline__ void load_step(const __nv_bfloat16* __restrict__ w, int N,
                                          const int (&col)[NH], int k, uint4 (&raw)[NH][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (col[h] + 8 * g >= N) {
      raw[h][0] = raw[h][1] = raw[h][2] = raw[h][3] = uint4{};
      continue;
    }
    const __nv_bfloat16* p = w + (size_t)(k + 2 * t) * N + col[h] + 8 * g;
    raw[h][0] = ld_stream(p);
    raw[h][1] = ld_stream(p + N);
    raw[h][2] = ld_stream(p + 8 * (size_t)N);
    raw[h][3] = ld_stream(p + 9 * (size_t)N);
  }
}

// A warp's product of the 16 shared rows (a_s, row stride AS elements) over
// K rows [k_lo, k_hi) of W ([K, N] row-major, 16 | k_hi - k_lo) into the
// accumulators of NH column blocks of 64 (block h at column col[h]).  The
// loads run U k-steps ahead of the products (a ring of U + 1 steps of
// registers), so that a warp always has U steps of loads in flight; the
// first U are issued before the rows that gather_rows started have landed.
template <int NH, int U>
__device__ __forceinline__ void warp_product(const __nv_bfloat16* a_s, int AS,
                                             const __nv_bfloat16* __restrict__ w, int N,
                                             const int (&col)[NH], int k_lo, int k_hi,
                                             float (&acc)[NH][8][4]) {
  const int lane = threadIdx.x % 32;
  const int lr = lane % 8 + ((lane / 8) & 1) * 8, lc = (lane / 16) * 8;
  const unsigned a_base = smem_addr(a_s + (size_t)lr * AS + lc);
  uint4 raw[U + 1][NH][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (k_lo + 16 * u < k_hi) load_step<NH>(w, N, col, k_lo + 16 * u, raw[u]);
  asm volatile("cp.async.wait_group 0;" ::: "memory");  // the rows (gather_rows)
  __syncthreads();
  for (int k0 = k_lo; k0 < k_hi; k0 += 16 * (U + 1)) {
#pragma unroll
    for (int u = 0; u <= U; ++u) {  // step k0 + 16 u sits in raw[u]
      const int k = k0 + 16 * u;
      if (k >= k_hi) break;
      const int ahead = k + 16 * U;
      if (ahead < k_hi) load_step<NH>(w, N, col, ahead, raw[(u + U) % (U + 1)]);
      uint32_t a[4];
      ldsm_x4(a_base + (unsigned)k * 2, a);
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16(acc[h][j], a, pair(raw[u][h][0], raw[u][h][1], j),
                   pair(raw[u][h][2], raw[u][h][3], j));
    }
  }
}

// The warps' accumulators to red [kWarps][16][NH * 64] (column 64 h + 8 n + j
// of block h holds mma tile j's column n), then a barrier.
template <int NH>
__device__ __forceinline__ void spill(const float (&acc)[NH][8][4], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int W = NH * kCols;
  float* r = red + (size_t)warp * kRows * W;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = h * kCols + 8 * (2 * t) + j, c1 = c0 + 8;
      r[g * W + c0] = acc[h][j][0];
      r[g * W + c1] = acc[h][j][1];
      r[(g + 8) * W + c0] = acc[h][j][2];
      r[(g + 8) * W + c1] = acc[h][j][3];
    }
  __syncthreads();
}

// Rows j < n of the expert's list, gathered from src ([*, K] row-major,
// idx[j] the j-th row's index, or j) into a_s [16][AS] by cp.async, left in
// flight: warp_product waits for them after issuing its first weight loads.
__device__ __forceinline__ void gather_rows(__nv_bfloat16* a_s, int AS,
                                            const __nv_bfloat16* __restrict__ src, int K,
                                            const int* idx, int n) {
  const int vecs = K / 8;
  for (int i = threadIdx.x; i < n * vecs; i += kThreads) {
    const int j = i / vecs, v = i % vecs;
    const int r = idx ? idx[j] : j;
    cp_async16(a_s + (size_t)j * AS + 8 * v, src + (size_t)r * K + 8 * v);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kRouteThreads, 1)
routed_experts_route_kernel(const __nv_bfloat16* __restrict__ h,       // [B, H]
                            const __nv_bfloat16* __restrict__ router,  // [H, E]
                            const __nv_bfloat16* __restrict__ bias,    // [E] or null
                            int* __restrict__ ws, float* __restrict__ gw,  // [E][16]
                            long long* __restrict__ stats,  // [E + 2] or null
                            int B, int H, int E, int K, int norm, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int AS = H + 8;  // 16 bytes past a row: ldmatrix's 8 rows in 8 bank groups
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);  // [16][AS]
  float* red = reinterpret_cast<float*>(smem + (size_t)kRows * AS * 2);  // [warps][16][32]
  __shared__ float sc[kRows][kMaxE], choice[kRows][kMaxE];
  __shared__ int sel_s[kRows][kMaxK];
  __shared__ float g_s[kRows][kMaxK];
  __shared__ int cnt_s[kMaxE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // h's rows into shared memory, every 16-byte copy in flight at once; rows
  // past B are never stored
  for (int i = tid; i < B * H / 8; i += kRouteThreads) {
    const int r = i / (H / 8), v = i % (H / 8);
    cp_async16(hs + (size_t)r * AS + 8 * v, h + (size_t)r * H + 8 * v);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // the logits on the tensor cores: warp w takes H / kRouteWarps rows of the
  // router [H, E], read into registers (columns past E zero), h the A operand
  float acc[1][8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][j][i] = 0.f;
  const int span = H / kRouteWarps, col[1] = {0};
  warp_product<1, 4>(hs, AS, router, E, col, warp * span, (warp + 1) * span, acc);
  {  // mma tile j's column n is router column 8n + j: E <= 32 keeps t < 2
    const int g = lane / 4, t = lane % 4;
    float* r = red + (size_t)warp * kRows * 32;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (t < 2) {
        const int c0 = 16 * t + j, c1 = c0 + 8;
        r[g * 32 + c0] = acc[0][j][0];
        r[g * 32 + c1] = acc[0][j][1];
        r[(g + 8) * 32 + c0] = acc[0][j][2];
        r[(g + 8) * 32 + c1] = acc[0][j][3];
      }
  }
  __syncthreads();
  {
    const int b = tid / 32, e = tid % 32;  // (row, expert)
    if (b < B && e < E) {
      float logit = 0.f;
      for (int w = 0; w < kRouteWarps; ++w) logit += red[((size_t)w * kRows + b) * 32 + e];
      const float sg = 1.f / (1.f + expf(-logit));
      sc[b][e] = sg;
      choice[b][e] = sg + (bias ? __bfloat162float(bias[e]) : 0.f);
    }
  }
  __syncthreads();
  if (tid < B) {  // the row's top K, then in expert order
    const int b = tid;
    unsigned taken = 0u;
    for (int k = 0; k < K; ++k) {
      int best = -1;
      for (int x = 0; x < E; ++x)
        if (!(taken >> x & 1u) && (best < 0 || choice[b][x] > choice[b][best])) best = x;
      taken |= 1u << best;
    }
    int k = 0;
    float sum = 0.f;
    for (int x = 0; x < E; ++x)
      if (taken >> x & 1u) {
        sel_s[b][k++] = x;
        sum += sc[b][x];
      }
    for (k = 0; k < K; ++k) {
      float gk = sc[b][sel_s[b][k]];
      if (norm) gk = gk / (sum + 1e-6f);
      g_s[b][k] = gk * scale;
    }
  }
  __syncthreads();
  const Lists L = lists(ws, E, K);
  if (tid < E) {  // expert tid's rows, in row order
    int j = 0;
    for (int b = 0; b < B; ++b)
      for (int k = 0; k < K; ++k)
        if (sel_s[b][k] == tid) {
          L.rows[tid * kRows + j] = b;
          gw[tid * kRows + j] = g_s[b][k];
          L.slot[b * K + k] = j;
          ++j;
        }
    L.cnt[tid] = j;
    cnt_s[tid] = j;
    if (stats) stats[tid] += j;
  }
  if (tid < B * K) L.sel[tid] = sel_s[tid / K][tid % K];
  __syncthreads();
  if (tid == 0 && stats) {
    int touched = 0;
    for (int x = 0; x < E; ++x) touched += cnt_s[x] > 0;
    stats[E] += touched;
    stats[E + 1] += 1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
routed_experts_gateup_kernel(const __nv_bfloat16* __restrict__ h,    // [B, H]
                             const __nv_bfloat16* __restrict__ w13,  // [E, H, 2I]
                             const int* __restrict__ ws, const float* __restrict__ gw,
                             __nv_bfloat16* __restrict__ act,        // [E, 16, I]
                             int H, int E, int I, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.y, c0 = blockIdx.x * kCols;
  const Lists L = lists(const_cast<int*>(ws), E, K);
  const int n = L.cnt[e];
  if (n == 0) return;
  const int AS = H + 8;  // 16 bytes past a row: ldmatrix's 8 rows in 8 bank groups
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  gather_rows(a_s, AS, h, H, L.rows + e * kRows, n);
  float acc[2][8][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[x][j][i] = 0.f;
  const int warp = threadIdx.x / 32, span = H / kWarps;
  const int col[2] = {c0, I + c0};
  warp_product<2, 2>(a_s, AS, w13 + (size_t)e * H * 2 * I, 2 * I, col, warp * span,
                     (warp + 1) * span, acc);
  __syncthreads();  // every warp is done with a_s
  float* red = reinterpret_cast<float*>(smem);
  spill<2>(acc, red);
  constexpr int W = 2 * kCols;
  for (int i = threadIdx.x; i < n * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    float gate = 0.f, up = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      gate += red[((size_t)w * kRows + r) * W + c];
      up += red[((size_t)w * kRows + r) * W + kCols + c];
    }
    const float silu = gate / (1.f + expf(-gate));
    act[((size_t)e * kRows + r) * I + c0 + c] = __float2bfloat16(gw[e * kRows + r] * silu * up);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
routed_experts_down_kernel(const __nv_bfloat16* __restrict__ x,     // [B, H]
                           const __nv_bfloat16* __restrict__ act,   // [E, 16, I]
                           const __nv_bfloat16* __restrict__ w2,    // [E, I, H]
                           const int* __restrict__ ws, float* __restrict__ part,  // [E, 16, H]
                           unsigned* __restrict__ ticket,           // [H / 64]
                           __nv_bfloat16* __restrict__ out,         // [B, H]
                           int B, int H, int E, int I, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int e = blockIdx.y, c0 = blockIdx.x * kCols;
  const Lists L = lists(const_cast<int*>(ws), E, K);
  const int n = L.cnt[e];
  if (n > 0) {
    const int AS = I + 8;
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
    gather_rows(a_s, AS, act + (size_t)e * kRows * I, I, nullptr, n);
    float acc[1][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][j][i] = 0.f;
    const int warp = threadIdx.x / 32, span = I / kWarps;
    const int col[1] = {c0};
    warp_product<1, 4>(a_s, AS, w2 + (size_t)e * I * H, H, col, warp * span,
                       (warp + 1) * span, acc);
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    spill<1>(acc, red);
    for (int i = threadIdx.x; i < n * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[((size_t)w * kRows + r) * kCols + c];
      part[((size_t)e * kRows + r) * H + c0 + c] = s;
    }
  }
  // the last CTA of the column block adds x and the rows' partials
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    last = atomicAdd(ticket + blockIdx.x, 1u) == gridDim.y - 1;
    if (last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < B * kCols; i += kThreads) {
    const int b = i / kCols, col = c0 + i % kCols;
    float s = __bfloat162float(x[(size_t)b * H + col]);
    for (int k = 0; k < K; ++k)
      s += __ldcg(part + ((size_t)L.sel[b * K + k] * kRows + L.slot[b * K + k]) * H + col);
    out[(size_t)b * H + col] = __float2bfloat16(s);
  }
  if (threadIdx.x == 0) ticket[blockIdx.x] = 0u;
}

}  // namespace

extern "C" {

// Shared memory the three kernels ask for, in bytes.
int qwen3tts_routed_experts_smem(int H, int I, int which) {
  if (which == 0) return kRows * (H + 8) * 2 + kRouteWarps * kRows * 32 * 4;  // h, red
  const int K = which == 1 ? H : I;
  const int a = kRows * (K + 8) * 2;
  const int r = kWarps * kRows * (which == 1 ? 2 : 1) * kCols * 4;
  return a > r ? a : r;
}

// x, h, out [B, H] bfloat16; router [H, E]; bias [E] or null; w13 [E, H, 2I];
// w2 [E, I, H].  ws int32 [E + 16 E + 32 K]; gw float32 [E, 16]; act bf16
// [E, 16, I]; part float32 [E, 16, H]; ticket uint32 [H / 64] zeros (every
// call leaves them zero); stats int64 [E + 2] or null.  B <= 16, E <= 32
// and E % 8 == 0, K <= 8, H % 256 == 0 and I % 128 == 0.  Returns the first
// launch error.
int qwen3tts_routed_experts(const void* x, const void* h, const void* router, const void* bias,
                            const void* w13, const void* w2, void* out, void* ws, void* gw,
                            void* act, void* part, void* ticket, void* stats, int B, int H,
                            int E, int I, int K, int norm, float scale, void* stream) {
  if (B < 1 || B > kRows || E < 8 || E > kMaxE || E % 8 || K < 1 || K > kMaxK || K > E ||
      H % 256 || I % 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  const int s0 = qwen3tts_routed_experts_smem(H, I, 0);
  const int s1 = qwen3tts_routed_experts_smem(H, I, 1);
  const int s2 = qwen3tts_routed_experts_smem(H, I, 2);
  cudaError_t err;
  // once per shape, on the first (eager) call: not while a graph captures
  static int set_h = 0, set_i = 0;
  if (set_h != H || set_i != I) {
    if ((err = cudaFuncSetAttribute(routed_experts_route_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, s0)) ||
        (err = cudaFuncSetAttribute(routed_experts_gateup_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, s1)) ||
        (err = cudaFuncSetAttribute(routed_experts_down_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, s2)))
      return (int)err;
    set_h = H;
    set_i = I;
  }
  routed_experts_route_kernel<<<1, kRouteThreads, s0, st>>>(
      bf(h), bf(router), bf(bias), static_cast<int*>(ws), static_cast<float*>(gw),
      static_cast<long long*>(stats), B, H, E, K, norm, scale);
  if ((err = cudaGetLastError())) return (int)err;
  routed_experts_gateup_kernel<<<dim3(I / kCols, E), kThreads, s1, st>>>(
      bf(h), bf(w13), static_cast<const int*>(ws), static_cast<const float*>(gw),
      static_cast<__nv_bfloat16*>(act), H, E, I, K);
  if ((err = cudaGetLastError())) return (int)err;
  routed_experts_down_kernel<<<dim3(H / kCols, E), kThreads, s2, st>>>(
      bf(x), bf(act), bf(w2), static_cast<const int*>(ws), static_cast<float*>(part),
      static_cast<unsigned*>(ticket), static_cast<__nv_bfloat16*>(out), B, H, E, I, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
