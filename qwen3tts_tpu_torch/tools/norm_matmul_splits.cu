// Row-split variants of fused_norm_matmul, measured and rejected (PERF.md,
// versions table).  Only tools/kernel_probe.py (`norm`) builds this file;
// no wrapper of the package calls it.
//
// The shipped kernel (csrc/fused_block.cu, included below for its ring,
// norm and loads) gives each CTA one column tile over all H rows.  Here
// each tile is also cut into KS row splits of k_chunk rows, one CTA each
// (CTA blockIdx.x takes split blockIdx.x % KS of tile blockIdx.x / KS),
// and the partial sums of a tile are folded in split order:
//
//   fold 0: through tagged 8-byte words in L2 (wstream.cuh put_tagged /
//           sum_splits); the split-0 CTA adds them.  A cooperative launch,
//           so that the split-0 CTA never waits for a CTA not yet resident.
//   fold 1: a tile's splits are one thread block cluster; CTA ks adds its
//           share of the outputs over the splits through distributed shared
//           memory, between two cluster barriers (the producers have exited
//           by then, and a cluster barrier waits for non-exited threads).
//
// One row of x (B = 1), bf16 activations, bf16 or int8 weights.

#include "fused_block.cu"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSplits = 4;

template <typename W>
struct SArgs {
  const __nv_bfloat16* x;   // [1, H]
  const __nv_bfloat16* nw;  // [H]
  const W* w;               // [H, N]
  const float* scale;       // [N] per-column scales of an int8 W
  __nv_bfloat16* out;       // [1, N]
  uint64_t* part;           // [KS, 1, N] tagged partial sums (fold 0)
  unsigned* sync;           // wstream.cuh launch_tags (fold 0)
  int H, N, C, KS, k_chunk;
  float eps;
};

template <typename W, int kFold>
__global__ void __launch_bounds__(wstream::kBlock, QWEN3TTS_NM_CTAS)
    norm_matmul_split_kernel(const __grid_constant__ SArgs<W> a) {
  using T = __nv_bfloat16;
  constexpr int NS = kNmStages<W, 1>;
  extern __shared__ __align__(128) char smem[];
  auto* ring_mem = reinterpret_cast<NmRing<W, 1>*>(smem);
  float* a_s = reinterpret_cast<float*>(smem + sizeof(NmRing<W, 1>));
  float* red = a_s + kMaxK;
  float* res = red + wstream::kRedFloats<1>;
  float* sc_s = res + kNmMaxCols;
  float* nred = sc_s + kNmMaxCols;

  const int tid = threadIdx.x, H = a.H, N = a.N, KS = a.KS;
  const int ks = blockIdx.x % KS, n0 = blockIdx.x / KS * a.C;
  const int C = min(a.C, N - n0);
  const int k_lo = ks * a.k_chunk, k_hi = min(H, k_lo + a.k_chunk);
  const NSched sched = {wstream::make_job(a.w, N, n0, 0, 1, C, k_lo, k_hi), 1};

  float xr[1][kPer], wr[kPer], sc = 0.f;
  if (tid < wstream::kThreads) {
    load_rows<T, 1>(a.x, a.nw, 1, 0, H, xr, wr);
    if (sizeof(W) == 1 && tid < C) sc = a.scale[n0 + tid];
  }
  wstream::ring_init(ring_mem);
  const unsigned tag0 = kFold == 0 ? wstream::launch_tags(a.sync) : 0u;
  if (tid >= wstream::kThreads) {
    wstream::produce(ring_mem, sched, QWEN3TTS_NM_IN_FLIGHT);
    return;
  }
  wstream::Consumer<NS, kNmStageBytes<W>> ring = {ring_mem, 0};
  if (tid < C) sc_s[tid] = sc;
  norm_rows<T, 1>(xr, wr, H, a.eps, a_s, nred);
  wstream::stream_job<T, W, 1>(ring, sched.jb, a_s, H, sc_s, red, res);

  if constexpr (kFold == 0) {
    for (int c = tid; c < C; c += wstream::kThreads)
      wstream::put_tagged(a.part + (size_t)ks * N + n0 + c, res[c], tag0 + 1);
    if (ks == 0) {
      for (int base = tid; base < C; base += 4 * wstream::kThreads) {
        int idx[4];
        bool ok[4];
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = base + u * wstream::kThreads;
          ok[u] = c < C;
          idx[u] = ok[u] ? n0 + c : 0;
        }
        wstream::sum_splits<4>(a.part, KS, (size_t)N, idx, ok, tag0 + 1, s);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (ok[u]) put(a.out + idx[u], s[u]);
      }
    }
    wstream::launch_done(a.sync, tag0, 1);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int per = (C + KS - 1) / KS;
    for (int o = ks * per + tid; o < min(C, (ks + 1) * per); o += wstream::kThreads) {
      float v[kMaxSplits];
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) v[j] = j < KS ? cluster.map_shared_rank(res, j)[o] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)
        if (j < KS) s += v[j];
      put(a.out + n0 + o, s);
    }
    cluster.sync();
  }
}

template <typename W, int kFold>
int split_run(const SArgs<W>& a, cudaStream_t st) {
  auto* kernel = norm_matmul_split_kernel<W, kFold>;
  constexpr int smem = kNmSmem<W, 1>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = (a.N + a.C - 1) / a.C * a.KS;
  if constexpr (kFold == 0) {
    return (int)wstream::launch_cooperative(kernel, grid, smem, st, a);
  } else {
    // the producers must never wait for a stage to be handed back
    if ((size_t)a.k_chunk * a.C * sizeof(W) > (size_t)kNmStages<W, 1> * kNmStageBytes<W>)
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(wstream::kBlock);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cl[1];
    cl[0].id = cudaLaunchAttributeClusterDimension;
    cl[0].val.clusterDim.x = a.KS;
    cl[0].val.clusterDim.y = 1;
    cl[0].val.clusterDim.z = 1;
    cfg.attrs = cl;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, kernel, a);
  }
}

template <typename W>
int split_args(int fold, const void* x, const void* nw, const void* w, const float* scale,
               void* out, void* part, void* sync, int H, int N, int C, int KS, int k_chunk,
               float eps, cudaStream_t st) {
  const SArgs<W> a = {static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(nw),
                      static_cast<const W*>(w), scale, static_cast<__nv_bfloat16*>(out),
                      static_cast<uint64_t*>(part), static_cast<unsigned*>(sync),
                      H, N, C, KS, k_chunk, eps};
  return fold == 0 ? split_run<W, 0>(a, st) : split_run<W, 1>(a, st);
}

}  // namespace

extern "C" {

// fold: 0 tagged words (part [KS, 1, N] int64 zeroed once, sync uint32 [3]
// {0, 1, 0} once), 1 a cluster of the KS splits (part and sync unused).
// ceil(N / C) column tiles x KS row splits of k_chunk rows; x bf16 [1, H].
int qwen3tts_norm_matmul_split(int fold, int w_int8, const void* x, const void* norm_w,
                               const void* w, const float* w_scale, void* out, void* part,
                               void* sync, int H, int N, int C, int KS, int k_chunk, float eps,
                               void* stream) {
  if (!shape_ok(1, H, N) || C < kVec || C % kVec != 0 || C > kNmMaxCols || KS < 2 ||
      KS > kMaxSplits || k_chunk < 1 || (long long)KS * k_chunk < H ||
      (long long)(KS - 1) * k_chunk >= H || (w_int8 && w_scale == nullptr) ||
      (fold == 0 && (part == nullptr || sync == nullptr)) || (fold != 0 && fold != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_int8 ? split_args<int8_t>(fold, x, norm_w, w, w_scale, out, part, sync, H, N, C, KS,
                                     k_chunk, eps, st)
                : split_args<__nv_bfloat16>(fold, x, norm_w, w, w_scale, out, part, sync, H, N,
                                            C, KS, k_chunk, eps, st);
}

}  // extern "C"
