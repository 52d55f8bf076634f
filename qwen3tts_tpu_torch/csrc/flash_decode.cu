// Single-token GQA decode attention over the layer-stacked static KV cache.
//
// Replaces qwen3tts_tpu/ops/flash_decode.py:_kernel (the Pallas kernel behind
// flash_decode_stacked), for a float cache and for the int8 cache with
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
// Bound: bytes.  At batch 1 each call reads the live K/V prefix of one layer,
// p * KVH * D * 2 tensors * (2 bytes bf16 | 1 byte int8 + 4/D of scale); for
// the 0.6B talker (KVH 8, D 128, 28 layers) that is ~115 KB * p per decode
// step in bf16, half that in int8.  The arithmetic (2 * G FLOPs per cache
// element) is far below the card's ridge point.
//
// Design: one CTA per (kv head, batch row), kWarps warps each walking every
// kWarps-th live slot, a tile of kU slots at a time.  A warp reads one K
// row and one V row per slot (32 lanes x D/32 contiguous elements:
// coalesced; 8 bytes a lane in bf16, 4 in int8), and for an int8 cache the
// slot's two scales (one broadcast load each); it keeps the G query heads of
// its kv head in registers, reduces the G dot products with shuffles, and
// carries its own running (max, sum, acc).  The warps' partial states are
// merged through shared memory at the end.  Only the live prefix is touched,
// so the cost grows with pos, not with the cache length S.  pos and pad are
// read from device memory: a step never waits for the host, and a later
// CUDA-graph capture replays with the current values.  At B = 1 only KVH = 8
// CTAs run; splitting the live range across CTAs (split-K) is the next step
// for speed.
//
// Instantiated for the talker's head layout only (head_dim 128, two query
// heads per kv head: every talker preset): q/out bfloat16 or float32, the
// cache in q's dtype or int8.  Built with nvcc -gencode
// arch=compute_90a,code=sm_90a into a shared library with a plain C interface
// (qwen3tts_tpu_torch/ops/flash_decode.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;    // head_dim
constexpr int kG = 2;      // query heads per kv head
constexpr int kEPT = kD / 32;  // elements of a row per lane
constexpr int kWarps = 16;  // more warps in flight per SM: 8 CTAs at batch 1
constexpr int kU = 8;      // slots per warp tile

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int e = 0; e < kEPT; e += 4) {  // 8-byte loads
    const uint2 raw = *reinterpret_cast<const uint2*>(p + e);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[e] = a.x;
    out[e + 1] = a.y;
    out[e + 2] = b.x;
    out[e + 3] = b.y;
  }
}

__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int e = 0; e < kEPT; ++e) out[e] = p[e];
}

__device__ __forceinline__ void load_row(const int8_t* p, float* out) {
  static_assert(kEPT == 4, "one 4-byte load per lane");
  const char4 raw = *reinterpret_cast<const char4*>(p);
  out[0] = static_cast<float>(raw.x);
  out[1] = static_cast<float>(raw.y);
  out[2] = static_cast<float>(raw.z);
  out[3] = static_cast<float>(raw.w);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// T: q/out dtype.  KV: cache dtype (T, or int8_t with scales).
template <typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q,      // [B, NH, D]
                    const KV* __restrict__ k,     // [L, B, S, KVH, D]
                    const KV* __restrict__ v,     // [L, B, S, KVH, D]
                    const float* __restrict__ ks,  // [L, B, KVH, S] (int8 cache only)
                    const float* __restrict__ vs,  // [L, B, KVH, S]
                    T* __restrict__ out,          // [B, NH, D]
                    const int* __restrict__ pos_p,  // [1]
                    const int* __restrict__ pad_p,  // [B]
                    int layer, int B, int S, int KVH, int window, float scale) {
  constexpr int D = kD, G = kG, EPT = kEPT, U = kU;
  constexpr bool kQuant = sizeof(KV) == 1;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int NH = KVH * G;

  const int pos = *pos_p;
  int lo = pad_p[b];
  if (window > 0 && pos - window + 1 > lo) lo = pos - window + 1;
  if (lo < 0) lo = 0;
  const int hi = pos < S - 1 ? pos : S - 1;  // inclusive

  float qr[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * NH + (size_t)kvh * G + g) * D + lane * EPT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) qr[g][e] = to_float(qp[e]) * scale;
  }

  float m[G], l[G], acc[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
  }

  const size_t slot_stride = (size_t)KVH * D;
  const size_t base = ((size_t)layer * B + b) * (size_t)S * slot_stride
                      + (size_t)kvh * D + (size_t)lane * EPT;
  const KV* kb = k + base;
  const KV* vb = v + base;
  const size_t sbase = (((size_t)layer * B + b) * KVH + kvh) * (size_t)S;

  // Each warp owns the slots lo + warp + kWarps * j and takes them U at a
  // time: it issues the K/V loads of U slots, reduces their U*G dot products
  // (independent shuffle chains, so their latencies overlap), and then folds
  // the whole tile into its running softmax with one rescale.  With only KVH
  // CTAs on the card at batch 1, the work in flight per SM is what sets the
  // speed.
  for (int s0 = lo + warp; s0 <= hi; s0 += kWarps * U) {
    float kk[U][EPT], vv[U][EPT];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * kWarps;
      if (s <= hi) {
        load_row(kb + (size_t)s * slot_stride, kk[u]);
        load_row(vb + (size_t)s * slot_stride, vv[u]);
        if constexpr (kQuant) {
          ksc[u] = ks[sbase + s];
          vsc[u] = vs[sbase + s];
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) kk[u][e] = vv[u][e] = 0.f;
        ksc[u] = vsc[u] = 0.f;
      }
    }
    float d[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) x = fmaf(qr[g][e], kk[u][e], x);
        d[u][g] = x;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) d[u][g] += __shfl_xor_sync(0xffffffffu, d[u][g], off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u * kWarps > hi) {  // past the live range: contributes nothing
#pragma unroll
        for (int g = 0; g < G; ++g) d[u][g] = -INFINITY;
      } else if constexpr (kQuant) {
#pragma unroll
        for (int g = 0; g < G; ++g) d[u][g] *= ksc[u];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, d[u][g]);  // slot s0 is live
      const float corr = expf(m[g] - m_new);  // exp(-inf) = 0 on the first tile
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(d[u][g] - m_new);  // 0 for a dead slot
        l[g] += p;
        const float pv = kQuant ? p * vsc[u] : p;
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[g][e] = fmaf(pv, vv[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) sm_acc[warp][g][lane * EPT + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // no live slot anywhere: the row stays exactly zero
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w][g] - mx);  // a warp with no slot has m = -inf: c = 0
        num += sm_acc[w][g][d] * c;
        den += sm_l[w][g] * c;
      }
    }
    store(out + ((size_t)b * NH + (size_t)kvh * G + g) * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, void* out, const int* pos, const int* pad, int layer,
                   int B, int S, int KVH, int window, float scale, cudaStream_t st) {
  flash_decode_kernel<T, KV><<<dim3(KVH, B), kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<T*>(out),
      pos, pad, layer, B, S, KVH, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (q and out): 0 = bfloat16, 1 = float32.  kv_int8: 0 = the cache is
// in q's dtype (ks/vs unused), 1 = int8 cache with f32 scales ks/vs
// [L, B, KVH, S].  window <= 0 means full attention.  Returns the launch's
// cudaError_t (0 on success).
int qwen3tts_flash_decode(int dtype, int kv_int8, const void* q, const void* k,
                          const void* v, const void* ks, const void* vs, void* out,
                          const void* pos, const void* pad, int layer, int B, int S,
                          int NH, int KVH, int D, int window, float scale, void* stream) {
  if (D != kD || NH != kG * KVH) return (int)cudaErrorInvalidValue;
  if (kv_int8 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos_i = static_cast<const int*>(pos);
  const int* pad_i = static_cast<const int*>(pad);
  if (dtype == 0 && !kv_int8)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, out, pos_i, pad_i,
                                                     layer, B, S, KVH, window, scale, st);
  if (dtype == 1 && !kv_int8)
    return (int)launch<float, float>(q, k, v, ks, vs, out, pos_i, pad_i, layer, B, S, KVH,
                                     window, scale, st);
  if (dtype == 0 && kv_int8)
    return (int)launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, out, pos_i, pad_i, layer,
                                              B, S, KVH, window, scale, st);
  if (dtype == 1 && kv_int8)
    return (int)launch<float, int8_t>(q, k, v, ks, vs, out, pos_i, pad_i, layer, B, S,
                                      KVH, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
