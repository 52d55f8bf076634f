// A per-CTA weight stream for batch-1 matrix-vector kernels (fused_block.cu:
// fused_norm_matmul, and fused_o_mlp, which walks several dependent phases in
// one launch; predictor_step.cu: fused_micro_step).
//
// Such a kernel is bound by bytes: every call reads each weight once and
// does two operations per element.  What it loses time to is latency: a
// phase can start only after the previous phase's vector has crossed the
// grid (a barrier, a norm), and a weight load issued after that point
// waits out a DRAM round trip while the card's memory system idles.
// Weights do not depend on activations, so here their loads never wait:
//
//   * Which CTA reads which tile of which matrix is known at launch.  A
//     kernel describes its CTA's share as a sequence of jobs (Job: a row
//     range of one or two column ranges of a row-major matrix).
//   * A CTA is kThreads consumer threads and kProducers producer threads.
//     The producers (produce) walk the jobs ahead of the computation: they
//     copy them, cut into stages (kStageBytes unless a kernel picks its
//     own size), into a ring of NS stages in shared memory with cp.async
//     (16 bytes a copy; 8 where a tile's row segment is not a multiple of
//     16 bytes; one bulk copy a row where a row segment is at least 512
//     bytes), and each stage's `full` mbarrier counts the copies in.  They
//     run from kernel entry on and wait only for a stage to be handed back
//     (`empty`) and for the stages before to have landed (kInFlight in
//     flight, or as many as a kernel asks for): never for a grid barrier, a
//     norm or an activation, so the ring is full whenever the consumers get
//     to it.
//     The copies cost the consumers no registers and no instructions, and
//     a memory system that pushes back stalls the producers alone.
//   * stream_job consumes one job: a consumer waits on the stage's `full`
//     mbarrier, multiplies 8-column vectors of its rows out of shared
//     memory into float32 accumulators (products of the activation and the
//     weight as float, fmaf, rows in increasing order), and its warp hands
//     the stage back.  At the job's end the row groups are folded through
//     shared memory in a fixed order: no atomics, the same bits every run.
//   * What one CTA hands to the others (partial sums, an activation) is a
//     float with the tag of the phase that made it, in one 8-byte word in
//     L2 (put_tagged); a reader asks for its words, all loads in flight at
//     once, and takes each when it carries the tag (sum_splits).  No fence,
//     flag or barrier stands between writer and reader: a barrier costs the
//     stores' acknowledgement, an atomic, a poll and then the loads, four
//     round trips through L2 where this is one or two.  A dependent chain
//     of L2 round trips is what a phase can least afford.
//   * grid_barrier, for the shapes that still need one, is one atomic per
//     CTA on a word that resets itself (the CTA 0 adds 2^31 - (G - 1), the
//     others 1: the top bit flips when all have arrived).  The kernels are
//     launched cooperatively, so the grid is co-resident or the launch
//     fails: a CTA that waits for another never waits for one that cannot
//     run.
//
// An int8 weight {q, scale} is dequantized per element as T(f32(q) *
// scale[col]) while it is consumed.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wstream {

// QWEN3TTS_CONSUMERS, QWEN3TTS_STAGE_BYTES and QWEN3TTS_RING_STAGES (a cap)
// are for tools/kernel_probe.py's variants.
#ifndef QWEN3TTS_CONSUMERS
#define QWEN3TTS_CONSUMERS 256
#endif
#ifndef QWEN3TTS_STAGE_BYTES
#define QWEN3TTS_STAGE_BYTES 16384
#endif
#ifndef QWEN3TTS_RING_STAGES
#define QWEN3TTS_RING_STAGES 64
#endif
constexpr int kThreads = QWEN3TTS_CONSUMERS;  // consumer threads: they compute
constexpr int kWarps = kThreads / 32;
#ifndef QWEN3TTS_PRODUCERS
#define QWEN3TTS_PRODUCERS 128
#endif
constexpr int kProducers = QWEN3TTS_PRODUCERS;  // producer threads: they only copy
#ifndef QWEN3TTS_IN_FLIGHT
#define QWEN3TTS_IN_FLIGHT 1
#endif
#ifndef QWEN3TTS_QUIET
#define QWEN3TTS_QUIET 0
#endif
// Stages a CTA's producers have in flight at once.  An SM's requests to the
// memory system are served in order, so whatever a consumer needs next from
// there (the grid barrier's atomic and its polls, the partial sums of the
// phase before) waits behind every copy already issued: a full ring's worth
// in flight costs each such access microseconds.  One stage (16 KB a round
// trip) keeps an SM's share of the card's memory rate busy.  QWEN3TTS_QUIET
// (a variant of tools/kernel_probe.py, slower): while a CTA's consumers are
// between phases its producers issue nothing at all.
constexpr int kInFlight = QWEN3TTS_IN_FLIGHT;
#ifndef QWEN3TTS_BULK_MIN
#define QWEN3TTS_BULK_MIN 512
#endif
constexpr int kBulkMin = QWEN3TTS_BULK_MIN;  // a row range from this size on is one bulk copy
constexpr int kBlock = kThreads + kProducers;
constexpr int kVec = 8;              // columns per thread and row
constexpr int kStageBytes = QWEN3TTS_STAGE_BYTES;  // one ring stage
constexpr int kSmemBudget = 232448 - 2048;         // dynamic shared memory of a CTA

// the stages of `stage_bytes` that fit beside `fixed` bytes of other shared
// memory
constexpr int ring_stages(int fixed, int stage_bytes = kStageBytes) {
  const int fit = (kSmemBudget - fixed) / (stage_bytes + 16);
  return fit < QWEN3TTS_RING_STAGES ? fit : QWEN3TTS_RING_STAGES;
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// --- per-CTA phase stamps, compiled in only for tools/kernel_probe.py -------
#ifdef QWEN3TTS_STAMPS
constexpr int kStampCTAs = 160, kStampPhases = 32, kStampKinds = 3;
__device__ unsigned long long g_stamp[kStampCTAs * kStampPhases * kStampKinds];
__device__ __forceinline__ void stamp(int phase, int kind) {
  if (threadIdx.x == 0 && blockIdx.x < kStampCTAs && phase < kStampPhases) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[(blockIdx.x * kStampPhases + phase) * kStampKinds + kind] = t;
  }
}
#define WSTREAM_STAMP(phase, kind) ::wstream::stamp(phase, kind)
// CTA 0's stages: when stage n had landed for its thread 0, and when that
// thread's warp handed it back
constexpr int kStageStamps = 512;
__device__ unsigned long long g_stage_stamp[kStageStamps * 2];
__device__ __forceinline__ void stage_stamp(int n, int kind) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && n < kStageStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stage_stamp[n * 2 + kind] = t;
  }
}
#define WSTREAM_STAGE_STAMP(n, kind) ::wstream::stage_stamp(n, kind)
#else
#define WSTREAM_STAMP(phase, kind)
#define WSTREAM_STAGE_STAMP(n, kind)
#endif

// --- barriers inside the CTA ------------------------------------------------

// The consumers' barrier: the producers take no part in it.
__device__ __forceinline__ void cta_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// this thread's arrival, made when all its cp.async so far have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}
// until the barrier's phase of the given parity has completed
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

// --- the grid barrier -------------------------------------------------------
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the (co-resident) grid calls it the same number of times.
// *bar may hold any value at launch and is left with its low 31 bits as
// they were: no reset between launches or graph replays.
// QWEN3TTS_BARRIER picks the kind for tools/kernel_probe.py: 0 (shipped)
// atom.release, spin on ld.acquire; 1 cooperative_groups grid sync (for
// kernels whose whole CTA calls it: it is a bar.sync 0); 2 atom.release,
// spin on ld.relaxed, one fence after.
#ifndef QWEN3TTS_BARRIER
#define QWEN3TTS_BARRIER 0
#endif
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
#if QWEN3TTS_BARRIER == 1
  cooperative_groups::this_grid().sync();
#else
  cta_sync();
  if (threadIdx.x == 0) {
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
#if QWEN3TTS_BARRIER == 0
    unsigned old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(inc) : "memory");
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) {
    }
#else
    unsigned old, now;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(inc) : "memory");
    do {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(bar) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
#endif
  }
  cta_sync();
#endif
}

// --- vectors that cross the grid ----------------------------------------------

// A float that one CTA hands to the others travels with the tag of the
// phase that made it, in one 8-byte word: a reader that finds the tag has
// the value, with no fence, flag or barrier between writer and reader, and
// a reader that does not find it yet asks again.  That is one store and one
// load (or a few) through L2 where a grid barrier costs the store's
// acknowledgement, an atomic, a poll and then the load.  Tags are unique
// over launches: launch_tags hands each launch a fresh range.
__device__ __forceinline__ void put_tagged(uint64_t* p, float v, unsigned tag) {
  const uint64_t w = ((uint64_t)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ uint64_t ld_tagged(const uint64_t* p) {
  uint64_t w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// s[i] = sum over the row splits ks < KS, in split order, of the value at
// part[ks * stride + idx[i]] for the i with ok[i] (else 0), each taken once
// it carries `tag`.  A round trip through L2 is ~0.7 us, more while the
// weights stream, so every load of up to U splits is in flight at once.
// Where some were not ready, the thread waits on one of them alone before
// it asks for the rest again: a grid that polls all its words while it
// waits takes L2's bandwidth from the weights.
template <int N, int U = 4>
__device__ __forceinline__ void sum_splits(const uint64_t* part, int KS, size_t stride,
                                           const int (&idx)[N], const bool (&ok)[N],
                                           unsigned tag, float (&s)[N]) {
  static_assert(U * N <= 64, "one pending bit per word");
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 0.f;
  for (int ks0 = 0; ks0 < KS; ks0 += U) {
    uint64_t w[U][N];
    unsigned long long pending = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (ks0 + u < KS && ok[i]) pending |= 1ull << (u * N + i);
    for (bool again = false; pending; again = true) {
      if (again) {
        const uint64_t* one = nullptr;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < N; ++i)
            if (one == nullptr && (pending >> (u * N + i) & 1))
              one = part + (size_t)(ks0 + u) * stride + idx[i];
        while ((unsigned)(ld_tagged(one) >> 32) != tag) {
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (pending >> (u * N + i) & 1)
            w[u][i] = ld_tagged(part + (size_t)(ks0 + u) * stride + idx[i]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i)
          if ((pending >> (u * N + i) & 1) && (unsigned)(w[u][i] >> 32) == tag)
            pending &= ~(1ull << (u * N + i));
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ks0 + u < KS)
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (ok[i]) s[i] += __uint_as_float((unsigned)w[u][i]);
  }
}

// Tags for this launch's phases: tag0 + 1, tag0 + 2, ...  sync[0] is the
// grid barrier's word, sync[1] the next launch's tag0 (1 before the first
// launch, over zeroed workspaces), sync[2] counts the CTAs that are done.
// Every CTA reads tag0 before it hands anything on, and the last one to
// call launch_done moves it past this launch's `phases` tags.
__device__ __forceinline__ unsigned launch_tags(const unsigned* sync) {
  __shared__ unsigned tag0;
  if (threadIdx.x == 0) tag0 = ld_acquire(sync + 1);
  __syncthreads();
  return tag0;
}
__device__ __forceinline__ void launch_done(unsigned* sync, unsigned tag0, unsigned phases) {
  if (threadIdx.x == 0 && atomicAdd(sync + 2, 1u) == gridDim.x - 1) {
    sync[2] = 0;
    sync[1] = tag0 + phases + 1;
  }
}

// --- jobs and the ring ------------------------------------------------------

// Rows [k_lo, k_hi) of nt (1 or 2) column ranges of a row-major matrix, in
// bytes: range t of row k starts at w + k * ld + col[t] and is seg long.
struct Job {
  const char* w;
  size_t ld;
  int col[2];
  int nt;
  int seg;
  int k_lo, k_hi;
  int cb;     // 16: bulk copies; 8 where an offset is not a multiple of 16: cp.async
  int align;  // a stage's rows, where it holds more: a multiple of this
};

template <typename W>
__device__ __forceinline__ Job make_job(const W* w, int ld, int col0, int col1, int nt, int C,
                                        int k_lo, int k_hi) {
  Job j;
  j.w = reinterpret_cast<const char*>(w);
  j.ld = (size_t)ld * sizeof(W);
  j.col[0] = col0 * (int)sizeof(W);
  j.col[1] = col1 * (int)sizeof(W);
  j.nt = nt;
  j.seg = C * (int)sizeof(W);
  j.k_lo = k_lo;
  j.k_hi = k_hi;
  const size_t bits = (size_t)j.w | j.ld | (size_t)j.col[0] | (size_t)(nt == 2 ? j.col[1] : 0) |
                      (size_t)j.seg;
  j.cb = (bits & 15) == 0 ? 16 : 8;
  j.align = 1;
  return j;
}

__device__ __forceinline__ Job empty_job() {
  Job j = {};
  j.nt = 1;
  j.seg = 16;
  j.cb = 16;
  return j;
}

__device__ __forceinline__ int rows_per_stage(const Job& j, int stage_bytes) {
  const int r = stage_bytes / (j.nt * j.seg);
  return j.align > 1 && r > j.align ? r - r % j.align : r;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

// How a producer thread copies its part of a job's stages.  Row r of a
// stage holds the job's nt ranges side by side (nt * seg bytes).
//   kBulk   a range of a row is at least kBulkMin bytes and every offset a
//           multiple of 16: one bulk copy a range (cp.async.bulk: the TMA
//           engine moves it and counts its bytes into the stage's
//           mbarrier).  Narrower ranges are slower that way than cp.async:
//           the engine takes ~12 cycles a copy whatever its size.
//   kCopy   cp.async of cb bytes.  The thread keeps one 16-byte column of
//           the row and walks rows r0, r0 + dr, ...: two adds a copy.
//   kIdle   cp.async, but the copies of a row do not divide the producers
//           and this thread is left over.
//   kWalk   cp.async where a row has more copies than there are producers.
struct Plan {
  enum Mode { kBulk, kCopy, kIdle, kWalk } mode;
  int r0, dr;       // kCopy: first row and row stride of this thread
  int dst;          // kCopy: byte offset of its first copy in a stage
  const char* src;  // kCopy: its first copy's source in the job's first row
};

__device__ __forceinline__ Plan make_plan(const Job& jb) {
  const int lane = threadIdx.x - kThreads;  // among the producers
  Plan p = {};
  const int cps = jb.seg / jb.cb, cpr = cps * jb.nt;  // copies per range, per row
  if (jb.cb == 16 && jb.seg >= kBulkMin) {
    p.mode = Plan::kBulk;
  } else if (cpr > kProducers) {
    p.mode = Plan::kWalk;
  } else if (lane >= kProducers / cpr * cpr) {
    p.mode = Plan::kIdle;
  } else {
    p.mode = Plan::kCopy;
    p.dr = kProducers / cpr;
    p.r0 = lane / cpr;
    const int j = lane % cpr, t = j >= cps ? 1 : 0;
    p.dst = p.r0 * jb.nt * jb.seg + j * jb.cb;
    p.src = jb.w + (size_t)(jb.k_lo + p.r0) * jb.ld + jb.col[t] + (j - t * cps) * jb.cb;
  }
  return p;
}

// Copies rows [row0, row0 + rows) of the job into a stage.  Every producer
// thread arrives once on the stage's `full` mbarrier.
__device__ __forceinline__ void issue_stage(char* slot, uint64_t* full, const Job& jb,
                                            const Plan& p, int row0, int rows) {
  const int lane = threadIdx.x - kThreads;
  const unsigned base = smem_addr(slot), bar = smem_addr(full);
  const int rowbytes = jb.nt * jb.seg;
  if (p.mode == Plan::kBulk) {
    const int total = rows * jb.nt;  // ranges of rows
    const int mine = total > lane ? (total - lane + kProducers - 1) / kProducers : 0;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(mine * jb.seg)
                 : "memory");
    for (int v = lane; v < total; v += kProducers) {
      const int r = jb.nt == 2 ? v >> 1 : v, t = jb.nt == 2 ? v & 1 : 0;
      const char* src = jb.w + (size_t)(row0 + r) * jb.ld + jb.col[t];
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(base + r * rowbytes + t * jb.seg), "l"(src), "r"(jb.seg), "r"(bar)
          : "memory");
    }
    return;
  }
  if (p.mode == Plan::kCopy) {
    const char* src = p.src + (size_t)(row0 - jb.k_lo) * jb.ld;
    unsigned dst = base + p.dst;
    const size_t dsrc = (size_t)p.dr * jb.ld;
    const unsigned ddst = p.dr * rowbytes;
    if (jb.cb == 16) {
      for (int r = p.r0; r < rows; r += p.dr, src += dsrc, dst += ddst) cp_async16(dst, src);
    } else {
      for (int r = p.r0; r < rows; r += p.dr, src += dsrc, dst += ddst) cp_async8(dst, src);
    }
  } else if (p.mode == Plan::kWalk) {
    const int cps = jb.seg / jb.cb, cpr = cps * jb.nt;
    for (int v = lane; v < rows * cpr; v += kProducers) {
      const int r = v / cpr, j = v % cpr, t = j >= cps ? 1 : 0;
      const char* src = jb.w + (size_t)(row0 + r) * jb.ld + jb.col[t] + (j - t * cps) * jb.cb;
      if (jb.cb == 16) {
        cp_async16(base + r * rowbytes + j * jb.cb, src);
      } else {
        cp_async8(base + r * rowbytes + j * jb.cb, src);
      }
    }
  }
  mbar_arrive_on_copies(full);
}

// The ring: NS stages of SB bytes and, per stage, a `full` mbarrier (the
// kProducers producer threads arrive on it when their copies have landed) and an
// `empty` one (the kWarps consumer warps arrive when they have read it).
// Stage n of the CTA's schedule lives in slot n % NS; its use n / NS gives
// the parity to wait for.
template <int NS, int SB = kStageBytes>
struct alignas(128) RingMem {  // what follows it in shared memory stays 128-byte aligned
  char stage[NS][SB];
  uint64_t full[NS], empty[NS];
  int quiet;  // the consumers are between phases: issue nothing
};

// Consumer thread 0, around the stretch between two phases.
template <int NS, int SB>
__device__ __forceinline__ void set_quiet(RingMem<NS, SB>* m, int on) {
#if QWEN3TTS_QUIET
  if (threadIdx.x == 0) *reinterpret_cast<volatile int*>(&m->quiet) = on;
#endif
}

// Every thread of the CTA, before the warps part ways.
template <int NS, int SB>
__device__ __forceinline__ void ring_init(RingMem<NS, SB>* m) {
  if (threadIdx.x == 0) {
    m->quiet = 0;
    for (int i = 0; i < NS; ++i) {
      mbar_init(&m->full[i], kProducers);
      mbar_init(&m->empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer threads (one warp cannot issue 16-byte copies as fast as an
// SM's share of the card's memory rate): they walk the CTA's jobs in the order it consumes them
// (Sched::job(j, out) gives job j, possibly empty with k_lo >= k_hi, or
// returns false past the last) and copy them, cut into stages, as far
// ahead of the consumers as the ring allows.  They wait for nothing else:
// not for a barrier, a norm or an activation.  At most `in_flight` stages
// are in flight at once (kInFlight unless the kernel says otherwise).
template <int NS, int SB, typename Sched>
__device__ void produce(RingMem<NS, SB>* m, const Sched& sched, int in_flight = kInFlight) {
  Job jb;
  int n = 0;
  for (int j = 0; sched.job(j, jb); ++j) {
    if (jb.k_lo >= jb.k_hi) continue;
    const int rps = rows_per_stage(jb, SB);
    const Plan plan = make_plan(jb);
    for (int row0 = jb.k_lo; row0 < jb.k_hi; row0 += rps, ++n) {
      const int slot = n % NS, use = n / NS;
      if (use > 0) mbar_wait(&m->empty[slot], (use - 1) & 1);
#if QWEN3TTS_QUIET
      while (*reinterpret_cast<volatile int*>(&m->quiet)) __nanosleep(32);
#endif
      if (in_flight < NS && n >= in_flight) {  // stage n - in_flight has landed
        const int before = n - in_flight;      // (its slot is not reused before stage n)
        mbar_wait(&m->full[before % NS], (before / NS) & 1);
      }
      issue_stage(m->stage[slot], &m->full[slot], jb, plan, row0, min(rps, jb.k_hi - row0));
    }
  }
}

// A consumer thread's place in the CTA's schedule.
template <int NS, int SB = kStageBytes>
struct Consumer {
  RingMem<NS, SB>* m;
  int n;
  // the next stage, landed
  __device__ __forceinline__ const char* acquire() {
    mbar_wait(&m->full[n % NS], (n / NS) & 1);
    WSTREAM_STAGE_STAMP(n, 0);
    return m->stage[n % NS];
  }
  // this warp has read it
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&m->empty[n % NS]);
    WSTREAM_STAGE_STAMP(n, 1);
    ++n;
  }
};

// --- consuming a stage ------------------------------------------------------

// 8 consecutive weight elements as they lie in shared memory.
template <typename W> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 v; };
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<int8_t> { uint2 v; };

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
// int8 -> float without the conversion unit: byte q + 128 under the
// exponent of 2^23 is the float 2^23 + q + 128, exactly.  The roundings to
// bf16 go two to an instruction (QWEN3TTS_ONE_ROUNDING, one at a time, is a
// variant of tools/kernel_probe.py: the same bits, 2-5 % slower).
template <typename T>
__device__ __forceinline__ void cvt8(const Raw8<int8_t>& r, const float* sc, float* o) {
  const uint32_t lo = r.v.x ^ 0x80808080u, hi = r.v.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + i)) - 8388736.f;
    const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + i)) - 8388736.f;
    o[i] = __fmul_rn(a, sc[i]);
    o[4 + i] = __fmul_rn(b, sc[4 + i]);
  }
  if constexpr (sizeof(T) == 2) {
#ifdef QWEN3TTS_ONE_ROUNDING
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = rnd<T>(o[i]);
#else
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(o[i], o[i + 1]));
      o[i] = f.x;
      o[i + 1] = f.y;
    }
#endif
  }
}

// floats of shared memory that stream_job's fold needs for kBC rows
template <int kBC> constexpr int kRedFloats = kThreads * (kVec * kBC + 4);

// res[bc * O1 + c] = sum over the job's rows k of a_s[bc * a_stride + k] *
// W[k][column c of the job], c < O1 = nt * C, the job's ranges side by side.
// Consumes the job's stages from the ring (every consumer thread calls it,
// for the jobs in the order the producers walk them; a_s must be ready).  sc_s: the job's O1
// per-column scales in shared memory (int8 weights), else unused.  Ends
// with a cta_sync: res is ready, red free.
template <typename T, typename W, int kBC, int NS, int SB>
__device__ void stream_job(Consumer<NS, SB>& ring, const Job& jb, const float* a_s, int a_stride,
                           const float* sc_s, float* red, float* res, int stamp_phase = -1) {
  constexpr int VB = kVec * (int)sizeof(W);  // bytes of a thread's vector
#ifndef QWEN3TTS_ROWS_IN_FLIGHT
#define QWEN3TTS_ROWS_IN_FLIGHT 4
#endif
  constexpr int U = QWEN3TTS_ROWS_IN_FLIGHT;  // rows a thread has in flight from shared memory
  const int rowbytes = jb.nt * jb.seg;
  const int LPR = rowbytes / VB;             // threads per stage row
  const int RG = kThreads / LPR;             // row groups
  const int rg = threadIdx.x / LPR, j = threadIdx.x % LPR;
  const bool active = rg < RG;
  float sc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    if constexpr (sizeof(W) == 1) {
      sc[v] = sc_s[j * kVec + v];
    } else {
      sc[v] = 1.f;
    }
  }
  float acc[kBC][kVec];
#pragma unroll
  for (int bc = 0; bc < kBC; ++bc)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[bc][v] = 0.f;

  const int rps = rows_per_stage(jb, SB);
  for (int row0 = jb.k_lo; row0 < jb.k_hi; row0 += rps) {
    const int rows = min(rps, jb.k_hi - row0);
    const char* slot = ring.acquire();
    if (stamp_phase >= 0 && row0 == jb.k_lo) WSTREAM_STAMP(stamp_phase, 1);
#ifdef QWEN3TTS_NO_COMPUTE  // tools/kernel_probe.py: the stream alone
    const int r_first = rows;
#else
    const int r_first = active ? rg : rows;
#endif
    const char* mine = slot + j * VB;
    for (int r0 = r_first; r0 < rows; r0 += U * RG) {
      Raw8<W> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * RG;
        if (r < rows) raw[u] = *reinterpret_cast<const Raw8<W>*>(mine + r * rowbytes);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * RG;
        if (r < rows) {
          float wv[kVec];
          cvt8<T>(raw[u], sc, wv);
#pragma unroll
          for (int bc = 0; bc < kBC; ++bc) {
            const float a = a_s[bc * a_stride + row0 + r];
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[bc][v] = fmaf(a, wv[v], acc[bc][v]);
          }
        }
      }
    }
    ring.release();
  }

  // fold the row groups: each output by P threads over the groups p, p + P,
  // ... in increasing order, then a butterfly over the P neighbouring lanes
  const int O1 = LPR * kVec, O = kBC * O1;
  const int stride = O + 4;
  if (active) {
#pragma unroll
    for (int bc = 0; bc < kBC; ++bc) {
      float4* dst = reinterpret_cast<float4*>(red + rg * stride + bc * O1 + j * kVec);
      dst[0] = make_float4(acc[bc][0], acc[bc][1], acc[bc][2], acc[bc][3]);
      dst[1] = make_float4(acc[bc][4], acc[bc][5], acc[bc][6], acc[bc][7]);
    }
  }
  cta_sync();
  int P = 1;
  while (P < 32 && 2 * P * O <= kThreads) P *= 2;
  const int p = threadIdx.x % P;
  for (int o0 = 0; o0 < O; o0 += kThreads / P) {
    const int o = o0 + threadIdx.x / P;
    float s = 0.f;
    if (o < O)
      for (int g = p; g < RG; g += P) s += red[g * stride + o];
    for (int off = P >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (o < O && p == 0) res[o] = s;
  }
  cta_sync();
}

// a_s[bc][k] = T((v[bc][k] * rsqrt(mean_k v[bc]^2 + eps)) * w[k]) for the
// kBC float32 rows v of length H (shared memory).  Sums of squares: per
// thread, per warp, warps in order.  red: kBC * kWarps floats.
template <typename T, typename NW, int kBC>
__device__ void rms_norm_rows(float* a_s, const float* v, int H, const NW* __restrict__ w,
                              float eps, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int bc = 0; bc < kBC; ++bc) {
    float ss = 0.f;
    for (int k = tid; k < H; k += kThreads) {
      const float x = v[bc * H + k];
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[bc * kWarps + warp] = ss;
  }
  cta_sync();
#pragma unroll
  for (int bc = 0; bc < kBC; ++bc) {
    float tot = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) tot += red[bc * kWarps + wi];
    const float rstd = rsqrtf(tot / (float)H + eps);
    for (int k = tid; k < H; k += kThreads)
      a_s[bc * H + k] = rnd<T>(__fmul_rn(__fmul_rn(v[bc * H + k], rstd), to_f(w[k])));
  }
  cta_sync();
}

// --- launching --------------------------------------------------------------

// CTAs of the kernel that the card holds at once with `smem` bytes of
// dynamic shared memory each (allowed here, once per kernel), or minus a
// cudaError_t.
template <typename K>
int coresident_grid(K kernel, int smem) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBlock, smem);
  if (err != cudaSuccess) return -(int)err;
  return sms * (occ < 1 ? occ : 1);
}

// A cooperative launch: a grid that cannot be co-resident fails, and stream
// capture accepts it.
template <typename K, typename... A>
cudaError_t launch_cooperative(K kernel, int grid, int smem, cudaStream_t st, A... args) {
  if (grid <= 0) return grid < 0 ? (cudaError_t)(-grid) : cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace wstream
