"""Measure the design choices behind the port's CUDA kernels on the card.

    python -m qwen3tts_tpu_torch.tools.kernel_probe [stream|flash|norm|intmm|w8a8|rows|routed]

``routed`` (csrc/routed_experts.cu) times ``routed_experts`` at 16 rows and
LFM2-8B-A1B's widths (H 2048, 32 experts of 1792, top 4), 22 layers of
experts (15.5 GB, so that no layer's weights sit in L2), one call a layer
in a CUDA graph, with every row routed to 4 experts and with the rows
spread over 28: the time per call beside the least time to read the
touched experts' weights once (untouched experts should cost nothing).

``stream`` (fused_o_mlp and fused_micro_step, csrc/wstream.cuh) builds the
two sources once more per variant with a ``-DQWEN3TTS_...`` flag and, at the
0.6B talker's and predictor's shapes in bf16, prints:

* the time of each variant beside the shipped kernel (CUDA graphs of one
  call per layer, and of a frame's 14 micro-steps): a grid barrier after
  every phase instead of the tags alone, with a relaxed poll, with the
  producers pausing between phases, with the attention behind a barrier of
  its own; a ring of 2 stages; 2 stages and the whole ring in flight; 512
  consumer threads; every row range a bulk copy, and none; 32 KB stages;
  the stream alone, without the products;
* an empty cooperative launch and 21 grid barriers alone, for the shipped
  barrier, cooperative_groups' grid sync and the relaxed poll;
* from the stamped variant (%globaltimer), per phase over the CTAs of one
  call: when a CTA started the phase, when its first weight stage had
  landed, when it ended (median and slowest CTA); and for CTA 0 how long
  its thread 0 waited for each ring stage and how long it held it.

``norm`` (fused_norm_matmul, csrc/fused_block.cu) builds the source once more
per variant with a ``-DQWEN3TTS_...`` flag and, at the 0.6B talker's (N
4096) and predictor's (N 2048) qkv shapes, H 1024, bf16 activations, int8
and bf16 weights, prints:

* nvcc's register, spill and shared-memory report of each instance;
* the time of the shipped kernel (column tiles only), as chip_smoke.py
  times it (a CUDA graph of one call per layer, each layer its own
  weights), beside each variant (the launch and the ring's set-up alone;
  int8 rounded to bf16 one at a time; stages of 4096 and 16384 weights
  (shipped: 8192); one stage in flight; 8 rows a thread in flight; 512
  consumers; 2 CTAs an SM), beside the row-split designs, built from
  ``tools/norm_matmul_splits.cu`` ((b) 32-column tiles x row splits folded
  through tagged words in L2 or through a cluster; clusters of up to 4 and
  of up to 2 splits with row segments of up to 128 bytes, also at 2 CTAs
  an SM) and the plain version;
* the stream alone (no products) for column tiles of 8 to 128 columns;
* from the stamped variant, per CTA of one call: entry, first stage landed
  (its consumers wait for it there), norm done, last stage consumed and
  folded, stored; and CTA 0's stages.

``flash`` (csrc/flash_decode.cu, csrc/matvec.cu) builds the shipped
flash-decode source and three copies of it, each changed
in one place by text substitution: a base-2 softmax (q * log2 e,
ex2.approx), a programmatic dependent launch, and %globaltimer stamps at
each phase of a CTA.  Then, at the 0.6B talker's shapes (L 28, KVH 8, D
128, S 2048, B 1, bf16 and an int8 cache), prints:

* the time of an empty kernel as a graph node (the launch floor);
* per-call times in CUDA graphs of the shipped kernel, the base-2 and the
  dependent-launch copies and SDPA, at pos 300 over two cache stacks (cold
  L2) and at pos 2000; the dependent-launch copy also in a chain where a
  PyTorch kernel precedes each call, as in a decode step;
* the stamped copy's phases (launch to pos read, slot walk, warp merge,
  partial store, ticket, final merge), over the CTAs of one call;
* how many 8- and 16-CTA clusters of the kernel's CTAs the card holds at
  once (cudaOccupancyMaxActiveClusters);
* the int8 KV cache entries that differ between the card and the CPU after
  16 float32 decode steps of chip_smoke.py's small int8 parity model, for
  the shipped and the base-2 kernel;
* matvec at K 1024 x N 65536 beside torch.matmul and a plain read of the
  same 134 MB, 16 bytes a lane (the card's streaming rate).

``intmm`` (the w8a8 route above 16 rows, ops/w8a8.py) prints which K
torch._int_mm refuses on a row-major int8 weight [K, N] (the port's layout:
cuBLASLt's NN) and on a column-major one, at N 64 to 2048 and 17 to 115
rows, each result checked against a float64 product; then, at the 0.6B
talker's four product shapes and 17 to 460 rows, its time with either
layout beside the w8a8 GEMV kernel in 16-row blocks (CUDA graphs of one
call per layer, 28 layers of their own weights).

``w8a8`` (csrc/w8a8.cu's fused GEMV, ops/w8a8.py) builds the first w8a8
design, ``tools/w8a8_unfused.cu`` (quantize_act's kernel, then a GEMV with
byte-wise multiply-adds), and at chip_smoke.py's seven product shapes
(W8A8_SHAPES: CUDA graphs of one call per layer, each layer its own
weights), 1, 2, 4, 8 and 16 rows of bf16 activations, prints in turns
(unfused, fused, bf16 torch.matmul, torch._int_mm at 17 rows, fused,
unfused) the time of each, both checked bit-equal to the plain version
first; beside them the fused kernel with the other dot instruction
(__dp4a or mma.sync) and, where K is split, the other way to the rows'
|max| (each CTA over all of K, or over its slice and an exchange over the
cluster) at every row count and, at 1 and 16 rows, with stages (TMA
boxes) of 64 and 128 rows (shipped: up to 256), a ring of one stage
(refilled as it drains; shipped: the whole share in flight where it
fits) and twice the CTAs (more K splits);
the kernel alone at K 64 x N 128 (one CTA) and K 1024 x N 128 (a 16-CTA
cluster), its floor: launch, barriers, one round trip; and, at 1 and 16
rows, from a copy built with QWEN3TTS_STAMPS (%globaltimer at each phase
of a CTA), when the CTAs reached each phase of one call (median and last
CTA, us from the first CTA's entry).

``rows`` (fused_micro_step at R rows, csrc/predictor_step.cu) prints nvcc's
register, spill and shared-memory report of the predictor step's instances,
then at the 0.6B predictor's shapes in bf16 (proj input 1024, and 2048 as in
the 1.7B), for R 1, 2, 4, 8 and 16 rows: the time a micro-step in a CUDA graph
of a frame's 14 (each checked against the plain version and run twice for
the same bits first), beside R one-row launches a step (R caches), the
plain version on the card, and the bound (the weights' bytes over 3.35
TB/s).
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops import flash_decode as fd
from ..ops import matvec as mv

SRC = (cuda_build.CSRC / "flash_decode.cu").read_text()
# the package's sources, and the row-split variants of fused_norm_matmul,
# which only this probe builds
PROBE_SOURCES = {**cuda_build.SOURCES,
                 "norm_matmul_splits": Path(__file__).with_name("norm_matmul_splits.cu"),
                 "w8a8_unfused": Path(__file__).with_name("w8a8_unfused.cu")}
STAMPS = r'''
__device__ unsigned long long g_stamp[1024 * 8];
__device__ __forceinline__ void stamp(int i, int dep) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "r"(dep));
    g_stamp[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 8 + i] = t;
  }
}
'''
EXTRA = r'''
extern "C" int probe_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));
}
extern "C" int probe_clusters(int size) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8, 1, size);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = size;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto* kernel = flash_decode_kernel<__nv_bfloat16, __nv_bfloat16>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
extern "C" int probe_empty(int grid, void* st) {
  probe_empty_kernel<<<grid, kThreads, 0, (cudaStream_t)st>>>();
  return (int)cudaGetLastError();
}
'''
STREAM = r'''
#include <cuda_runtime.h>
// A plain read of n16 16-byte words, 8 in flight per thread, grid-stride.
__global__ void __launch_bounds__(256) stream_kernel(const uint4* __restrict__ p, long n16,
                                                     float* out) {
  float acc = 0.f;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n16; i += stride * 8) {
    uint4 r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) r[u] = i + u * stride < n16 ? __ldg(p + i + u * stride) : uint4{};
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += __int_as_float(r[u].x ^ r[u].y ^ r[u].z ^ r[u].w);
  }
  if (acc == 1.2345f) *out = acc;  // keeps the loads
}
extern "C" int probe_stream(const void* p, long n16, void* out, int grid, void* st) {
  stream_kernel<<<grid, 256, 0, (cudaStream_t)st>>>((const uint4*)p, n16, (float*)out);
  return (int)cudaGetLastError();
}
'''
PHASES = ["pos read", "slot walk", "warp merge", "partial store", "ticket", "final merge"]


def _sub(src: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` replaced: the variants change the
    head_dim 128 kernel, which comes before the head_dim 64 one."""
    if old not in src:
        raise RuntimeError(f"kernel_probe: the source changed; cannot find {old!r}")
    return src.replace(old, new, 1)


def _variants():
    base2 = _sub(SRC, "qr[g][i] = to_float(qp[i]) * scale;",
                 "qr[g][i] = to_float(qp[i]) * (scale * 1.4426950408889634f);")
    base2 = base2.replace("expf(", "ex2(")
    base2 = _sub(base2, "__device__ __forceinline__ float to_float(__nv_bfloat16 x)",
                 "__device__ __forceinline__ float ex2(float x) {\n  float y;\n"
                 "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n  return y;\n}\n"
                 "__device__ __forceinline__ float to_float(__nv_bfloat16 x)")
    pdl = _sub(SRC, "  const int NH = KVH * G;\n", "  const int NH = KVH * G;\n"
               "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n")
    pdl = _sub(pdl, "  if (!sm_last) return;\n",
               "  asm volatile(\"griddepcontrol.launch_dependents;\");\n  if (!sm_last) return;\n")
    a = pdl.index("  flash_decode_kernel<T, KV><<<")
    b = pdl.index("  return cudaGetLastError();", a)
    pdl = pdl[:a] + (
        "  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(KVH, B, splits);\n"
        "  cfg.blockDim = dim3(kThreads);\n  cfg.stream = st;\n  cudaLaunchAttribute attr[1];\n"
        "  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
        "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n  cfg.attrs = attr;\n"
        "  cfg.numAttrs = 1;\n  return cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, KV>,\n"
        "      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),\n"
        "      static_cast<const float*>(ks), static_cast<const float*>(vs),\n"
        "      static_cast<T*>(out),\n"
        "      pos, pad, ws_acc, ws_ml, ticket, layer, B, S, KVH, window, scale);\n"
        ) + pdl[b + len("  return cudaGetLastError();"):]
    st = _sub(SRC, "namespace {\n", "namespace {\n" + STAMPS +
              "__global__ void probe_empty_kernel() {}\n")
    marker = "  split_bounds(*pos_p, pad_p[b], window, S, split, splits, a, e);\n"
    st = _sub(st, marker, marker + "  stamp(1, a + e);\n")
    st = _sub(st, "  const int NH = KVH * G;\n", "  const int NH = KVH * G;\n  stamp(0, 0);\n")
    for i, marker in ((2, "  // The warp's two half-warp states merged"),
                      (3, "  // The CTA's state, its warps merged in warp order"),
                      (4, "  if (splits == 1) return;\n\n  // The last CTA"),
                      (5, "  merge_splits(ws_acc,"),
                      (6, "  if (threadIdx.x == 0) ticket[row] = 0u;")):
        st = _sub(st, marker, f"  stamp({i}, 0);\n" + marker)
    return {"base2": base2, "pdl": pdl, "stamped": st + EXTRA, "stream": STREAM}


def _build(sources):
    """Compile each source (one nvcc each, all at once) into _build/probe/."""
    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(cuda_build.nvcc_command(cuda_build.nvcc(), so, cu),
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _flash_fn(lib):
    fn = lib.qwen3tts_flash_decode
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def graph_us(fn, calls: int, replays: int = 20) -> float:
    """Device microseconds per call of ``fn(i)``, ``calls`` calls captured in
    one CUDA graph, timed with CUDA events over ``replays`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(calls):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * calls)


def _int8_flips(variant_fn):
    """int8 KV cache entries that differ, card vs CPU, after chip_smoke.py's
    small int8 parity model's prefill and 16 decode steps (float32)."""
    from ..core.loader import init_random
    from ..core.presets import get_preset
    from ..models import talker as talker_lib
    from ..ops.quant import quantize_bundle

    base = get_preset("tiny")
    cfg = dataclasses.replace(base, talker=dataclasses.replace(
        base.talker, head_dim=128, mrope_section=(24, 20, 20)))
    params = quantize_bundle(init_random(cfg, seed=4, dtype=torch.float32, device="cpu"), "int8")
    rng = np.random.default_rng(1)
    H = cfg.talker.hidden_size
    embeds = rng.standard_normal((1, 12, H)).astype(np.float32) * 0.1
    xs = rng.standard_normal((16, 1, 1, H)).astype(np.float32) * 0.1
    caches = {}
    saved = fd._kernel_fn
    if variant_fn is not None:
        fd._kernel_fn = lambda: variant_fn
    try:
        for device in ("cuda", "cpu"):
            dev = torch.device(device)
            p = _move(params["talker"], dev)
            kv = talker_lib.new_kv_cache(cfg.talker, 1, 64, torch.float32, dev, kv_quant=True)
            pad = torch.zeros((1,), dtype=torch.int32, device=dev)
            _, _, kv = talker_lib.prefill(p, cfg.talker, torch.from_numpy(embeds).to(dev), pad, kv)
            for i, x in enumerate(xs):
                pos = torch.full((1,), 12 + i, dtype=torch.int32, device=dev)
                _, kv = talker_lib.decode_step(p, cfg.talker, torch.from_numpy(x).to(dev), pos,
                                               pad, kv, use_flash=True, fused=True)
            caches[device] = {k: t.cpu() for k, t in kv.items() if t.dtype == torch.int8}
    finally:
        fd._kernel_fn = saved
    return sum(int(caches["cuda"][k].ne(caches["cpu"][k]).sum()) for k in caches["cpu"])


def _move(t, dev):
    if isinstance(t, dict):
        return {k: _move(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_move(v, dev) for v in t]
    return t.to(dev)


# ---------------------------------------------------------------------------
# fused_o_mlp and fused_micro_step: the weight stream of csrc/wstream.cuh

# variants of csrc/fused_block.cu and csrc/predictor_step.cu, by -D flags
STREAM_VARIANTS = {
    "stamped": ("QWEN3TTS_STAMPS",),
    "cg barrier": ("QWEN3TTS_BARRIER=1",),
    "barriers with a relaxed poll": ("QWEN3TTS_BARRIER=2", "QWEN3TTS_FORCE_BARRIERS"),
    "ring of 2 stages": ("QWEN3TTS_RING_STAGES=2",),
    "producers pause between phases": ("QWEN3TTS_QUIET=1", "QWEN3TTS_FORCE_BARRIERS"),
    "2 stages in flight": ("QWEN3TTS_IN_FLIGHT=2",),
    "the whole ring in flight": ("QWEN3TTS_IN_FLIGHT=64",),
    "512 consumers": ("QWEN3TTS_CONSUMERS=512", "QWEN3TTS_STAGE_BYTES=16384"),
    "every row range a bulk copy": ("QWEN3TTS_BULK_MIN=16",),
    "no bulk copies": ("QWEN3TTS_BULK_MIN=1000000",),
    "32 KB stages": ("QWEN3TTS_STAGE_BYTES=32768",),
    "stream alone (no products)": ("QWEN3TTS_NO_COMPUTE",),
    "a grid barrier after every phase": ("QWEN3TTS_FORCE_BARRIERS",),
    "barriers, and attention behind its own": ("QWEN3TTS_ATTENTION_BARRIER",),
}
STAMP_SHAPE = (160, 32, 3)  # CTA, phase, (start, first stage landed, end)
O_MLP_PHASES = ["o-projection", "norm + gate|up", "down", "final sum"]


def _build_variants(*groups):
    """Each variant of each source of every (variants, sources) group, one
    nvcc each, all at once: {(variant, source): library}.  fused_block.cu
    takes no barrier or attention flag."""
    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variants, sources in groups:
        for vname, defines in variants.items():
            for src in sources:
                if src == "fused_block" and any("BARRIERS" in d or "ATTENTION" in d
                                                for d in defines):
                    continue
                so = out_dir / f"lib{src}_{'_'.join(defines).replace('=', '_') or 'copy'}.so"
                cmd = cuda_build.nvcc_command(cuda_build.nvcc(), so, PROBE_SOURCES[src],
                                              defines)
                procs[(vname, src)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                            stderr=subprocess.PIPE, text=True))
    libs, logs = {}, {}
    for key, (so, proc) in procs.items():
        _, logs[key] = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{logs[key]}")
        libs[key] = ctypes.CDLL(str(so))
    return libs, logs


def _read_stamps(lib, grid: int):
    """us since the first CTA's entry, [CTA, phase, kind]; NaN where a CTA
    had no such phase in the last launch."""
    fn = lib.qwen3tts_stamps
    fn.argtypes = [ctypes.c_void_p]
    buf = np.zeros(STAMP_SHAPE, dtype=np.uint64)
    torch.cuda.synchronize()
    if fn(buf.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    st = buf[:grid].astype(np.int64)
    rel = (st - st[:, 0, 0].min()).astype(np.float64) / 1e3  # the difference, then float
    rel[(rel < 0) | (rel > 1e4)] = np.nan  # stamps of an earlier launch
    return rel


def _stage_line(lib, stages: int) -> str:
    """CTA 0's stages of the last launch: us its thread 0 waited for each
    stage to land (since it handed the one before back) / us it then held
    it."""
    fn = lib.qwen3tts_stage_stamps
    fn.argtypes = [ctypes.c_void_p]
    buf = np.zeros((512, 2), dtype=np.uint64)
    torch.cuda.synchronize()
    if fn(buf.ctypes.data):
        raise RuntimeError("reading the stage stamps failed")
    st = (buf[:stages].astype(np.int64) - np.int64(buf[0, 0])).astype(np.float64) / 1e3
    parts = []
    for n in range(stages):
        wait = st[n, 0] - (st[n - 1, 1] if n else st[0, 0])
        parts.append(f"{wait:.2f}/{st[n, 1] - st[n, 0]:.2f}")
    return " ".join(parts)


def _phase_lines(rel, names):
    lines = []
    for p, name in enumerate(names):
        col = rel[:, p]
        if np.isnan(col).all():
            continue
        parts = []
        for k, kind in enumerate(("starts", "first stage landed", "ends")):
            v = col[:, k][~np.isnan(col[:, k])]
            if v.size:
                parts.append(f"{kind} {np.median(v):.2f} (slowest {v.max():.2f})")
        lines.append(f"    {name}: " + "; ".join(parts))
    return lines


def _with_lib(module, lib):
    """The wrapper module's kernel functions bound to a variant library."""
    module._kernel_fns = lambda: module.bind(lib)


def stream_probe():
    from ..core.presets import get_preset
    from ..models import predictor as predictor_lib
    from ..ops import fused_block as fb
    from ..ops import predictor_step as ps
    from ..ops import wstream
    from ..ops.quant import quantize_tensor

    dev = torch.device("cuda")
    libs, _ = _build_variants((STREAM_VARIANTS, ("fused_block", "predictor_step")))
    shipped = {"fused_block": cuda_build.library("fused_block"),
               "predictor_step": cuda_build.library("predictor_step")}
    g = torch.Generator(device=dev).manual_seed(2)

    # fused_o_mlp at the 0.6B talker's shapes, one call per layer
    H, Dq, I, L = 1024, 2048, 3072, 28
    x = torch.randn((1, H), generator=g, device=dev).bfloat16()
    attn = torch.randn((1, Dq), generator=g, device=dev).bfloat16()
    nw = torch.ones((H,), device=dev).bfloat16()
    grid = fb.kernel_grid(torch.bfloat16, False, 1)
    print(f"fused_o_mlp: grid {grid} CTAs, geometry {fb.o_mlp_geometry(H, Dq, I, grid)}")
    for wname, quant in (("bf16", False), ("int8", True)):
        def w(rows, cols):
            t = torch.randn((rows, cols), generator=g, device=dev) * rows ** -0.5
            return quantize_tensor(t) if quant else t.bfloat16()
        ws = [(w(Dq, H), w(H, 2 * I), w(I, H)) for _ in range(L)]

        def call(i):
            return fb.fused_o_mlp(x, attn, ws[i % L][0], nw, ws[i % L][1], ws[i % L][2])

        names = ["shipped"] + [v for v in STREAM_VARIANTS
                               if (v, "fused_block") in libs and "barrier" not in v] + ["shipped"]
        line = []
        for name in names:
            _with_lib(fb, shipped["fused_block"] if name == "shipped"
                      else libs[(name, "fused_block")])
            line.append(f"{name} {graph_us(call, L):.2f}")
        print(f"fused_o_mlp talker x=bf16 w={wname}, us/call: " + "; ".join(line))
        _with_lib(fb, libs[("stamped", "fused_block")])
        for i in range(L + 1):
            call(i)
        rel = _read_stamps(libs[("stamped", "fused_block")], grid)
        print(f"  phases (w={wname}), us from the first CTA's entry, median over CTAs:")
        print("\n".join(_phase_lines(rel, O_MLP_PHASES)))
        elt = 1 if quant else 2
        geo_o, geo_mlp = fb.o_mlp_geometry(H, Dq, I, grid)
        n_stages = len(wstream.stage_schedule(
            [(geo_o.chunk, geo_o.cols * elt), (H, 2 * geo_mlp.cols * elt),
             (geo_mlp.cols, H * elt)], 99, fb.STAGE_BYTES))
        print(f"    CTA 0's {n_stages} stages (o-projection, gate|up, down), us waited / us held: "
              + _stage_line(libs[("stamped", "fused_block")], n_stages))
        _with_lib(fb, shipped["fused_block"])
        del ws

    # fused_micro_step at the 0.6B predictor's shapes, a frame's 14 steps
    cfg = get_preset("qwen3-tts-0.6b")
    pcfg, Ht = cfg.predictor, cfg.talker.hidden_size
    params = predictor_lib.init_params(g, pcfg, Ht, torch.bfloat16, dev)
    wts = ps.micro_step_weights(params)
    Lp, S, KVH, D = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads,
                     pcfg.head_dim)
    kk, vv = (torch.randn((Lp, S, KVH, D), generator=g, device=dev).bfloat16()
              for _ in range(2))
    steps = pcfg.num_codebooks - 1
    xs = [(0.5 * torch.randn((1, Ht), generator=g, device=dev)).bfloat16()
          for _ in range(steps)]
    poss = [torch.full((1,), 2 + i, dtype=torch.int32, device=dev) for i in range(steps)]
    ropes = [tuple(t[0, 0] for t in predictor_lib._rope(pcfg, p.reshape(1, 1))) for p in poss]

    def step(i):
        return ps.fused_micro_step(wts, xs[i], *ropes[i], kk, vv, poss[i], pcfg.rms_norm_eps)

    mgrid = ps.kernel_grid(torch.bfloat16, D)
    dims = ps._geometry(wts, kk)
    print(f"fused_micro_step: grid {mgrid} CTAs, geometry {ps.phase_geometry(dims, mgrid)}")
    names = ["shipped"] + list(STREAM_VARIANTS) + ["shipped"]
    line, bars = [], []
    n_sync = 1 + 4 * Lp
    for name in names:
        lib = shipped["predictor_step"] if name == "shipped" else libs[(name, "predictor_step")]
        _with_lib(ps, lib)
        if "cg" not in name:  # a grid sync of the whole CTA would wait for the producers
            line.append(f"{name} {graph_us(step, steps):.2f}")
        if name in ("shipped", "cg barrier", "barriers with a relaxed poll"):
            t0, tn = (graph_us(lambda i: ps.grid_barriers(mgrid, n, torch.cuda.current_stream()),
                               steps) for n in (0, n_sync))
            bars.append(f"{name}: launch {t0:.2f}, {n_sync} barriers {tn - t0:.2f} "
                        f"({(tn - t0) / n_sync:.2f} each)")
    print("fused_micro_step bf16, us a micro-step: " + "; ".join(line))
    print("  an empty cooperative launch and the barriers alone, us: " + "; ".join(bars))
    _with_lib(ps, libs[("stamped", "predictor_step")])
    for i in range(steps):
        step(i)
    rel = _read_stamps(libs[("stamped", "predictor_step")], mgrid)
    kinds = ["proj"] + ["qkv", "o + attention", "gate|up", "down"] * Lp
    print("  phases of the last step, us from the first CTA's entry, median over CTAs "
          "(phase 0: kernel entry; a phase starts when its CTA leaves the barrier before it):")
    names = ["entry"] + [f"{i} {k}" for i, k in enumerate(kinds)] + ["final norm"]
    print("\n".join(_phase_lines(rel, names)))
    print("    CTA 0's first 28 stages (proj 1, then per layer qkv 2, o 1, gate|up 7, down 3), "
          "us waited / us held: " + _stage_line(libs[("stamped", "predictor_step")], 28))
    _with_lib(ps, shipped["predictor_step"])


# ---------------------------------------------------------------------------
# fused_norm_matmul on the weight stream

# variants of csrc/fused_block.cu, by -D flags
NORM_VARIANTS = {
    "stamped": ("QWEN3TTS_STAMPS",),
    "a copy of the shipped source": (),
    "the launch and the ring's set-up alone": ("QWEN3TTS_NM_EMPTY",),
    "int8 rounded to bf16 one at a time": ("QWEN3TTS_ONE_ROUNDING",),
    "4096 weights a stage": ("QWEN3TTS_NM_STAGE_WEIGHTS=4096",),
    "16384 weights a stage": ("QWEN3TTS_NM_STAGE_WEIGHTS=16384",),
    "one stage in flight": ("QWEN3TTS_NM_IN_FLIGHT=1",),
    "8 rows a thread in flight": ("QWEN3TTS_ROWS_IN_FLIGHT=8",),
    "512 consumers": ("QWEN3TTS_CONSUMERS=512", "QWEN3TTS_STAGE_BYTES=16384"),
    "stream alone (no products)": ("QWEN3TTS_NO_COMPUTE",),
    "2 CTAs an SM, tiles for twice the grid": ("QWEN3TTS_NM_CTAS=2",),
}
# the row-split variants (tools/norm_matmul_splits.cu), called with their
# own geometry: (library, fold) of each
SPLIT_LIBS = {"1 CTA an SM": (), "2 CTAs an SM": ("QWEN3TTS_NM_CTAS=2",)}
SPLIT_FOLDS = {"tagged": ("1 CTA an SM", 0), "cluster": ("1 CTA an SM", 1),
               "cluster, 2 CTAs an SM": ("2 CTAs an SM", 1)}
# the stamps: (0: entry, first stage landed (the consumers wait for it
# there in the stamped variant), norm done), (1: -, first stage taken, last
# stage consumed and folded), (2: -, -, stored)
NORM_PHASES = ["entry, first stage, norm", "weights", "store"]


def _ptxas_lines(log: str, kernel: str):
    """nvcc's ptxas report (registers, spills, shared memory) of each
    instance of ``kernel``, one line each."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("Used" in line or "spill" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out), text=True,
                               capture_output=True).stdout.splitlines()
        out = [(m.group(0) if (m := re.search(kernel + r"<[^>]*>", n)) else n, v)
               for n, (_, v) in zip(names, out)]
    return [f"  {n}: {v}" for n, v in out]


def _split_geo(H: int, N: int, grid: int, elt: int, max_splits: int, segment: int = 128):
    """Column tiles x row splits for the row-split variants: as many items
    as the grid holds, then the widest tiles, up to ``segment`` bytes of a
    weight row of ``elt``-byte elements, at most ``max_splits`` splits."""
    from ..ops import wstream

    best = None
    cols = wstream.tile_cols(N, grid, wstream.VEC)
    while best is None or cols * elt <= segment:
        tiles = -(-N // cols)
        splits = max(1, min(max_splits, grid // tiles, -(-H // wstream.MIN_SPLIT_ROWS)))
        if best is None or tiles * splits >= best[0]:
            best = (tiles * splits, cols, splits)
        cols *= 2
    _, cols, splits = best
    chunk = wstream.VEC * -(-H // (splits * wstream.VEC))
    return wstream.Geo(cols, -(-H // chunk), chunk)


def _split_fn(lib, fold, x, nw, ws, quant, geo, H, N):
    """fused_norm_matmul of a row-split variant at ``geo`` with ``fold`` (0
    tagged words, 1 a cluster), fn(i) over the layers' weights ``ws``, with
    the workspace the tagged-word fold reads."""
    nm = lib.qwen3tts_norm_matmul_split
    nm.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    nm.restype = ctypes.c_int
    part = torch.zeros((geo.splits, 1, N), dtype=torch.int64, device=x.device)
    sync = torch.tensor([0, 1, 0], dtype=torch.int32, device=x.device)

    def fn(i):
        w = ws[i % len(ws)]
        wq, sc = (w["q"], w["scale"]) if quant else (w, None)
        out = torch.empty((1, N), dtype=x.dtype, device=x.device)
        rc = nm(fold, int(quant), x.data_ptr(), nw.data_ptr(), wq.data_ptr(),
                None if sc is None else sc.data_ptr(), out.data_ptr(), part.data_ptr(),
                sync.data_ptr(), H, N, geo.cols, geo.splits, geo.chunk, 1e-6,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return out
    return fn


def norm_probe():
    from ..ops import fused_block as fb
    from ..ops import wstream
    from ..ops.quant import quantize_tensor

    dev = torch.device("cuda")
    libs, logs = _build_variants((NORM_VARIANTS, ("fused_block",)),
                                 (SPLIT_LIBS, ("norm_matmul_splits",)))
    shipped = cuda_build.library("fused_block")
    print("ptxas, fused_norm_matmul instances:")
    print("\n".join(_ptxas_lines(logs[("a copy of the shipped source", "fused_block")],
                                 "norm_matmul_kernel")))
    grid = cuda_build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    H = 1024
    shipped_geo = fb.norm_matmul_geometry

    def use_geo(fn):  # the wrapper caches the tile width per shape
        fb.norm_matmul_geometry = fn
        fb._norm_matmul_cols.cache_clear()

    # (where, N, layers, calls) as chip_smoke.py times them: one call per layer
    for where, N, L, calls in (("talker", 4096, 28, 28), ("predictor", 2048, 5, 70)):
        x = torch.randn((1, H), generator=g, device=dev).bfloat16()
        nw = (1 + 0.1 * torch.randn((H,), generator=g, device=dev)).bfloat16()
        geo = shipped_geo(H, N, grid)
        for wname, quant in (("int8", True), ("bf16", False)):
            elt = 1 if quant else 2
            splits = {"(b) 32-column tiles x row splits": wstream.phase_geo(H, N, grid),
                      "clusters of up to 4, 128-byte row segments": _split_geo(H, N, grid, elt, 4),
                      "clusters of up to 2": _split_geo(H, N, grid, elt, 2)}
            print(f"fused_norm_matmul {where} (H {H}, N {N}) x=bf16 w={wname} on {grid} SMs: "
                  f"shipped {geo}" + "".join(f"; {k} {v}" for k, v in splits.items()))

            def w():
                t = torch.randn((H, N), generator=g, device=dev) * H ** -0.5
                return quantize_tensor(t) if quant else t.bfloat16()
            ws = [w() for _ in range(L)]

            def call(i):
                return fb.fused_norm_matmul(x, nw, ws[i % L])

            line = []
            for name in ["shipped", *(v for v in NORM_VARIANTS if v != "stamped"), "shipped"]:
                if name.startswith("2 CTAs"):
                    use_geo(lambda h, n, gr: shipped_geo(h, n, 2 * gr))
                _with_lib(fb, libs[(name, "fused_block")] if name in NORM_VARIANTS else shipped)
                line.append(f"{name} {graph_us(call, calls):.2f}")
                use_geo(shipped_geo)
            ref = fb.fused_norm_matmul_plain(x, nw, ws[0])
            for gname, sgeo in splits.items():
                if sgeo.splits == 1:
                    continue
                for lname in (("tagged", "cluster") if gname.startswith("(b)")
                              else ("cluster", "cluster, 2 CTAs an SM")):
                    lib, fold = SPLIT_FOLDS[lname]
                    fn = _split_fn(libs[(lib, "norm_matmul_splits")], fold, x, nw, ws, quant,
                                   sgeo, H, N)
                    if (fn(0).float() - ref.float()).abs().max() > 0.1:
                        raise AssertionError(f"the {lname} row-split variant disagrees")
                    line.append(f"{gname} ({lname}) {graph_us(fn, calls):.2f}")
            _with_lib(fb, libs[("stream alone (no products)", "fused_block")])
            widths = []
            for cols in (8, 16, 32, 64, 128):
                other = wstream.Geo(cols, 1, H)
                use_geo(lambda *a, other=other: other)
                widths.append(f"{cols} columns ({wstream.num_items(H, N, other)} CTAs) "
                              f"{graph_us(call, calls):.2f}")
            use_geo(shipped_geo)
            line.append("stream alone, column tiles of a width: " + ", ".join(widths))
            _with_lib(fb, shipped)
            plain_us = graph_us(lambda i: fb.fused_norm_matmul_plain(x, nw, ws[i % L]), calls)
            line.append(f"plain {plain_us:.2f}")
            print("  us/call: " + "; ".join(line))
            stamped = libs[("stamped", "fused_block")]
            _with_lib(fb, stamped)
            for i in range(L + 1):
                out = call(i)
            if not torch.equal(call(0), out) or (out.float() - ref.float()).abs().max() > 0.1:
                raise AssertionError("the stamped variant disagrees with the shipped kernel")
            rel = _read_stamps(stamped, wstream.num_items(H, N, geo))
            print(f"    the last CTA stored at {np.nanmax(rel[:, 2, 2]):.2f} us from the first "
                  "CTA's entry")
            print("    per CTA, us from the first CTA's entry, median (slowest): "
                  "norm from entry to done; weights from the first stage landed to the last "
                  "stage consumed and folded; stored")
            print("\n".join(_phase_lines(rel, NORM_PHASES)))
            n_stages = len(wstream.stage_schedule([(geo.chunk, geo.cols * elt)], 99,
                                                  fb.NM_STAGE_WEIGHTS * elt))
            print(f"    CTA 0's {n_stages} stages, us waited / us held: "
                  + _stage_line(stamped, n_stages))
            _with_lib(fb, shipped)
            del ws


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA device")
    import sys

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    if which in ("all", "stream"):
        stream_probe()
    if which in ("all", "flash"):
        flash_probe()
    if which in ("all", "norm"):
        norm_probe()
    if which in ("all", "intmm"):
        intmm_probe()
    if which in ("all", "w8a8"):
        w8a8_probe()
    if which in ("all", "rows"):
        rows_probe()
    if which in ("all", "routed"):
        routed_probe()


def routed_probe():
    """See the module docstring (``routed``)."""
    from ..ops import routed_experts as rx

    H, I, E, K, B, L = 2048, 1792, 32, 4, 16, 22
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def n(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    w13 = torch.stack([n(E, H, 2 * I, scale=H ** -0.5) for _ in range(L)])
    w2 = torch.stack([n(E, I, H, scale=I ** -0.5) for _ in range(L)])
    x = n(B, H, scale=1.0)
    for touched in (4, 28):
        router = n(H, E, scale=H ** -0.5)
        h = torch.randn((B, H), generator=g, device=dev) * 0.1
        bias = torch.zeros((E,), device=dev)
        if touched == 4:
            bias[:4] = 10.0
        else:  # row r to experts 4r .. 4r + 3 (mod 28)
            for r in range(B):
                h[r, r] = 30.0
                for j in range(K):
                    router[r, (4 * r + j) % touched] = 1.0
        h, bias = h.to(torch.bfloat16), bias.to(torch.bfloat16)
        stats = torch.zeros((E + 2,), dtype=torch.int64, device=dev)
        us = graph_us(lambda i: rx.routed_experts(x, h, router, bias, w13[i], w2[i], K, True,
                                                  1.0, stats), L)
        got = float(stats[E]) / float(stats[E + 1])
        bound = (got * 3 * H * I + H * E) * 2 / 3.35e12 * 1e6
        print(f"routed_experts B {B}: {got:.0f} experts touched: {us:.1f} us a call "
              f"(bound {bound:.1f} us, {100 * bound / us:.1f} %)")


def rows_probe():
    """See the module docstring (``rows``)."""
    from ..core.presets import get_preset
    from ..models import predictor as predictor_lib
    from ..ops import predictor_step as ps

    cuda_build.load_all()
    libs, _ = _build_variants(({k: STREAM_VARIANTS[k] for k in
                                ("stamped", "stream alone (no products)")}, ("predictor_step",)))
    for line in cuda_build.build_log.get("predictor_step", "").splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            print("  " + line.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    pcfg = get_preset("qwen3-tts-0.6b").predictor
    Lp, S, KVH, D = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads,
                     pcfg.head_dim)
    steps = pcfg.num_codebooks - 1
    poss = [torch.full((1,), 2 + i, dtype=torch.int32, device=dev) for i in range(steps)]
    ropes = [tuple(t[0, 0] for t in predictor_lib._rope(pcfg, p.reshape(1, 1))) for p in poss]
    for Ht in (1024, 2048):
        wts = ps.micro_step_weights(predictor_lib.init_params(g, pcfg, Ht, torch.bfloat16, dev))
        nbytes = sum(t.numel() * t.element_size() for t in wts.values())
        bound = nbytes / 3.35e12 * 1e6
        print(f"fused_micro_step bf16, Ht {Ht}: {nbytes / 1e6:.1f} MB of weights, bound "
              f"{bound:.2f} us a micro-step")
        for R in (1, 2, 4, 8, 16):
            kk, vv = (torch.randn((Lp, R, S, KVH, D), generator=g, device=dev).bfloat16()
                      for _ in range(2))
            xs = [(0.5 * torch.randn((R, Ht), generator=g, device=dev)).bfloat16()
                  for _ in range(steps)]

            def step(i, fn=ps.fused_micro_step, k=kk, v=vv, x=None):
                return fn(wts, xs[i] if x is None else x, *ropes[i], k, v, poss[i],
                          pcfg.rms_norm_eps)

            k0, v0 = kk.clone(), vv.clone()
            outs = []
            for _ in range(2):
                kk.copy_(k0)
                vv.copy_(v0)
                outs.append([step(i)[0].clone() for i in range(steps)] + [kk.clone(), vv.clone()])
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            kp, vp = k0.clone(), v0.clone()
            err = max((step(i, ps.fused_micro_step_plain, kp, vp)[0].float()
                       - outs[0][i].float()).abs().max().item() for i in range(steps))
            t_k = graph_us(step, steps)
            singles = [tuple(t[:, r].contiguous() for t in (kk, vv)) for r in range(R)]
            t_1 = graph_us(lambda i: [step(i, k=a, v=b, x=xs[i][r:r + 1])
                                      for r, (a, b) in enumerate(singles)], steps)
            t_p = graph_us(lambda i: step(i, ps.fused_micro_step_plain), steps, replays=3)
            print(f"  R {R:2d}: kernel {t_k:.2f} us ({bound / t_k:.1%} of the bound), "
                  f"{R} one-row launches {t_1:.2f}, plain {t_p:.2f}; max |kernel - plain| "
                  f"{err:.3g} (chained), two runs the same bits: {same}")
            if Ht == 2048 or R not in (2, 16):
                continue
            shipped = ps._kernel_fns
            try:
                _with_lib(ps, libs[("stream alone (no products)", "predictor_step")])
                t_s = graph_us(step, steps)
                _with_lib(ps, libs[("stamped", "predictor_step")])
                for i in range(steps):
                    step(i)
                rel = _read_stamps(libs[("stamped", "predictor_step")], 132)
            finally:
                ps._kernel_fns = shipped
            print(f"    the stream alone (no products) {t_s:.2f} us; phases of the last step, us "
                  "from the first CTA's entry, median over CTAs (a phase's end: its outputs "
                  "written; the step after it ends where the next phase starts):")
            kinds = ["proj"] + ["qkv", "o", "gate|up", "down"] * Lp
            names = ["entry"] + [f"{i} {k}" for i, k in enumerate(kinds)] + ["final norm"]
            print("\n".join(_phase_lines(rel, names)))


def intmm_probe():
    """See the module docstring (``intmm``)."""
    from ..ops import w8a8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    refused = {"row-major": [], "column-major": []}
    for K in (32, 64, 96, 128, 192, 256, 512, 1024, 3072):
        for N in (64, 128, 512, 1024, 2048):
            for M in (17, 20, 64, 115):
                a, b = int8(M, K), int8(K, N)
                want = (a.double() @ b.double()).int()
                for layout, bb in (("row-major", b), ("column-major", b.t().contiguous().t())):
                    try:
                        ok = torch.equal(torch._int_mm(a, bb), want)
                    except RuntimeError:
                        ok = False
                    if not ok:
                        refused[layout].append((K, N, M))
    for layout, cases in refused.items():
        ks = sorted({k for k, _, _ in cases})
        print(f"torch._int_mm, {layout} int8 weight: {len(cases)} of 180 (K, N, M) cases "
              f"refused or wrong, at K {ks}")
    layers = 28
    for K, N in ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024)):
        ws = [int8(K, N) for _ in range(layers)]
        wcs = [w.t().contiguous().t() for w in ws]
        scale = torch.ones((1, N), device=dev)
        for M in (17, 32, 115, 460):
            a = int8(M, K)
            xb = torch.randn((M, K), generator=g, device=dev).bfloat16()
            t_nn = graph_us(lambda i: torch._int_mm(a, ws[i % layers]), layers)
            t_tn = graph_us(lambda i: torch._int_mm(a, wcs[i % layers]), layers)
            t_gemv = graph_us(lambda i: [w8a8.w8a8_gemv(xb[r: r + 16], ws[i % layers], scale,
                                                        torch.bfloat16)
                                         for r in range(0, M, 16)], layers)
            print(f"K {K} N {N} M {M}: torch._int_mm row-major {t_nn:.2f} us, column-major "
                  f"{t_tn:.2f} us; w8a8_gemv (quantize included) in {-(-M // 16)} blocks of "
                  f"16 rows {t_gemv:.2f} us")
        del ws, wcs


# chip_smoke.py's W8A8_SHAPES: where -> (K, N, layers of their own weights, calls a graph)
W8A8_SHAPES = {
    "talker_qkv": (1024, 4096, 28, 28), "talker_o": (2048, 1024, 28, 28),
    "talker_gateup": (1024, 6144, 28, 28), "talker_down": (3072, 1024, 28, 28),
    "pred_qkv": (1024, 2048, 5, 70), "pred_o": (1024, 1024, 5, 70),
    "talker_1.7b_qkv": (2048, 4096, 28, 28)}
W8A8_ROWS = (1, 2, 4, 8, 16)


def unfused_geometry(M: int, K: int, N: int, sms: int):
    """(mt, vec, splits) of tools/w8a8_unfused.cu's GEMV (its source's note)."""
    mt = 1
    while mt < M:
        mt *= 2
    vec = min(16, 64 // mt)
    while vec > 4 and (N % vec or -(-N // (32 * vec)) * 16 < sms):
        vec //= 2
    tiles = -(-N // (32 * vec))
    cap = min(16, max(1, K // 64))
    splits = 1
    while 2 * splits <= cap and tiles * 2 * splits <= 2 * sms:
        splits *= 2
    return mt, vec, splits


def _unfused_pair(lib, sms: int):
    """quantize_act + GEMV of tools/w8a8_unfused.cu: pair(x bf16 [M, K], q8,
    scale) -> bf16 [M, N], two launches."""
    qa, mv = lib.qwen3tts_unfused_quantize_act, lib.qwen3tts_unfused_w8a8_gemv
    qa.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    mv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    qa.restype = mv.restype = ctypes.c_int

    def pair(x, q8, scale):
        (M, K), N = x.shape, q8.shape[1]
        st = torch.cuda.current_stream().cuda_stream
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        rc = qa(0, x.data_ptr(), xq.data_ptr(), xs.data_ptr(), M, K, st) or mv(
            0, xq.data_ptr(), xs.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(), M,
            K, N, *unfused_geometry(M, K, N, sms), st)
        if rc:
            raise RuntimeError(f"the unfused w8a8 pair failed to launch: cudaError {rc}")
        return out
    return pair


W8A8_PHASES = ["stream issued", "x loaded", "|max| of the CTA", "maxima exchanged",
               "xs shared", "quantized", "first stage landed", "last dot step done",
               "sums in shared memory", "fold barrier passed", "stored"]


def _w8a8_phases(lib, grid: int) -> list:
    """The stamped fused kernel's last launch: per phase, the median and the
    last CTA, us from the first CTA's entry."""
    fn = lib.qwen3tts_w8a8_stamps
    fn.argtypes = [ctypes.c_void_p]
    buf = np.zeros((512, 16), dtype=np.uint64)
    torch.cuda.synchronize()
    if fn(buf.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    st = buf[:grid].astype(np.int64)
    rel = (st - st[:, 0].min()).astype(np.float64) / 1e3
    rel[(rel < 0) | (rel > 1e3)] = np.nan  # stamps of an earlier launch
    out = [f"entry {np.nanmedian(rel[:, 0]):.2f} ({np.nanmax(rel[:, 0]):.2f})"]
    for i, name in enumerate(W8A8_PHASES, start=1):
        if not np.isnan(rel[:, i]).all():
            out.append(f"{name} {np.nanmedian(rel[:, i]):.2f} ({np.nanmax(rel[:, i]):.2f})")
    return out


def w8a8_probe():
    """See the module docstring (``w8a8``)."""
    from ..ops import w8a8 as W
    from ..ops.quant import quantize_tensor

    dev = torch.device("cuda")
    sms = cuda_build.sm_count(dev)
    libs, _ = _build_variants(({"copy": ()}, ("w8a8_unfused",)),
                              ({"stamped": ("QWEN3TTS_STAMPS",)}, ("w8a8",)))
    pair = _unfused_pair(libs[("copy", "w8a8_unfused")], sms)
    stamped, shipped = libs[("stamped", "w8a8")], cuda_build.library("w8a8")
    g = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16

    def q(K, N):
        return quantize_tensor(torch.randn((K, N), generator=g, device=dev) * K ** -0.5, "w8a8")

    for K, N in ((64, 128), (1024, 128)):
        w, x = q(K, N), torch.randn((1, K), generator=g, device=dev).bfloat16()
        geo = W.gemv_geometry(1, K, N, sms)
        print(f"floor: fused kernel at K {K} x N {N}, 1 row, {geo.splits} CTAs (one cluster): "
              f"{graph_us(lambda i: W.w8a8_gemv(x, w['q8'], w['scale'], bf), 28):.2f} us/call")
    print("us/call, bf16 x, in turns: unfused pair, fused, bf16 torch.matmul, torch._int_mm "
          "(17 rows), fused, unfused pair; then the fused kernel's variants")
    for where, (K, N, layers, calls) in W8A8_SHAPES.items():
        ws = [q(K, N) for _ in range(layers)]
        wb = [torch.randn((K, N), generator=g, device=dev).bfloat16() for _ in range(layers)]
        x17 = torch.randint(-127, 128, (17, K), generator=g, device=dev, dtype=torch.int8)
        for M in W8A8_ROWS:
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            ref = W.w8a8_gemv_plain(x, ws[0]["q8"], ws[0]["scale"], bf)
            geo = W.gemv_geometry(M, K, N, sms, 2)
            variants = {"other dot": W.gemv_geometry(M, K, N, sms, 2, mma=not geo.mma)}
            if geo.splits > 1:
                variants["|max| exchanged" if geo.whole else "|max| over whole rows"] = \
                    W.gemv_geometry(M, K, N, sms, 2, whole=not geo.whole)
            if M in (1, 16):
                variants.update({
                    "stages of 64 rows": W.gemv_geometry(M, K, N, sms, 2, mma=geo.mma,
                                                         stage_rows=64),
                    "stages of 128 rows": W.gemv_geometry(M, K, N, sms, 2, mma=geo.mma,
                                                          stage_rows=128),
                    "a ring of one stage": W.gemv_geometry(
                        M, K, N, sms, 2, mma=geo.mma,
                        ring_bytes=min(geo.kc, W.MAX_STAGE_ROWS) * W.TILE),
                    "twice the CTAs": W.gemv_geometry(M, K, N, sms, 2, mma=geo.mma,
                                                      ctas=2 * sms)})
            checks = {"unfused": pair(x, ws[0]["q8"], ws[0]["scale"]),
                      "fused": W.w8a8_gemv(x, ws[0]["q8"], ws[0]["scale"], bf),
                      **{v: W.w8a8_gemv(x, ws[0]["q8"], ws[0]["scale"], bf, geometry=gv)
                         for v, gv in variants.items()}}
            torch.cuda.synchronize()
            for name, y in checks.items():
                if not torch.equal(y, ref):
                    raise AssertionError(f"w8a8 {name} differs from the plain version at "
                                         f"{where} M={M}")

            def fused(i, gv=None):
                w = ws[i % layers]
                return W.w8a8_gemv(x, w["q8"], w["scale"], bf, geometry=gv)
            t = {}
            for name, fn in (("unfused", lambda i: pair(x, ws[i % layers]["q8"],
                                                          ws[i % layers]["scale"])),
                             ("fused", fused),
                             ("bf16 torch.matmul", lambda i: torch.matmul(x, wb[i % layers])),
                             ("torch._int_mm 17 rows",
                              lambda i: torch._int_mm(x17, ws[i % layers]["q8"])),
                             ("fused", fused),
                             ("unfused", lambda i: pair(x, ws[i % layers]["q8"],
                                                          ws[i % layers]["scale"]))):
                t.setdefault(name, []).append(graph_us(fn, calls))
            for v, gv in variants.items():
                t[f"{v} {tuple(gv[:4])}"] = [graph_us(lambda i, gv=gv: fused(i, gv), calls)]
            bound = max((K * N + 2 * M * K + 4 * N + 2 * M * N) / 3.35e12,
                        2 * M * K * N / 1.979e15) * 1e6
            print(f"w8a8 {where} K={K} N={N} M={M} fused {tuple(geo)}, unfused "
                  f"{unfused_geometry(M, K, N, sms)}; bound {bound:.2f}: " + "; ".join(
                      f"{k} {' / '.join(f'{u:.2f}' for u in v)}" for k, v in t.items()),
                  flush=True)
            if M in (1, 16):
                _with_lib(W, stamped)
                for gname, gv in (("shipped", geo), *(
                        (v, gv) for v, gv in variants.items() if v.startswith("|max|"))):
                    for i in range(layers + 1):
                        fused(i, gv)
                    print(f"  phases ({gname}), us from the first CTA's entry, median (last "
                          "CTA): " + "; ".join(_w8a8_phases(stamped,
                                                            -(-N // W.TILE) * gv.splits)))
                _with_lib(W, shipped)
        del ws, wb


def flash_probe():
    dev = torch.device("cuda")
    libs = _build(_variants())

    def stream():
        return torch.cuda.current_stream().cuda_stream

    empty = libs["stamped"].probe_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    t_empty = graph_us(lambda i: empty(128, stream()), 28)
    print(f"empty kernel, 128 CTAs, as a graph node: {t_empty:.2f} us")
    cl = libs["stamped"].probe_clusters
    print("clusters the card holds at once, of 8 / 16 CTAs: "
          f"{cl(8)} / {cl(16)} (8 kv heads need 8)")

    L, B, S, KVH, NH, D = 28, 1, 2048, 8, 16, 128
    g = torch.Generator(device=dev).manual_seed(0)
    stacks = [tuple(torch.randn((L, B, S, KVH, D), generator=g, device=dev).bfloat16()
                    for _ in range(2)) for _ in range(2)]
    q = torch.randn((B, NH, D), generator=g, device=dev).bfloat16()
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    splits = fd.num_splits(S, B, KVH, cuda_build.sm_count(dev))
    ws = (torch.empty((B, KVH, splits, 2, D), device=dev),
          torch.empty((B, KVH, splits, 2, 2), device=dev),
          torch.zeros((B, KVH), dtype=torch.int32, device=dev))
    shipped = fd._kernel_fn()
    fns = {"shipped": shipped, "base2": _flash_fn(libs["base2"]), "pdl": _flash_fn(libs["pdl"]),
           "stamped": _flash_fn(libs["stamped"])}

    def call(fn, p, i):
        kk, vv = stacks[i // L]
        rc = fn(0, 0, q.data_ptr(), kk.data_ptr(), vv.data_ptr(), None, None, out.data_ptr(),
                p.data_ptr(), zero.data_ptr(), *(t.data_ptr() for t in ws), i % L, B, S, NH,
                KVH, D, 0, float(D ** -0.5), splits, stream())
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    scratch = torch.zeros((1, NH, D), device=dev)
    for pos, n in ((300, 2), (2000, 1)):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        line = []
        for name in ("shipped", "base2", "pdl", "pdl", "base2", "shipped"):
            line.append(f"{name} {graph_us(lambda i: call(fns[name], p, i), n * L):.2f}")
        for name in ("shipped", "pdl"):
            def mixed(i, name=name):
                scratch.add_(1.0)
                call(fns[name], p, i)
            alone = graph_us(lambda i: scratch.add_(1.0), n * L)
            line.append(f"{name} after a PyTorch kernel {graph_us(mixed, n * L):.2f} "
                        f"(the PyTorch kernel alone {alone:.2f})")
        qs, live = q[:, :, None, :], pos + 1
        sdpa = graph_us(lambda i: F.scaled_dot_product_attention(
            qs, stacks[i // L][0][i % L, :, :live].transpose(1, 2),
            stacks[i // L][1][i % L, :, :live].transpose(1, 2), enable_gqa=True), n * L)
        print(f"flash-decode bf16 pos {pos} ({'cold, 2 stacks' if n == 2 else 'one stack'}), "
              f"us/call: " + "; ".join(line) + f"; SDPA {sdpa:.2f}")

        # one stamped call, a layer not read for 27 calls before it
        for i in range(L):
            call(fns["stamped"], p, i)
        call(fns["stamped"], p, 0)
        torch.cuda.synchronize()
        buf = np.zeros(1024 * 8, dtype=np.uint64)
        stamps_fn = libs["stamped"].probe_stamps
        stamps_fn.argtypes = [ctypes.c_void_p]
        stamps_fn(buf.ctypes.data)
        st = buf[:KVH * splits * 8].reshape(-1, 8).astype(np.int64)
        rel = (st - st[:, 0].min()) / 1e3
        parts = []
        for i, name in enumerate(PHASES, start=1):
            col = rel[:, i][(rel[:, i] >= 0) & (rel[:, i] < 1e3)]  # this call's stamps only
            parts.append(f"{name} ends {np.median(col):.2f} (max {col.max():.2f})")
        print(f"  phases at pos {pos}, us from the first CTA's start, median over CTAs: "
              + "; ".join(parts))
    del stacks

    print(f"int8 KV cache entries differing card vs CPU, chip_smoke.py's int8 parity model: "
          f"shipped {_int8_flips(None)}, base2 {_int8_flips(fns['base2'])}")

    K, N = 1024, 65536
    w = torch.randn((K, N), generator=g, device=dev).bfloat16()
    x = torch.randn((1, K), generator=g, device=dev).bfloat16()
    sink = torch.empty((1,), device=dev)
    read = libs["stream"].probe_stream
    read.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p]
    n16 = w.numel() * 2 // 16
    plain_read = graph_us(lambda i: read(w.data_ptr(), n16, sink.data_ptr(), 2112, stream()), 20)
    print(f"matvec K {K} x N {N} bf16 ({w.numel() * 2 / 1e6:.1f} MB), us/call: "
          f"kernel {graph_us(lambda i: mv.matvec(x, w), 20):.2f}, torch.matmul "
          f"{graph_us(lambda i: torch.matmul(x, w), 20):.2f}, a plain read of the same bytes "
          f"{plain_read:.2f}")


if __name__ == "__main__":
    main()
