#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qwen3tts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. probe  — the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions.  Without a CUDA device the script stops before printing
   anything.
2. kernel — builds every csrc/*.cu with nvcc for sm_90a (one nvcc each, all
   at once) and holds each kernel against its plain version:
   flash-decode at the 0.6B talker's shapes (L=28, B=1, S=2048, KVH=8,
   NH=16, D=128) over (layer, pos, pad, window) cases, with a float cache
   and with an int8 cache + scales; fused_norm_matmul and fused_o_mlp at
   the 0.6B talker's and predictor's shapes, with bf16 and int8 weights.
   bf16 (the main path's dtype) is held to 2e-3 + 1.6e-2*|ref|, float32 to
   1e-5 (where a slot or a row counted wrong shows above the tolerance).
   Then times kernel and plain version (CUDA graph of 28 calls for the
   talker's shapes, 70 for the predictor's, CUDA events).
3. slice  — FasterQwen3TTS("random:qwen3-tts-0.6b", bf16) on the card
   answers three requests through the public API (non-streaming, then two
   streaming at chunk 8), 48 steps each; checks audio length, range,
   chunk count, and that the main path launched the kernel 28 times a step.
4. slice-int8 — the same model with quantize="int8", kv_quant=True and the
   engine rebuilt with use_fused_kernels=True answers a non-streaming and a
   streaming (chunk 8) request, 48 steps each; checks the audio and that
   every step launched fused_norm_matmul and fused_o_mlp 98 times each
   (28 talker layers + 5 predictor layers x 14 micro-steps) and the
   int8-KV flash-decode kernel 28 times.
5. parity — a small float32 model: talker prefill + decode steps and the
   codec decode on the card (kernels, TF32 off) against the same on the
   CPU (plain versions); then the same talker with int8 weights, an int8
   KV cache and the fused kernels, and predictor micro-steps through the
   fused kernels.

Prints the kernels' JSON line before the last line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

STEPS = 48
CHUNK = 8
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|
BF16_TOL = (2e-3, 1.6e-2)  # kernel and plain each round to bf16: 2 ulps of |ref|
F32_TOL = (1e-5, 0.0)  # summation order only
F32_ATOL = 1e-4  # small float32 model, card vs CPU (parity phase)
TEXT_A = ("The quick brown fox jumps over the lazy dog while the tired developer "
          "benchmarks text to speech engines.")
TEXT_C = "A second request with different words, streamed in chunks of eight frames."


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, calls: int, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn(i)``: ``calls`` calls are captured
    in one CUDA graph and replayed, timed with CUDA events, so the host's
    launch overhead is not in the number."""
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
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------------------


def probe():
    from qwen3tts_tpu_torch.ops import cuda_build

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    nv = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True, text=True)
    log(f"nvcc: {nv.stdout.strip().splitlines()[-1]}")
    return card


def _held(name: str, out: torch.Tensor, ref: torch.Tensor, tol, what: str) -> float:
    """max |out - ref|; raises past atol + rtol * |ref| or on a non-finite value."""
    atol, rtol = tol
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output at {what}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    log(f"  {name} {what}: max_abs_err={err:.3e} (tol {atol} + {rtol}*|ref|)")
    if (diff - atol - rtol * ref.float().abs()).max().item() > 0:
        raise AssertionError(f"{name} kernel disagrees with plain at {what}: "
                             f"max_abs_err {err}")
    return err


def kernel_phase(card: str):
    from qwen3tts_tpu_torch.ops import cuda_build
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, B, S, KVH, NH, D = 28, 1, 2048, 8, 16, 128
    t0 = time.time()
    cuda_build.load_all()
    log(f"kernel build+load (all sources, in parallel): {time.time() - t0:.1f}s")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    g = torch.Generator(device=dev).manual_seed(0)
    k32 = torch.randn((L, B, S, KVH, D), generator=g, device=dev)
    v32 = torch.randn((L, B, S, KVH, D), generator=g, device=dev)
    q32 = torch.randn((B, NH, D), generator=g, device=dev)
    k, v, q = (t.to(torch.bfloat16) for t in (k32, v32, q32))

    def ints(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    # (layer, pos, pad, window)
    cases = [(0, 0, 0, None), (5, 63, 0, None), (13, 64, 0, None), (27, 299, 0, None),
             (3, 511, 17, None), (20, 2047, 0, None), (9, 40, 100, None),
             (11, 1500, 0, 300), (2, 255, 250, None)]
    max_err = {}
    before = fd.flash_decode.launches
    for name, (qq, kk, vv), (atol, rtol) in (("bf16", (q, k, v), BF16_TOL),
                                            ("f32", (q32, k32, v32), F32_TOL)):
        max_err[name] = 0.0
        for layer, pos, pad, window in cases:
            out = fd.flash_decode(qq, kk, vv, layer, ints(pos), ints(pad), window)
            ref = fd.flash_decode_plain(qq, kk, vv, layer, ints(pos), ints(pad), window)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"non-finite kernel output at {layer, pos, pad, window}")
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            excess = (diff - atol - rtol * ref.float().abs()).max().item()
            if pad > pos and out.abs().max().item() != 0.0:
                raise AssertionError("pad > pos must give exact zeros")
            log(f"  {name} case layer={layer} pos={pos} pad={pad} window={window}: "
                f"max_abs_err={err:.3e} (tol {atol} + {rtol}*|ref|)")
            if excess > 0:
                raise AssertionError(f"{name} kernel disagrees with plain at "
                                     f"{layer, pos, pad, window}: max_abs_err {err}")
            max_err[name] = max(max_err[name], err)
    if fd.flash_decode.launches - before != 2 * len(cases):
        raise AssertionError("launch counter does not count launches")

    times = {}
    zero = ints(0)
    for pos in (300, 2000):
        p = ints(pos)
        # one call per layer, as a decode step makes them: each call reads a
        # different layer's slice of the cache
        t_k = graph_ms(lambda i: fd.flash_decode(q, k, v, i, p, zero), L)
        t_p = graph_ms(lambda i: fd.flash_decode_plain(q, k, v, i, p, zero), L)
        times[pos] = (t_k, t_p)
        live = pos + 1
        gbs = live * KVH * D * 2 * 2 / (t_k * 1e-3) / 1e9
        log(f"  timing pos={pos}: kernel {t_k * 1e3:.2f} us/call ({gbs:.1f} GB/s of live KV), "
            f"plain {t_p * 1e3:.2f} us/call  [{card}]")
    return max_err, times


def int8kv_kernel_phase(card: str):
    """The int8-cache flash-decode kernel: the same nine cases and shapes as
    the float cache, K/V quantized per (slot, kv head) as the cache write
    does, q in bf16 and in float32."""
    from qwen3tts_tpu_torch.models.layers import _quantize_rows
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, B, S, KVH, NH, D = 28, 1, 2048, 8, 16, 128
    g = torch.Generator(device=dev).manual_seed(1)
    kq, ks = _quantize_rows(torch.randn((L, B, S, KVH, D), generator=g, device=dev))
    vq, vs = _quantize_rows(torch.randn((L, B, S, KVH, D), generator=g, device=dev))
    ks, vs = (t.transpose(-1, -2).contiguous() for t in (ks, vs))  # [L, B, KVH, S]
    q32 = torch.randn((B, NH, D), generator=g, device=dev)

    def ints(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    cases = [(0, 0, 0, None), (5, 63, 0, None), (13, 64, 0, None), (27, 299, 0, None),
             (3, 511, 17, None), (20, 2047, 0, None), (9, 40, 100, None),
             (11, 1500, 0, 300), (2, 255, 250, None)]
    max_err = {}
    before = fd.flash_decode.launches_int8kv
    for name, qq, tol in (("bf16", q32.bfloat16(), BF16_TOL), ("f32", q32, F32_TOL)):
        max_err[name] = 0.0
        for layer, pos, pad, window in cases:
            args = (qq, kq, vq, layer, ints(pos), ints(pad), window, ks, vs)
            out = fd.flash_decode(*args)
            err = _held(f"int8kv {name}", out, fd.flash_decode_plain(*args), tol,
                        f"layer={layer} pos={pos} pad={pad} window={window}")
            if pad > pos and out.abs().max().item() != 0.0:
                raise AssertionError("pad > pos must give exact zeros")
            max_err[name] = max(max_err[name], err)
    if fd.flash_decode.launches_int8kv - before != 2 * len(cases):
        raise AssertionError("int8-KV launch counter does not count launches")
    times = {}
    q, zero = q32.bfloat16(), ints(0)
    for pos in (300, 2000):
        p = ints(pos)
        t_k = graph_ms(lambda i: fd.flash_decode(q, kq, vq, i, p, zero, None, ks, vs), L)
        t_p = graph_ms(lambda i: fd.flash_decode_plain(q, kq, vq, i, p, zero, None, ks, vs), L)
        times[pos] = (t_k, t_p)
        gbs = (pos + 1) * KVH * (D + 4) * 2 / (t_k * 1e-3) / 1e9
        log(f"  int8kv timing pos={pos}: kernel {t_k * 1e3:.2f} us/call ({gbs:.1f} GB/s of "
            f"live KV + scales), plain {t_p * 1e3:.2f} us/call  [{card}]")
    return max_err, times


def fused_kernel_phase(card: str):
    """fused_norm_matmul and fused_o_mlp against their plain versions at the
    0.6B talker's shapes (H 1024, qkv N 4096, Dq 2048, I 3072) and the
    predictor's (qkv N 2048, Dq 1024), B = 1: bf16 with bf16 and with int8
    weights, float32 with float32 and with int8 weights.  Timing: one call
    per layer in a CUDA graph, each layer with its own weights, as a step
    makes them (28 talker calls; 70 predictor calls over its 5 layers)."""
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops.quant import quantize_tensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = {"talker": dict(H=1024, Dq=2048, N=4096, I=3072, layers=28, calls=28),
              "predictor": dict(H=1024, Dq=1024, N=2048, I=3072, layers=5, calls=70)}
    max_err = {"fused_norm_matmul": 0.0, "fused_o_mlp": 0.0}
    times = {}
    for where, sh in shapes.items():
        H, Dq, N, I = sh["H"], sh["Dq"], sh["N"], sh["I"]
        x32 = torch.randn((1, H), generator=g, device=dev)
        attn32 = torch.randn((1, Dq), generator=g, device=dev)
        nw32 = 1 + 0.1 * torch.randn((H,), generator=g, device=dev)

        def weights(dtype, quant, layers):
            def w(rows, cols):
                t = torch.randn((rows, cols), generator=g, device=dev) * rows ** -0.5
                return quantize_tensor(t) if quant else t.to(dtype)
            return [dict(qkv=w(H, N), o=w(Dq, H), gu=w(H, 2 * I), d=w(I, H))
                    for _ in range(layers)]

        for dname, dt, tol in (("bf16", torch.bfloat16, BF16_TOL),
                               ("f32", torch.float32, F32_TOL)):
            x, attn, nw = x32.to(dt), attn32.to(dt), nw32.to(dt)
            for wname, quant in (("int8" if q else dname, q) for q in (False, True)):
                ws = weights(dt, quant, sh["layers"] if dname == "bf16" else 1)
                w0 = ws[0]
                what = f"{where} x={dname} w={wname}"
                err = _held("fused_norm_matmul", fb.fused_norm_matmul(x, nw, w0["qkv"]),
                            fb.fused_norm_matmul_plain(x, nw, w0["qkv"]), tol, what)
                max_err["fused_norm_matmul"] = max(max_err["fused_norm_matmul"], err)
                out = fb.fused_o_mlp(x, attn, w0["o"], nw, w0["gu"], w0["d"])
                again = fb.fused_o_mlp(x, attn, w0["o"], nw, w0["gu"], w0["d"])
                err = _held("fused_o_mlp", out,
                            fb.fused_o_mlp_plain(x, attn, w0["o"], nw, w0["gu"], w0["d"]),
                            tol, what)
                if not torch.equal(out, again):
                    raise AssertionError(f"fused_o_mlp is not deterministic at {what}")
                max_err["fused_o_mlp"] = max(max_err["fused_o_mlp"], err)
                if dname != "bf16":
                    del ws
                    continue
                n, calls = sh["layers"], sh["calls"]
                for kname, fn, plain in (
                        ("fused_norm_matmul",
                         lambda i: fb.fused_norm_matmul(x, nw, ws[i % n]["qkv"]),
                         lambda i: fb.fused_norm_matmul_plain(x, nw, ws[i % n]["qkv"])),
                        ("fused_o_mlp",
                         lambda i: fb.fused_o_mlp(x, attn, ws[i % n]["o"], nw, ws[i % n]["gu"],
                                                  ws[i % n]["d"]),
                         lambda i: fb.fused_o_mlp_plain(x, attn, ws[i % n]["o"], nw,
                                                        ws[i % n]["gu"], ws[i % n]["d"]))):
                    t_k, t_p = graph_ms(fn, calls), graph_ms(plain, calls)
                    times[(kname, where, wname)] = (t_k, t_p)
                    wbytes = sum(t.numel() * t.element_size() for key in (
                        ("qkv",) if kname == "fused_norm_matmul" else ("o", "gu", "d"))
                        for t in (ws[0][key].values() if quant else [ws[0][key]]))
                    log(f"  timing {kname} {where} x=bf16 w={wname}: kernel "
                        f"{t_k * 1e3:.2f} us/call ({wbytes / (t_k * 1e-3) / 1e9:.0f} GB/s of "
                        f"weights), plain {t_p * 1e3:.2f} us/call  [{card}]")
                del ws
    return max_err, times


def _ref_wav(path: str):
    from qwen3tts_tpu_torch.audio.wav import write_wav

    sr = 24_000
    tt = np.linspace(0, 3.0, 3 * sr, dtype=np.float32)
    ref = (0.25 * np.sin(2 * np.pi * 180 * tt)
           * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * tt))).astype(np.float32)
    write_wav(path, ref, sr)


def _check_audio(audio: np.ndarray, steps: int, spf: int, what: str):
    if audio.shape != (steps * spf,):
        raise AssertionError(f"{what}: audio shape {audio.shape} != ({steps * spf},)")
    if not np.isfinite(audio).all() or np.abs(audio).max() > 1.0:
        raise AssertionError(f"{what}: audio not finite or outside [-1, 1]")


def slice_phase(card: str):
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode

    steps, chunk, sync = STEPS, CHUNK, torch.cuda.synchronize
    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b", device="cuda",
                                           dtype="bfloat16")
    sync()
    log(f"load random:qwen3-tts-0.6b: {time.time() - t0:.1f}s")
    layers = model.cfg.talker.num_hidden_layers
    spf = model.vocoder.spf
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        kw = dict(language="English", ref_audio=ref, ref_text="reference transcript",
                  max_new_tokens=steps, min_new_tokens=steps)
        # warm-up request (allocator, cuBLAS handles); not counted
        model.generate_voice_clone(text=TEXT_A, **{**kw, "max_new_tokens": 8,
                                                   "min_new_tokens": 8})
        results = {}
        flash_decode.launches = 0  # the main path's run starts here
        sync()
        t = time.time()
        wavs, _ = model.generate_voice_clone(text=TEXT_A, **kw)
        sync()
        wall_a = time.time() - t
        launches_a = flash_decode.launches
        _check_audio(wavs[0], steps, spf, "request a")
        results["a"] = {"wall_s": wall_a, "rtf": steps / 12.0 / wall_a,
                        "ms_per_step": wall_a / steps * 1e3}
        for name, text in (("b", TEXT_A), ("c", TEXT_C)):
            t = time.time()
            first = None
            chunks, timings = [], []
            for audio, _sr, timing in model.generate_voice_clone_streaming(
                    text=text, chunk_size=chunk, **kw):
                if first is None:
                    first = (time.time() - t) * 1e3
                chunks.append(audio)
                timings.append(timing)
            sync()
            wall = time.time() - t
            n_chunks = -(-steps // chunk)
            if len(chunks) != n_chunks:
                raise AssertionError(f"request {name}: {len(chunks)} chunks != {n_chunks}")
            if any(c.shape != (min(chunk, steps - i * chunk) * spf,)
                   for i, c in enumerate(chunks)):
                raise AssertionError(f"request {name}: chunk lengths {[c.shape for c in chunks]}")
            _check_audio(np.concatenate(chunks), steps, spf, f"request {name}")
            if not timings[-1]["is_final"] or timings[-1]["total_steps_so_far"] != steps:
                raise AssertionError(f"request {name}: bad final timing {timings[-1]}")
            results[name] = {"wall_s": wall, "rtf": steps / 12.0 / wall, "ttfa_ms": first,
                             "prefill_ms": timings[0]["prefill_ms"],
                             "ms_per_step": wall / steps * 1e3}
        sync()
        launches = flash_decode.launches  # the main path's run ends here
    if launches_a < layers * steps or launches < 3 * layers * steps:
        raise AssertionError(f"flash_decode launched {launches} times "
                             f"(request a: {launches_a}); want >= {layers} per step")
    for name, r in results.items():
        log(f"  request {name}: " + ", ".join(f"{k}={v:.2f}" for k, v in r.items())
            + f"  [{card}]")
    return launches, results


def slice_int8_phase(card: str):
    """The int8 + fused-block path: int8 weights, int8 KV cache, fused
    kernels; one non-streaming and one streaming (chunk 8) request."""
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode
    from qwen3tts_tpu_torch.runtime.engine import Engine

    steps, chunk, sync = STEPS, CHUNK, torch.cuda.synchronize
    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b", device="cuda",
                                           dtype="bfloat16", quantize="int8", kv_quant=True)
    model.engine = Engine(model.params["talker"], model.params["predictor"], model.cfg,
                          max_seq_len=model.max_seq_len, use_fused_kernels=True,
                          kv_quant=True)
    sync()
    log(f"load random:qwen3-tts-0.6b int8 + kv_quant + fused: {time.time() - t0:.1f}s")
    if model.engine.new_kv()["k"].dtype != torch.int8:
        raise AssertionError("kv_quant did not give an int8 cache")
    layers = model.cfg.talker.num_hidden_layers
    per_step = layers + model.cfg.predictor.num_hidden_layers * (
        model.cfg.predictor.num_codebooks - 1)
    spf = model.vocoder.spf

    def counts():
        return {"fused_norm_matmul": fb.fused_norm_matmul.launches,
                "fused_o_mlp": fb.fused_o_mlp.launches,
                "flash_decode_int8kv": flash_decode.launches_int8kv,
                "flash_decode": flash_decode.launches}

    want = {"fused_norm_matmul": per_step, "fused_o_mlp": per_step,
            "flash_decode_int8kv": layers, "flash_decode": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        kw = dict(language="English", ref_audio=ref, ref_text="reference transcript",
                  max_new_tokens=steps, min_new_tokens=steps)
        model.generate_voice_clone(text=TEXT_A, **{**kw, "max_new_tokens": 8,
                                                   "min_new_tokens": 8})  # warm-up
        results = {}
        # the main path's run starts here
        fb.fused_norm_matmul.launches = fb.fused_o_mlp.launches = 0
        flash_decode.launches = flash_decode.launches_int8kv = 0
        sync()
        t = time.time()
        wavs, _ = model.generate_voice_clone(text=TEXT_A, **kw)
        sync()
        wall = time.time() - t
        after_a = counts()
        _check_audio(wavs[0], steps, spf, "int8 request a")
        results["a"] = {"wall_s": wall, "rtf": steps / 12.0 / wall,
                        "ms_per_step": wall / steps * 1e3}
        t = time.time()
        first, chunks, timings = None, [], []
        for audio, _sr, timing in model.generate_voice_clone_streaming(
                text=TEXT_C, chunk_size=chunk, **kw):
            if first is None:
                first = (time.time() - t) * 1e3
            chunks.append(audio)
            timings.append(timing)
        sync()
        wall = time.time() - t
        launches = counts()  # the main path's run ends here
        if len(chunks) != -(-steps // chunk):
            raise AssertionError(f"int8 request b: {len(chunks)} chunks")
        _check_audio(np.concatenate(chunks), steps, spf, "int8 request b")
        if not timings[-1]["is_final"] or timings[-1]["total_steps_so_far"] != steps:
            raise AssertionError(f"int8 request b: bad final timing {timings[-1]}")
        results["b"] = {"wall_s": wall, "rtf": steps / 12.0 / wall, "ttfa_ms": first,
                        "prefill_ms": timings[0]["prefill_ms"],
                        "ms_per_step": wall / steps * 1e3}
    for name, n in want.items():
        if after_a[name] != n * steps or launches[name] != 2 * n * steps:
            raise AssertionError(f"{name} launched {after_a[name]} / {launches[name]} times "
                                 f"in one / two {steps}-step requests; want {n} per step")
    log(f"  int8 path launches per step: "
        + ", ".join(f"{k}={v / (2 * steps):g}" for k, v in launches.items()))
    for name, r in results.items():
        log(f"  int8 request {name}: " + ", ".join(f"{k}={v:.2f}" for k, v in r.items())
            + f"  [{card}]")
    return launches, results


def parity_phase(card: str):
    """Small float32 model, card (kernel) vs CPU (plain): talker prefill
    logits, decode-step hiddens and the codec decode."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import codec as codec_lib
    from qwen3tts_tpu_torch.models import talker as talker_lib
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    # full float32 on the card for the comparison: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        # the talker's head layout (head_dim 128, 2 query heads per kv head),
        # so the card's decode runs the kernel
        talker = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20))
        cfg = dataclasses.replace(base, talker=talker)
        params = init_random(cfg, seed=3, dtype=torch.float32, device="cpu")
        rng = np.random.default_rng(0)
        H = cfg.talker.hidden_size
        embeds = rng.standard_normal((1, 12, H)).astype(np.float32) * 0.1
        xs = rng.standard_normal((16, 1, 1, H)).astype(np.float32) * 0.1
        codes = rng.integers(0, cfg.codec.codebook_size, (1, 24, 16))

        def run(device):
            dev = torch.device(device)
            move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) \
                else [move(v) for v in t] if isinstance(t, list) else t.to(dev)
            p = move(params)
            kv = talker_lib.new_kv_cache(cfg.talker, 1, 64, torch.float32, dev)
            pad = torch.zeros((1,), dtype=torch.int32, device=dev)
            _, logits, kv = talker_lib.prefill(p["talker"], cfg.talker,
                                               torch.from_numpy(embeds).to(dev), pad, kv)
            hs = [logits]
            for i in range(len(xs)):
                pos = torch.full((1,), 12 + i, dtype=torch.int32, device=dev)
                h, kv = talker_lib.decode_step(p["talker"], cfg.talker,
                                               torch.from_numpy(xs[i]).to(dev), pos, pad,
                                               kv, use_flash=True)
                hs.append(h.reshape(1, -1))
            wav = codec_lib.decode(p["codec"], cfg.codec, torch.from_numpy(codes).to(dev))
            return [t.cpu() for t in hs], wav.cpu()

        before = flash_decode.launches
        hs_gpu, wav_gpu = run("cuda")
        if flash_decode.launches - before != len(xs) * cfg.talker.num_hidden_layers:
            raise AssertionError("parity decode did not run the kernel")
        hs_cpu, wav_cpu = run("cpu")
        err_h = max((a - b).abs().max().item() for a, b in zip(hs_gpu, hs_cpu))
        err_w = (wav_gpu - wav_cpu).abs().max().item()
        log(f"parity (float32, TF32 off): talker max_abs_err={err_h:.3e}, "
            f"codec max_abs_err={err_w:.3e} (tol {F32_ATOL})  [{card}]")
        if err_h > F32_ATOL or err_w > F32_ATOL:
            raise AssertionError("card and CPU disagree on the small model")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def parity_int8_phase(card: str):
    """Small float32 model with an int8 bundle, card (kernels) vs CPU (plain):
    talker prefill + decode steps over an int8 KV cache with the fused
    kernels, and predictor micro-steps through the fused kernels."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import predictor as predictor_lib
    from qwen3tts_tpu_torch.models import talker as talker_lib
    from qwen3tts_tpu_torch.models.layers import (decode_mask, init_kv_cache, prefill_mask,
                                                  stack_forward)
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        talker = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20))
        cfg = dataclasses.replace(base, talker=talker)
        params = quantize_bundle(init_random(cfg, seed=4, dtype=torch.float32, device="cpu"),
                                 "int8")
        pcfg, pspec = cfg.predictor, predictor_lib.block_spec(cfg.predictor)
        rng = np.random.default_rng(1)
        H, Hp = cfg.talker.hidden_size, pcfg.hidden_size
        embeds = rng.standard_normal((1, 12, H)).astype(np.float32) * 0.1
        xs = rng.standard_normal((16, 1, 1, H)).astype(np.float32) * 0.1
        pin = rng.standard_normal((1, 2, Hp)).astype(np.float32) * 0.5
        pxs = rng.standard_normal((6, 1, 1, Hp)).astype(np.float32) * 0.5

        def run(device):
            dev = torch.device(device)
            move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) \
                else [move(v) for v in t] if isinstance(t, list) else t.to(dev)
            p = move(params)
            kv = talker_lib.new_kv_cache(cfg.talker, 1, 64, torch.float32, dev, kv_quant=True)
            pad = torch.zeros((1,), dtype=torch.int32, device=dev)
            _, logits, kv = talker_lib.prefill(p["talker"], cfg.talker,
                                               torch.from_numpy(embeds).to(dev), pad, kv)
            outs = [logits]
            for i in range(len(xs)):
                pos = torch.full((1,), 12 + i, dtype=torch.int32, device=dev)
                h, kv = talker_lib.decode_step(p["talker"], cfg.talker,
                                               torch.from_numpy(xs[i]).to(dev), pos, pad,
                                               kv, use_flash=True, fused=True)
                outs.append(h.reshape(1, -1))
            # predictor: 2-token prefill (unfused), then fused micro-steps
            blocks = p["predictor"]["blocks"]
            pkv = init_kv_cache(pspec, 1, pcfg.max_seq, torch.float32, dev)
            zero = torch.zeros((1,), dtype=torch.int32, device=dev)
            cos, sin = predictor_lib._rope(pcfg, torch.arange(2, device=dev)[None])
            h, pkv = stack_forward(blocks, torch.from_numpy(pin).to(dev), cos, sin, pkv, 0,
                                   prefill_mask(2, 2, zero), pspec)
            outs.append(h.reshape(1, -1))
            for i in range(len(pxs)):
                cos, sin = predictor_lib._rope(pcfg, torch.full((1, 1), 2 + i, device=dev))
                h, pkv = stack_forward(blocks, torch.from_numpy(pxs[i]).to(dev), cos, sin,
                                       pkv, 2 + i, decode_mask(pcfg.max_seq, 2 + i, zero),
                                       pspec, fused=True)
                outs.append(h.reshape(1, -1))
            return [t.cpu() for t in outs]

        before = (fb.fused_norm_matmul.launches, fb.fused_o_mlp.launches,
                  flash_decode.launches_int8kv)
        gpu = run("cuda")
        L, Lp = cfg.talker.num_hidden_layers, pcfg.num_hidden_layers
        fused_calls = len(xs) * L + len(pxs) * Lp
        if (fb.fused_norm_matmul.launches - before[0], fb.fused_o_mlp.launches - before[1],
                flash_decode.launches_int8kv - before[2]) != (fused_calls, fused_calls,
                                                               len(xs) * L):
            raise AssertionError("int8 parity did not run the kernels")
        cpu = run("cpu")
        err = max((a - b).abs().max().item() for a, b in zip(gpu, cpu))
        log(f"parity int8 + kv_quant + fused (float32, TF32 off): talker and predictor "
            f"max_abs_err={err:.3e} (tol {F32_ATOL})  [{card}]")
        if not err <= F32_ATOL:
            raise AssertionError("card and CPU disagree on the int8 small model")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the card")
    import qwen3tts_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = probe()
    log("== kernel ==")
    max_err, times = kernel_phase(card)
    q_err, q_times = int8kv_kernel_phase(card)
    f_err, f_times = fused_kernel_phase(card)
    log("== slice ==")
    launches, results = slice_phase(card)
    log("== slice-int8 ==")
    q_launches, q_results = slice_int8_phase(card)
    log("== parity ==")
    parity_phase(card)
    parity_int8_phase(card)
    log("slice: " + json.dumps({"card": card, "requests": results,
                                "kernel_max_abs_err": max_err,
                                "kernel_ms_pos2000": times[2000][0],
                                "plain_ms_pos2000": times[2000][1]}))
    log("slice-int8: " + json.dumps({
        "card": card, "requests": q_results, "launches": q_launches,
        "int8kv_max_abs_err": q_err,
        "int8kv_ms_pos2000": q_times[2000][0], "int8kv_plain_ms_pos2000": q_times[2000][1],
        "fused_max_abs_err": f_err,
        "fused_ms": {" ".join(k): v for k, v in f_times.items()}}))
    fd_src, fb_src = ("qwen3tts_tpu_torch/csrc/flash_decode.cu",
                      "qwen3tts_tpu_torch/csrc/fused_block.cu")
    # the fused kernels' times: the talker's shapes with int8 weights, as the
    # int8 path runs them
    print(json.dumps({"kernels": [
        {"name": "flash_decode", "route": "cuda", "source": fd_src,
         "replaces": "qwen3tts_tpu/ops/flash_decode.py:180", "launches": launches,
         "max_abs_err": max_err["bf16"], "ms": times[300][0], "plain_ms": times[300][1]},
        {"name": "flash_decode_int8kv", "route": "cuda", "source": fd_src,
         "replaces": "qwen3tts_tpu/ops/flash_decode.py:180",
         "launches": q_launches["flash_decode_int8kv"], "max_abs_err": q_err["bf16"],
         "ms": q_times[300][0], "plain_ms": q_times[300][1]},
        *({"name": name, "route": "cuda", "source": fb_src,
           "replaces": f"qwen3tts_tpu/ops/fused_block.py:{line}",
           "launches": q_launches[name], "max_abs_err": f_err[name],
           "ms": f_times[(name, "talker", "int8")][0],
           "plain_ms": f_times[(name, "talker", "int8")][1]}
          for name, line in (("fused_norm_matmul", 95), ("fused_o_mlp", 187))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
