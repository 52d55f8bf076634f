#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qwen3tts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. probe  — the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions.  Without a CUDA device the script stops before printing
   anything.
2. kernel — builds csrc/flash_decode.cu with nvcc for sm_90a and holds the
   kernel against flash_decode_plain at the 0.6B talker's shapes (L=28,
   B=1, S=2048, KVH=8, NH=16, D=128) over (layer, pos, pad, window) cases,
   in bf16 (the main path's dtype) and in float32 (where a slot counted at
   the wrong edge of the live range shows above the tolerance), then times
   kernel and plain version (CUDA graph of 28 calls, CUDA events).
3. slice  — FasterQwen3TTS("random:qwen3-tts-0.6b", bf16) on the card
   answers three requests through the public API (non-streaming, then two
   streaming at chunk 8), 48 steps each; checks audio length, range,
   chunk count, and that the main path launched the kernel 28 times a step.
4. parity — a small float32 model: talker prefill + decode steps and the
   codec decode on the card (kernel, TF32 off) against the same on the CPU
   (plain versions).

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
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    nv = subprocess.run([fd._nvcc(), "--version"], capture_output=True, text=True)
    log(f"nvcc: {nv.stdout.strip().splitlines()[-1]}")
    return card


def kernel_phase(card: str):
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, B, S, KVH, NH, D = 28, 1, 2048, 8, 16, 128
    t0 = time.time()
    fd.load_library()
    log(f"kernel build+load: {time.time() - t0:.1f}s")
    for line in fd.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the card")
    import qwen3tts_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = probe()
    log("== kernel ==")
    max_err, times = kernel_phase(card)
    log("== slice ==")
    launches, results = slice_phase(card)
    log("== parity ==")
    parity_phase(card)
    log("slice: " + json.dumps({"card": card, "requests": results,
                                "kernel_max_abs_err": max_err,
                                "kernel_ms_pos2000": times[2000][0],
                                "plain_ms_pos2000": times[2000][1]}))
    print(json.dumps({"kernels": [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "qwen3tts_tpu_torch/csrc/flash_decode.cu",
        "replaces": "qwen3tts_tpu/ops/flash_decode.py:180",
        "launches": launches,
        "max_abs_err": max_err["bf16"],
        "ms": times[300][0],
        "plain_ms": times[300][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
