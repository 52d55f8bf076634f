#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qwen3tts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. probe  — the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions, and whether torch has CUDAGraph.begin_capture_to_if_node
   (the captured chunks' conditional nodes come from csrc/graph_cond.cu
   either way).  Without a CUDA device the script stops before printing
   anything.
2. kernel — builds every csrc/*.cu with nvcc for sm_90a (one nvcc each, all
   at once) and holds each kernel against its plain version:
   flash-decode at the 0.6B talker's shapes (L=28, B=1, S=2048, KVH=8,
   NH=16, D=128) over (layer, pos, pad, window) cases, with a float cache
   and with an int8 cache + scales, then at B 4 and B 16 with a left pad
   per row (one past pos: exact zeros; at B 4 empty splits), one captured
   graph per B replayed after pos and the pads were rewritten;
   fused_norm_matmul and fused_o_mlp at
   the 0.6B talker's and predictor's shapes, with bf16 and int8 weights
   (both at 1, 2 and 32 rows, two runs bit-equal, one captured graph each
   replayed after its inputs were rewritten);
   the same two at the 1.7B talker's shapes (H 2048, qkv N 4096, I 6144)
   at one row;
   fused_micro_step at the 0.6B predictor's shapes, then with the 1.7B's
   2048-wide input projection, over a frame's 14 chained micro-steps, the
   cache slot by slot, two runs bit-equal, one captured graph replayed
   after x, pos, the rope rows and the cache were rewritten;
   matvec and matvec_kt at the probe's default (K 1024, N 65536) and the
   talker's qkv shape (1024 x 4096), then the probe's 20-call run;
   quantize_act and w8a8_gemv (csrc/w8a8.cu) at the 0.6B talker's four
   product shapes, the predictor's qkv and o and the 1.7B talker's qkv, 1,
   2, 4 and 16 rows, bf16 and float32, bit-equal to their plain versions
   (tolerance 0), two runs equal, the route above 16 rows (torch._int_mm)
   at 17 and 64 rows also exact, one captured graph per shape replayed
   after its input was rewritten; timed beside their bounds, the bf16
   torch.matmul of the same shape and torch._int_mm at 17 rows.
   bf16 (the main path's dtype) is held to 2e-3 + 1.6e-2*|ref|, float32 to
   1e-5 (where a slot or a row counted wrong shows above the tolerance).
   The split-K kernels (flash-decode, matvec) give the same bits in two
   runs, and one captured flash-decode graph replays right at (pos, pad)
   written to device memory after capture.  Then times kernel, plain
   version and, where one PyTorch call computes the same function, that
   call (CUDA graphs, CUDA events): SDPA for flash-decode (at pos 300 with
   one cache stack, warm in L2, and over two stacks, cold), torch.matmul
   for the matvecs; the micro-step also beside the per-layer paths and its
   grid barriers alone.
3. slice  — FasterQwen3TTS("random:qwen3-tts-0.6b", bf16) on the card,
   its engine rebuilt with use_cuda_graphs=False (eager chunks), answers
   three requests through the public API (non-streaming, then two
   streaming at chunk 8), 48 steps each; checks audio length, range,
   chunk count, and that the wrapper launched the kernel 28 times a step.
4. slice-int8 — the same model with quantize="int8", kv_quant=True and the
   engine rebuilt with use_fused_kernels=True (eager) answers a non-streaming and a
   streaming (chunk 8) request, 48 steps each; checks the audio and that
   every step launched fused_norm_matmul and fused_o_mlp 98 times each
   (28 talker layers + 5 predictor layers x 14 micro-steps) and the
   int8-KV flash-decode kernel 28 times.
5. slice-micro — the bf16 model's predictor runs 48 sampled frames through
   predict_frame(micro_kernel=True); checks tokens and embed_sum and that
   the kernel launched exactly 14 times a frame; host-wall ms/frame beside
   the default path and fused=True.
6. parity — a small float32 model: talker prefill + decode steps and the
   codec decode on the card (kernels, TF32 off) against the same on the
   CPU (plain versions); then the same talker with int8 weights, an int8
   KV cache and the fused kernels (free-running and step by step from the
   CPU's cache: held to 1e-4 wherever the int8 cache equals the CPU's, to
   2e-3 after an int8 entry flipped by one, at most 2 flips in all), and
   predictor micro-steps through the fused kernels; then greedy
   predict_frame(micro_kernel=True) frames; then, on the float32 and the
   int8 model, captured chunks against eager ones: equal greedy tokens,
   step for step (the first differing step fails the run); then a greedy
   B 3 batch with left pads (6, 10 and 8 tokens) and a join_row into it,
   captured on the card against eager on the CPU: equal tokens; then the
   float32 model with a w8a8 bundle, captured on the card (the w8a8
   kernels) against eager on the CPU: equal greedy frames through every
   step before the first activation whose int8 rounding differs (found by
   recording every quantize_act on both), that rounding off by one.
7. slice-graph — the main path: the API's captured chunks (CUDA graphs,
   runtime/graphs.py) on the 0.6B at full width, on three paths (bf16; bf16
   with use_micro_kernel=True; int8 weights + int8 KV cache +
   use_fused_kernels=True), each eager and captured: warm-up seconds
   (capture), a non-streamed (chunk 16) and a streamed (chunk 8) request
   (96 steps captured, 32 eager): ms/step, RTF, TTFA, prefill ms, graph
   replays; a streamed request whose launches are counted
   (``_held_request``: on the captured paths it captures its own chunks,
   and each replay's launches are read from its graph's kernel nodes, those
   of the steps its ``n`` says ran) and must be flash-decode 28 a step,
   fused_norm_matmul and fused_o_mlp 98 each, fused_micro_step 14; on the
   captured paths the request again, replaying only, and the device's busy
   share (CUDA events around the replays).  Then on bf16: greedy
   captured vs eager tokens (printed), three sampled requests by seed
   (a, a repeat; b differs; fails otherwise), the streamed loop's
   pipeline_depth 1-3, a request that ends in the cache's capped last
   chunk (one replay, then 28 flash-decode launches a step from the eager
   chunk, counted by the wrapper), warmup_all's seconds, and a request
   ended by an EOS at chunks 16 and 8: the steps its chunks ran (their
   ``n``) must equal its frames, and the card's work after the return.
8. slice-icl — ICL voice clone (xvec_only=False) through the API on the
   bf16 0.6B: a 3 s reference and its transcript; the voice prompt's first
   and cached cost, then encode, codec priming, prompt build and prefill
   alone (TTFA's parts); non-streamed and streamed (chunk 8) requests of
   48 steps (audio length and range checked, the reference cut off), the
   streamed one again uncached, and one streamed request on the int8 +
   kv_quant + fused model; the wait between long-form segments
   (generate_longform_streaming, three groups, chunk 8) ended by the budget
   and by an EOS.  Then a small float32 model, TF32 off, card vs CPU: the
   codec encoder's codes equal but for at most one frame with a near tie,
   and the captured streamed ICL request (greedy, codec primed) gives the
   CPU's frames and audio within 1e-4.
9. slice-batch — batched generation on the 0.6B: the bf16 and the int8 +
   kv_quant + fused paths at B 4 and B 16 (warm-up, a 96-step request over
   rows of different prompt lengths: ms/step, frames/s, throughput RTF; a
   16-step request: launches counted as above, flash-decode 28 a step and
   the fused kernels 98 calls each, fused_o_mlp a launch per 4 rows, and
   the busy share); a B 4 batch in which an
   EOS ends one row early (the other rows' frames unchanged, the chunks
   stop with the longest row); join_row into a running B 4 batch;
   chunk_vocode_batched at chunk 8; generate_voice_clone_batch through the
   API with four texts.  (The kernel phase holds flash-decode at B 4 and 16
   with a pad per row, the parity phase a float32 B 3 batch with a join_row
   card vs CPU.)
10. slice-serve — the OpenAI-compatible server (apps/openai_server.py) in
   the process on the bf16 0.6B, a 4-row continuous batcher at chunk 8
   (ramp 2, 4), a voice from the phase's reference wav: the batcher's
   warm-up (seconds, captures); the voice's first request, three
   light-load requests one after another and 8 concurrent streamed wav requests (urllib) of mixed texts
   and budgets, sampled as served: each 200 with whole codec frames of
   finite audio, TTFA (ms to the first audio byte); served = sent, at least
   one mid-batch join; an mp3 request (or its 501; the probe prints whether
   libmp3lame / libmpg123 load); a client that disconnects while a fifth
   request queues: the row is cancelled and the fifth takes it before the
   long requests end; no capture after the warm-up.  Then a greedy batcher
   (EOS suppressed) serving 8 requests of 96 steps, once untimed, then at
   pipeline depths 1, 3, 3, 1: served frames/s, throughput RTF, TTFA, the launches each
   replay's graph holds over the steps its ``n`` says ran (flash-decode 28
   a step, read by the graph walk), the busy share, no capture after its
   warm-up; raw fast_generate_batch at B 4 (chunk 8 and 16) beside it; one
   request through a server on the int8 + kv_quant model (int8
   flash-decode).  Then a small float32 model, TF32 off: a greedy 2-row
   batcher on the card with a mid-batch join against the batch-1 streamed
   requests on the CPU, audio within 1e-4.
11. slice-voices — parity_mode=True (24 steps, streamed chunk 8) beside the
   fast path on the 0.6B; then, each loaded after the last is freed,
   random:qwen3-tts-0.6b-custom (a named speaker) and
   random:qwen3-tts-1.7b-design (instruct): load and warm-up seconds,
   non-streamed and streamed 48-step requests (ms/step, RTF, TTFA), and a
   counted streamed request (flash-decode 28 a step); the 1.7B again with
   use_micro_kernel=True, a counted 48-step request (flash-decode 28 and the
   micro-step 14 a step).
12. slice-checkpoint — checkpoints and the command line on the bf16 0.6B
   (random:qwen3-tts-0.6b, seed 0, loaded anew), in a temporary directory:
   save_pretrained, then from_pretrained of the directory with no device
   (the card): every leaf equal, seconds and bytes of each; the upstream
   torch layout in three shards (export_torch_checkpoint), the CLI's
   check-checkpoint (exit 0) and from_pretrained of it (leaves equal); the
   CLI's ``clone --model <dir>`` non-streamed and streamed at chunk 8 (48
   steps, seed 0): whole codec frames, the same samples as the source
   model's API call with the same seed and arguments, the CLI's printed RTF
   and TTFA; the loaded model's counted request (flash-decode 28 a step);
   the CLI's export-fixture (24 steps) and check-fixture (exit 0; exit 1 on
   a copy with one token changed); and a request traced with
   QWEN3TTS_PROFILE_DIR on the captured engine (it runs eagerly: no replay
   while the profiler is active) followed by untraced captured requests,
   whose greedy tokens equal the eager engine's.
13. slice-w8a8 — random:qwen3-tts-0.6b (bf16) with quantize="w8a8" through
   the API with captured chunks: warm-up, a non-streamed and a streamed
   (chunk 8) request of 48 steps (ms/step, RTF, TTFA) and a counted
   streamed request (flash-decode 28, quantize_act 412, w8a8_gemv 412
   kernel nodes a step, and the eager prefill's); a B 4 fast_generate_batch
   of 48 steps (the same counts a step); one request each with
   "w8a8-talker" and "w8a8-predictor"; then utils/quality.py's
   quant_quality(bf16, w8a8) and quant_quality(bf16, int8) at 24 steps
   (teacher-forced logit MSE and argmax-flip rates, talker and predictor
   apart; the vocoder's SNR on identical codes must be 99.0).
14. slice-demo — the web demo (apps/demo_server.py) in the process on a
   free port, its /transcribe on the builtin CTC recognizer (the committed
   samples/asr/ctc_selftrained) on the card: /status names cuda:0; /load of
   random:qwen3-tts-0.6b (bf16); streamed clone requests (preset_low, chunk
   8, ramp 2, 4, 96 frames at most, sampled as the page sends them), one
   that captures its chunks and three warm ones: the server's ttfa_ms, the
   client's ms to the first chunk event, rtf, total_audio_s and the event
   count, the events chunk ... done, every chunk whole codec frames of
   finite audio; a counted request (the demo model's engine recording:
   flash-decode 28 a step, read from each replay's graph, capturing then
   replaying); a non-streamed /generate; MODEL_CACHE_SIZE 2, /load
   random:tiny then random:qwen3-tts-0.6b-custom, which evicts the 0.6B: the
   release under the generation lock must give back at least 90 % of the
   0.6B's parameter bytes (torch.cuda.memory_allocated before and after),
   then a streamed request on the custom model; the 16 committed clips
   through /transcribe: mean CER within 0.08 of metrics.json's
   eval_cer_heldout_perturbation and below 0.7, every transcript equal to
   the port's recognizer on the CPU, the logits' card-vs-CPU max abs error
   with cuDNN's TF32 as it is and off, the warm ms a transcription.
15. slice-shard — tensor-parallel serving (parallel/sharding.py) on the
   0.6B (``slice_shard_phase``): two gloo ranks on the one card (eager):
   the float32 flagship check with the int8 cache, 4 greedy steps,
   token-exact with the unsharded run, flash-decode's int8 instance 28 a
   step on each rank, ms/step sharded and whole and the collectives a step;
   the bf16 structural check (logit deltas within the JAX check's
   thresholds); the tiny batched serving check with a join; then one NCCL
   rank, the bf16 flagship with captured chunks equal to the eager sharded
   run and the unsharded one; TP 2 and TP 4 over NCCL, captured, only
   where the machine has that many cards (else a line says so).  The
   kernel phase holds flash-decode at one rank's heads (8 over 4, 4 over 2;
   ``rank_flash_phase``, beside SDPA with ``enable_gqa`` at the same heads)
   and times ``set_condition`` (``set_condition_phase``).
16. slice-train — the training half (``slice_train_phase``): the ASR
   self-training tool (below), then the talker train step (``parallel/sharding.py:make_train_step``) on the 0.6B at full width,
   float32 with TF32 off, B 2 x T 64, left pads (0, 5), lr 1e-4, 3 steps,
   unsharded in the process, then TP 2 over gloo on the one card, then dp 2
   x tp 2 over NCCL where the machine has four cards (else a line says it
   did not run): the losses finite and falling, a TP run's within 1e-4
   relative of the unsharded run's, the replicated leaves bit-equal across
   ranks after each step, the forward and backward collectives a step as
   the formula gives them; ms a step, peak memory a rank; the unsharded
   step's forward and backward alone, traced eagerly by torch.profiler
   (device ms, kernels), and its AdamW update alone.  The ASR
   self-training tool (``tools/train_asr.py``'s ``main``, synthesis by the
   0.6B, 96 channels x 3 layers, 8 texts, 4 epochs) into a temporary
   directory: the epoch losses falling, its checkpoint loaded on the card,
   whose logits on the 16 committed clips agree with the CPU's within 0.1
   (cuDNN's TF32) and 1e-3 (TF32 off); seconds of synthesis,
   featurisation and an epoch.
17. examples — the port's x-vector examples as a user runs them, each in a
   fresh process (``python3 examples/torch_*.py``, the checkout on
   PYTHONPATH, random:qwen3-tts-0.6b, bf16, the card by default):
   torch_extract_speaker.py on the phase's reference wav writes one finite
   float32 vector of the preset's speaker width; torch_generate_with_embedding.py
   reads it (prompt builder, captured chunks, ``loops.fast_generate``, 48
   new tokens at most) and writes a wav of exactly the printed steps x
   samples per frame of finite audio; each process's seconds and the
   example's ms/step.

No phase runs torch.profiler around a captured replay: its tracing of CUDA
graphs with conditional nodes lost kernel records, and a replay after such
traces faulted on the H100 (``tools/graph_trace_probe.py``); the one traced
request (slice-checkpoint) runs its chunks eagerly.  Prints each phase's seconds, the
kernels' JSON line before the last line, and as the last line
``{"ok": true, "device": {...}}``.  The kernels' ``launches`` are those of
the main path's counted captured requests (slice-graph, the run that
captures its chunks: the wrappers' eager launches, one step a capture,
plus each replay's kernel nodes); the matvecs' are the probe's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
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
FLIP_ATOL = 2e-3  # int8 parity: an output that attends to an int8 cache entry flipped by one
MAX_FLIPS = 2  # int8 parity: entries the decode steps may flip (one on the H100)
# the bf16 micro-step: each phase rounds its activations to bf16, and the
# roundings that float32 summation order flips carry through the layers, so
# the plain version against itself in another summation order already misses
# BF16_TOL (micro_kernel_phase measures that spread in every run): twice the
# largest spread measured, 1.95e-2
MICRO_BF16_TOL = (4e-2, 1.6e-2)
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
    has_if = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    log(f"torch.cuda.CUDAGraph.begin_capture_to_if_node: {has_if}; the captured chunks' "
        "conditional nodes are built by the repo's own helper (csrc/graph_cond.cu, "
        "runtime/graphs.py:_IfNodes)")
    from qwen3tts_tpu_torch.audio import mp3

    log(f"libmp3lame loads: {mp3.is_available()}; libmpg123 loads: {mp3.decode_available()}")
    for name in ("safetensors", "tokenizers", "ml_dtypes"):  # for the record: the port needs none
        try:
            __import__(name)
            log(f"{name} imports: True")
        except ImportError:
            log(f"{name} imports: False")
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


# (pos, pad) written to device memory between replays of one captured graph
REPLAY_POSITIONS = [(0, 0), (15, 0), (16, 0), (17, 0), (300, 0), (1024, 1000), (2047, 0),
                    (40, 100), (2000, 0)]


def _flash_split_checks(name: str, q, k, v, scales, cases, tol):
    """The split-K flash-decode kernel: two runs of every case give the same
    bits, and a CUDA graph captured once replays right after pos and pad
    change in device memory (each split finds its slice on the device)."""
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = q.device
    for layer, pos, pad, window in cases:
        args = (q, k, v, layer, torch.tensor([pos], dtype=torch.int32, device=dev),
                torch.tensor([pad], dtype=torch.int32, device=dev), window, *scales)
        if not torch.equal(fd.flash_decode(*args), fd.flash_decode(*args)):
            raise AssertionError(f"{name}: two runs differ at {layer, pos, pad, window}")
    p = torch.zeros((1,), dtype=torch.int32, device=dev)
    pd = torch.zeros((1,), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fd.flash_decode(q, k, v, 27, p, pd, None, *scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(q, k, v, 27, p, pd, None, *scales)
    err = 0.0
    for pos, pad in REPLAY_POSITIONS:
        p.fill_(pos)
        pd.fill_(pad)
        graph.replay()
        err = max(err, _held(f"{name} graph replay", out,
                             fd.flash_decode_plain(q, k, v, 27, p, pd, None, *scales), tol,
                             f"layer=27 pos={pos} pad={pad}"))
        if pad > pos and out.abs().max().item() != 0.0:
            raise AssertionError("pad > pos must give exact zeros (graph replay)")
    log(f"  {name}: {len(cases)} cases bit-equal over two runs; one captured graph replayed "
        f"at {len(REPLAY_POSITIONS)} (pos, pad) written after capture, max_abs_err={err:.3e}")


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
    splits = fd.num_splits(S, B, KVH, cuda_build.sm_count(dev))
    log(f"  flash-decode grid: {KVH} kv heads x {B} row x {splits} splits = "
        f"{KVH * B * splits} CTAs")
    for name, (qq, kk, vv), tol in (("bf16", (q, k, v), BF16_TOL),
                                   ("f32", (q32, k32, v32), F32_TOL)):
        _flash_split_checks(f"flash-decode {name}", qq, kk, vv, (), cases, tol)
    del k32, v32

    # timing: one call per layer, as a decode step makes them, each call
    # reading a different layer's slice of the cache.  "warm": one cache
    # stack, whose live KV at pos 300 (34 MB) stays in the 50 MB L2 across
    # replays; "cold": calls cycle over two stacks (69 MB at pos 300), as a
    # decode step's weights evict the cache between layers.  At pos 2000 one
    # stack's live KV is 230 MB: cold either way.
    import torch.nn.functional as F

    k2, v2 = (torch.randn((L, B, S, KVH, D), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    stacks = ((k, v), (k2, v2))
    qs = q[:, :, None, :]

    def sdpa(kk, vv, layer, live):
        # the library yardstick: SDPA with GQA over the live slice of a
        # layer, [B, NH, 1, D] against [B, KVH, live, D] views of the cache
        return F.scaled_dot_product_attention(qs, kk[layer, :, :live].transpose(1, 2),
                                              vv[layer, :, :live].transpose(1, 2),
                                              enable_gqa=True)[:, :, 0]

    times = {}
    extra = {"bound": {}, "library_ms": {}}
    zero = ints(0)
    for key, pos, n in ((300, 300, 1), (2000, 2000, 1), ("cold300", 300, 2)):
        p, live = ints(pos), pos + 1

        def on(i):  # call i: layer i % L of stack i // L
            return stacks[i // L][0], stacks[i // L][1], i % L

        if n == 1:
            # a layout check only (SDPA rounds the probabilities to bf16)
            _held("sdpa (yardstick)", sdpa(k, v, 0, live),
                  fd.flash_decode_plain(q, k, v, 0, p, zero), (2e-2, 5e-2), f"pos={pos}")
        t_k = graph_ms(lambda i: fd.flash_decode(q, *on(i), p, zero), n * L)
        t_p = graph_ms(lambda i: fd.flash_decode_plain(q, *on(i), p, zero), n * L)
        t_l = graph_ms(lambda i: sdpa(*on(i), live), n * L)
        times[key] = (t_k, t_p)
        extra["library_ms"][key] = t_l
        extra["bound"][key] = bound(nbytes(q, q) + 2 * live * KVH * D * k.element_size(),
                                    4 * NH * live * D, q.dtype)
        gbs = live * KVH * D * 2 * 2 / (t_k * 1e-3) / 1e9
        log(f"  timing pos={pos} {'cold (2 stacks)' if n == 2 else 'one stack'}: kernel "
            f"{t_k * 1e3:.2f} us/call ({gbs:.1f} GB/s of live KV), plain {t_p * 1e3:.2f} "
            f"us/call, F.scaled_dot_product_attention(enable_gqa) {t_l * 1e3:.2f} us/call; "
            f"bound {extra['bound'][key][0] * 1e3:.2f} us  [{card}]")
    del k2, v2, stacks
    return max_err, times, extra


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
    for name, qq, tol in (("bf16", q32.bfloat16(), BF16_TOL), ("f32", q32, F32_TOL)):
        _flash_split_checks(f"int8kv {name}", qq, kq, vq, (ks, vs), cases, tol)

    # timing as kernel_phase: one stack (warm at pos 300: 17 MB of live KV
    # and scales) and two stacks (cold: a second int8 cache and its scales)
    kq2, ks2 = _quantize_rows(torch.randn((L, B, S, KVH, D), generator=g, device=dev))
    vq2, vs2 = _quantize_rows(torch.randn((L, B, S, KVH, D), generator=g, device=dev))
    stacks = ((kq, vq, ks, vs),
              (kq2, vq2, *(t.transpose(-1, -2).contiguous() for t in (ks2, vs2))))
    del ks2, vs2
    times = {}
    q, zero = q32.bfloat16(), ints(0)
    for key, pos, n in ((300, 300, 1), (2000, 2000, 1), ("cold300", 300, 2)):
        p = ints(pos)

        def call(fn, i):  # call i: layer i % L of stack i // L
            kk, vv, kks, vvs = stacks[i // L]
            return fn(q, kk, vv, i % L, p, zero, None, kks, vvs)

        t_k = graph_ms(lambda i: call(fd.flash_decode, i), n * L)
        t_p = graph_ms(lambda i: call(fd.flash_decode_plain, i), n * L)
        times[key] = (t_k, t_p)
        gbs = (pos + 1) * KVH * (D + 4) * 2 / (t_k * 1e-3) / 1e9
        log(f"  int8kv timing pos={pos} {'cold (2 stacks)' if n == 2 else 'one stack'}: "
            f"kernel {t_k * 1e3:.2f} us/call ({gbs:.1f} GB/s of live KV + scales), plain "
            f"{t_p * 1e3:.2f} us/call  [{card}]")
    del stacks, kq2, vq2
    bounds = {pos: bound(nbytes(q, q) + 2 * (pos + 1) * KVH * (D * kq.element_size()
                                                          + ks.element_size()),
                         4 * NH * (pos + 1) * D, torch.int8) for pos in (300, 2000)}
    bounds["cold300"] = bounds[300]
    log("  int8kv bound: " + ", ".join(f"pos={pos} {bounds[pos][0] * 1e3:.2f} us"
                                       for pos in (300, 2000)))
    return max_err, times, bounds


# (pos, a pad per row, window) at B 4 and 16 (the pads repeat over the rows):
# a row whose pad is past pos gives exact zeros; at pos 40 the live ranges
# are one or two splits of 32 slots, so the other splits of those rows are
# empty
BATCH_FLASH_CASES = [(40, (0, 39, 41, 5), None), (300, (0, 17, 250, 301), None),
                     (1500, (3, 0, 1200, 1600), 300), (2047, (0, 1, 2040, 2047), None)]


def batch_kernel_phase(card: str) -> dict:
    """Flash-decode with several rows, each with its own left pad (grid
    (KVH, B, splits)): B 4 and 16 at the 0.6B talker's heads and 2048 slots,
    float and int8 caches, bf16 and float32 q, against the plain version at
    the tolerances above; then per B one captured graph replayed after pos
    and the pads were rewritten in device memory."""
    from qwen3tts_tpu_torch.models.layers import _quantize_rows
    from qwen3tts_tpu_torch.ops import cuda_build
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, S, KVH, NH, D = 2, 2048, 8, 16, 128
    res = {}
    for B in (4, 16):
        g = torch.Generator(device=dev).manual_seed(B)
        k32 = torch.randn((L, B, S, KVH, D), generator=g, device=dev)
        v32 = torch.randn((L, B, S, KVH, D), generator=g, device=dev)
        q32 = torch.randn((B, NH, D), generator=g, device=dev)
        (kq, ks), (vq, vs) = _quantize_rows(k32), _quantize_rows(v32)
        int8 = (kq, vq, ks.transpose(-1, -2).contiguous(), vs.transpose(-1, -2).contiguous())
        caches = {"bf16": (q32.bfloat16(), k32.bfloat16(), v32.bfloat16(), (), BF16_TOL),
                  "f32": (q32, k32, v32, (), F32_TOL),
                  "int8kv bf16": (q32.bfloat16(), *int8[:2], int8[2:], BF16_TOL),
                  "int8kv f32": (q32, *int8[:2], int8[2:], F32_TOL)}
        splits = fd.num_splits(S, B, KVH, cuda_build.sm_count(dev))
        empty = 0
        for name, (q, k, v, scales, tol) in caches.items():
            err = 0.0
            for pos, pads, window in BATCH_FLASH_CASES:
                pad = torch.tensor([pads[b % len(pads)] for b in range(B)], dtype=torch.int32,
                                   device=dev)
                args = (q, k, v, 1, torch.tensor([pos], dtype=torch.int32, device=dev), pad,
                        window, *scales)
                out = fd.flash_decode(*args)
                err = max(err, _held(f"flash-decode B{B} {name}", out,
                                     fd.flash_decode_plain(*args), tol,
                                     f"pos={pos} pads={pads} window={window}"))
                for b in range(B):
                    lo, hi = fd.live_range(pos, int(pad[b]), window, S)
                    if lo > hi and out[b].abs().max().item() != 0.0:
                        raise AssertionError(f"B{B} row {b}: pad past pos must give zeros")
                    empty += sum(fd.split_range(lo, hi, i, splits)[0] >
                                 fd.split_range(lo, hi, i, splits)[1] for i in range(splits))
            res[f"B{B} {name}"] = err
        # one graph, replayed at every case after pos and pads are rewritten
        q, k, v = caches["bf16"][:3]
        p = torch.zeros((1,), dtype=torch.int32, device=dev)
        pd = torch.zeros((B,), dtype=torch.int32, device=dev)
        graph, out = _captured(lambda: fd.flash_decode(q, k, v, 1, p, pd))
        err = 0.0
        for pos, pads, _ in BATCH_FLASH_CASES:
            p.fill_(pos)
            pd.copy_(torch.tensor([pads[b % len(pads)] for b in range(B)], dtype=torch.int32))
            graph.replay()
            err = max(err, _held(f"flash-decode B{B} graph replay", out,
                                 fd.flash_decode_plain(q, k, v, 1, p, pd), BF16_TOL,
                                 f"pos={pos} pads={pads}"))
        res[f"B{B} graph replay"] = err
        log(f"  flash-decode B{B}: grid {KVH} x {B} x {splits} splits, {len(BATCH_FLASH_CASES)} "
            f"cases x 4 caches, {empty} empty splits; max_abs_err "
            f"{json.dumps({k_: v_ for k_, v_ in res.items() if k_.startswith(f'B{B} ')})}")
        if B == 4 and not empty:
            raise AssertionError("no split's range was empty at B 4")
        del k32, v32, kq, vq, ks, vs, int8, caches
        res[f"B{B} timing"] = _batch_flash_timing(card, B)
    return res


def _batch_flash_timing(card: str, B: int) -> dict:
    """Flash-decode at B rows over a 28-layer bf16 cache at pos 300, one call
    per layer as a decode step makes them (CUDA graphs, CUDA events):
    kernel, plain version, SDPA over the live slices, and the bound."""
    import torch.nn.functional as F

    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, S, KVH, NH, D, pos = 28, 2048, 8, 16, 128, 300
    g = torch.Generator(device=dev).manual_seed(7)
    k, v = (torch.randn((L, B, S, KVH, D), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    q = torch.randn((B, NH, D), generator=g, device=dev, dtype=torch.bfloat16)
    p = torch.full((1,), pos, dtype=torch.int32, device=dev)
    pad = torch.zeros((B,), dtype=torch.int32, device=dev)
    qs, live = q[:, :, None, :], pos + 1
    res = {"pos": pos, "rows": B,
           "ms": graph_ms(lambda i: fd.flash_decode(q, k, v, i % L, p, pad), L),
           "plain_ms": graph_ms(lambda i: fd.flash_decode_plain(q, k, v, i % L, p, pad), L),
           "library_ms": graph_ms(lambda i: F.scaled_dot_product_attention(
               qs, k[i % L, :, :live].transpose(1, 2), v[i % L, :, :live].transpose(1, 2),
               enable_gqa=True), L)}
    res["bound_ms"], res["bound_by"] = bound(nbytes(q, q) + 2 * B * live * KVH * D * 2,
                                             4 * B * NH * live * D, q.dtype)
    log(f"  flash-decode B{B} timing at pos {pos}: kernel {res['ms'] * 1e3:.2f} us/call, plain "
        f"{res['plain_ms'] * 1e3:.2f}, SDPA {res['library_ms'] * 1e3:.2f}, bound "
        f"{res['bound_ms'] * 1e3:.2f} ({res['bound_by']})  [{card}]")
    return res


def _captured(fn):
    """A CUDA graph of one call of ``fn()`` (warmed up on a side stream
    first, where a wrapper allocates its workspace) and the call's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def fused_kernel_phase(card: str):
    """fused_norm_matmul and fused_o_mlp against their plain versions at the
    0.6B talker's shapes (H 1024, qkv N 4096, Dq 2048, I 3072), the
    predictor's (qkv N 2048, Dq 1024) and the 1.7B talker's (H 2048, qkv N
    4096, Dq 2048, I 6144): bf16 with bf16 and with int8 weights, float32
    with float32 and with int8 weights, at B = 1, 2 and 32 (the 1.7B talker:
    B = 1), two runs bit-equal at each; for each kernel one captured graph
    replayed after x and attn were rewritten.  Timing (B = 1): one call
    per layer in a CUDA graph, each layer with its own weights, as a step
    makes them (28 talker calls; 70 predictor calls over its 5 layers)."""
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops.quant import quantize_tensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = {"talker": dict(H=1024, Dq=2048, N=4096, I=3072, layers=28, calls=28),
              "predictor": dict(H=1024, Dq=1024, N=2048, I=3072, layers=5, calls=70),
              "talker_1.7b": dict(H=2048, Dq=2048, N=4096, I=6144, layers=28, calls=28,
                                  rows=(1,))}
    max_err = {"fused_norm_matmul": 0.0, "fused_o_mlp": 0.0}
    times, bounds = {}, {}
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
                kernels = {
                    "fused_norm_matmul": (
                        lambda xx, aa: fb.fused_norm_matmul(xx, nw, w0["qkv"]),
                        lambda xx, aa: fb.fused_norm_matmul_plain(xx, nw, w0["qkv"])),
                    "fused_o_mlp": (
                        lambda xx, aa: fb.fused_o_mlp(xx, aa, w0["o"], nw, w0["gu"], w0["d"]),
                        lambda xx, aa: fb.fused_o_mlp_plain(xx, aa, w0["o"], nw, w0["gu"],
                                                            w0["d"]))}
                for B in sh.get("rows", (1, 2, 32)):  # more than 4 rows: 4 at a time
                    xb = x if B == 1 else torch.randn((B, H), generator=g, device=dev).to(dt)
                    ab = attn if B == 1 else torch.randn((B, Dq), generator=g, device=dev).to(dt)
                    for kname, (fn, plain) in kernels.items():
                        outs = [fn(xb, ab) for _ in range(2)]
                        err = _held(kname, outs[0], plain(xb, ab), tol, f"{what} B={B}")
                        if not torch.equal(*outs):
                            raise AssertionError(f"{kname} is not deterministic at {what} B={B}")
                        max_err[kname] = max(max_err[kname], err)
                # one captured graph each, replayed after its inputs were rewritten
                xg, ag = x.clone(), attn.clone()
                for kname, (fn, plain) in kernels.items():
                    graph, og = _captured(lambda: fn(xg, ag))
                    for _ in range(2):
                        xg.copy_(torch.randn((1, H), generator=g, device=dev))
                        ag.copy_(torch.randn((1, Dq), generator=g, device=dev))
                        graph.replay()
                        err = _held(f"{kname} graph replay", og, plain(xg, ag), tol, what)
                        max_err[kname] = max(max_err[kname], err)
                    del graph
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
                    mats = ("qkv",) if kname == "fused_norm_matmul" else ("o", "gu", "d")
                    wbytes = sum(t.numel() * t.element_size() for key in mats
                                 for t in (ws[0][key].values() if quant else [ws[0][key]]))
                    acts = (x, nw, x.new_empty(N)) if kname == "fused_norm_matmul" else (
                        x, attn, nw, x)
                    n_ops = 2 * sum((ws[0][key]["q"] if quant else ws[0][key]).numel()
                                    for key in mats)
                    bounds[(kname, where, wname)] = bound(
                        wbytes + nbytes(*acts), n_ops, torch.int8 if quant else dt)
                    log(f"  timing {kname} {where} x=bf16 w={wname}: kernel "
                        f"{t_k * 1e3:.2f} us/call ({wbytes / (t_k * 1e-3) / 1e9:.0f} GB/s of "
                        f"weights), plain {t_p * 1e3:.2f} us/call, bound "
                        f"{bounds[(kname, where, wname)][0] * 1e3:.2f} us  [{card}]")
                del ws
    return max_err, times, bounds


# H100 SXM peaks (NVIDIA's data sheet, dense): the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def bound(nbytes: float, ops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves ``nbytes`` and does ``ops`` operations on inputs of
    ``dtype``, at the card's peak rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _predictor_weights(dtype, seed: int, preset: str = "qwen3-tts-0.6b"):
    """Random predictor parameters of ``preset`` on the card (all 5 layers;
    the input projection from the talker's width), the norm weights and the
    proj bias moved off 1 / 0."""
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import predictor as predictor_lib

    dev = torch.device("cuda")
    cfg = get_preset(preset)
    g = torch.Generator(device=dev).manual_seed(seed)
    p = predictor_lib.init_params(g, cfg.predictor, cfg.talker.hidden_size, dtype, dev)

    def jitter(t, base):
        return (base + 0.1 * torch.randn(t.shape, generator=g, device=dev)).to(dtype)

    for k in ("input_norm", "post_norm", "q_norm", "k_norm"):
        p["blocks"][k] = jitter(p["blocks"][k], 1.0)
    p["final_norm"] = jitter(p["final_norm"], 1.0)
    p["small_to_mtp"]["b"] = jitter(p["small_to_mtp"]["b"], 0.0)
    return cfg, p


def _permuted(w, g):
    """The micro-step weights with the talker-space, hidden and intermediate
    units permuted: the same function, its sums taken in another order.
    Returns (weights, {"in": x_emb column order, "out": h's order back})."""
    Ht, Hp = w["proj_w"].shape
    I = w["dn"].shape[1]
    dev = w["proj_w"].device
    pt, ph, pi = (torch.randperm(n, generator=g, device=dev) for n in (Ht, Hp, I))
    gu_cols = torch.cat([pi, I + pi])
    return {
        "proj_w": w["proj_w"][pt][:, ph].contiguous(), "proj_b": w["proj_b"][ph].contiguous(),
        "in_norm": w["in_norm"][:, ph].contiguous(),
        "post_norm": w["post_norm"][:, ph].contiguous(),
        "q_norm": w["q_norm"], "k_norm": w["k_norm"],
        "final_norm": w["final_norm"][ph].contiguous(),
        "qkv": w["qkv"][:, ph].contiguous(), "o": w["o"][:, :, ph].contiguous(),
        "gu": w["gu"][:, ph][:, :, gu_cols].contiguous(),
        "dn": w["dn"][:, pi][:, :, ph].contiguous(),
    }, {"in": pt, "out": torch.argsort(ph)}


def micro_kernel_phase(card: str, preset: str = "qwen3-tts-0.6b"):
    """fused_micro_step against its plain version at ``preset``'s predictor
    shapes (the 1.7B's projects its input from 2048 wide, the 0.6B's from
    1024), random weights of all 5 layers: 14 chained micro-steps (pos
    2..15, a frame's), h at every step and the cache slot by slot after.
    Each step's plain version runs on the kernel's cache as it stood before
    the step.  float32 (F32_TOL) also runs the plain chain on its own; bf16
    is held to MICRO_BF16_TOL, beside the plain version's own spread: the
    plain version again with the hidden and intermediate units permuted
    (the same function, summed in another order).  Two kernel chains give
    the same bits.  Timing (bf16): a
    CUDA graph of one 14-step frame, per micro-step, beside the plain
    version and the per-layer paths on the same weights (proj +
    stack_forward + final norm, eager ops and fused=True), and the grid
    barriers alone."""
    from qwen3tts_tpu_torch.models import predictor as predictor_lib
    from qwen3tts_tpu_torch.models.layers import decode_mask, rms_norm, stack_forward, \
        unstack_layers
    from qwen3tts_tpu_torch.ops import predictor_step as ps

    dev = torch.device("cuda")
    max_err, out = {}, {}
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cfg, params = _predictor_weights(dt, seed=10, preset=preset)
        pcfg, Ht = cfg.predictor, cfg.talker.hidden_size
        w = ps.micro_step_weights(params)
        g = torch.Generator(device=dev).manual_seed(11)
        L, S, KVH, D = (pcfg.num_hidden_layers, pcfg.max_seq, pcfg.num_key_value_heads,
                        pcfg.head_dim)
        k0, v0 = (torch.zeros((L, S, KVH, D), device=dev, dtype=dt) for _ in range(2))
        k0[:, :2] = torch.randn((L, 2, KVH, D), generator=g, device=dev).to(dt)
        v0[:, :2] = torch.randn((L, 2, KVH, D), generator=g, device=dev).to(dt)
        steps = pcfg.num_codebooks - 1
        xs = [(0.5 * torch.randn((1, Ht), generator=g, device=dev)).to(dt)
              for _ in range(steps)]
        poss = [torch.full((1,), 2 + i, dtype=torch.int32, device=dev) for i in range(steps)]
        cs = [predictor_lib._rope(pcfg, p.reshape(1, 1)) for p in poss]  # [1, 1, D] each
        ropes = [(c[0, 0], s[0, 0]) for c, s in cs]

        def step(fn, i, kk, vv, ww=w, x=None):
            x = xs[i] if x is None else x
            return fn(ww, x, *ropes[i], kk, vv, poss[i], pcfg.rms_norm_eps)

        # the kernel's chain, each step held against the plain version (and
        # the plain version in another summation order) on the kernel's cache
        tol = MICRO_BF16_TOL if dname == "bf16" else F32_TOL
        wperm, unperm = _permuted(w, g)
        kk, vv = k0.clone(), v0.clone()
        ref_k, ref_v, run0, err, spread = k0.clone(), v0.clone(), [], 0.0, 0.0
        for i in range(steps):
            kp, vp, kq, vq = kk.clone(), vv.clone(), kk.clone(), vv.clone()
            h, kk, vv = step(ps.fused_micro_step, i, kk, vv)
            hp, kp, vp = step(ps.fused_micro_step_plain, i, kp, vp)
            hq = step(ps.fused_micro_step_plain, i, kq, vq, wperm, xs[i][:, unperm["in"]])[0]
            spread = max(spread, (hq[:, unperm["out"]].float() - hp.float()).abs().max().item())
            err = max(err, _held("fused_micro_step", h, hp, tol,
                                 f"x={dname} step {i} pos={2 + i} h"))
            ref_k[:, 2 + i], ref_v[:, 2 + i] = kp[:, 2 + i], vp[:, 2 + i]
            run0.append(h)
        for slot in range(S):
            for name, a, b in (("k", kk, ref_k), ("v", vv, ref_v)):
                e = (a[:, slot].float() - b[:, slot].float()).abs()
                if (e - tol[0] - tol[1] * b[:, slot].float().abs()).max().item() > 0:
                    raise AssertionError(f"fused_micro_step cache {name} slot {slot} "
                                         f"disagrees ({dname}): {e.max().item()}")
                err = max(err, e.max().item())
        if kk[:, 2 + steps:].any() or vv[:, 2 + steps:].any():
            raise AssertionError("fused_micro_step wrote past its slots")
        run0 += [kk, vv]
        kk, vv, run1 = k0.clone(), v0.clone(), []
        for i in range(steps):
            h, kk, vv = step(ps.fused_micro_step, i, kk, vv)
            run1.append(h)
        if not all(torch.equal(a, b) for a, b in zip(run0, run1 + [kk, vv])):
            raise AssertionError(f"fused_micro_step is not deterministic ({dname})")
        # one captured graph of a step, replayed after x, the rope rows, pos
        # and the cache were rewritten: each replay against the plain version
        xg, pg = xs[0].clone(), poss[0].clone()
        cg_, sg_ = ropes[0][0].clone(), ropes[0][1].clone()
        kg, vg = k0.clone(), v0.clone()
        graph, (hg, _, _) = _captured(lambda: ps.fused_micro_step(
            w, xg, cg_, sg_, kg, vg, pg, pcfg.rms_norm_eps))
        kg.copy_(k0)
        vg.copy_(v0)
        for i in (0, 5, steps - 1):
            xg.copy_(xs[i])
            pg.copy_(poss[i])
            cg_.copy_(ropes[i][0])
            sg_.copy_(ropes[i][1])
            kp, vp = kg.clone(), vg.clone()
            graph.replay()
            hp, kp, vp = step(ps.fused_micro_step_plain, i, kp, vp)
            err = max(err, _held("fused_micro_step graph replay", hg, hp, tol,
                                 f"x={dname} step {i} pos={2 + i} h"))
            for name, a, b in (("k", kg, kp), ("v", vg, vp)):
                err = max(err, _held("fused_micro_step graph replay", a[:, 2 + i], b[:, 2 + i],
                                     tol, f"x={dname} cache {name} slot {2 + i}"))
        del graph
        if dname == "f32":
            kp, vp = k0.clone(), v0.clone()
            for i in range(steps):
                hp, kp, vp = step(ps.fused_micro_step_plain, i, kp, vp)
                err = max(err, _held("fused_micro_step", run0[i], hp, tol,
                                     f"x=f32 free-running chain step {i}"))
            for a, b in ((run0[-2], kp), (run0[-1], vp)):
                err = max(err, _held("fused_micro_step", a, b, tol, "x=f32 chain cache"))
        log(f"  fused_micro_step {preset} x={dname}: {steps} chained steps and the cache slot "
            f"by slot within {tol}, two runs bit-equal; max_abs_err={err:.3e}; the plain version "
            f"against itself summed in another order: max_abs {spread:.3e}")
        max_err[dname] = err
        if dname != "bf16":
            del params, w
            continue

        # timing: one frame's 14 micro-steps in a CUDA graph
        kk, vv = k0.clone(), v0.clone()
        spec = predictor_lib.block_spec(pcfg)
        layers = unstack_layers(params["blocks"])
        kv = {"k": k0.clone()[:, None], "v": v0.clone()[:, None]}
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        masks = [decode_mask(S, p, zero) for p in poss]

        def per_layer(i, fused):
            x = predictor_lib._proj(params, xs[i])[:, None]
            y, _ = stack_forward(layers, x, *cs[i], kv, poss[i], masks[i], spec, fused=fused)
            return rms_norm(y, params["final_norm"], pcfg.rms_norm_eps)

        t = {"kernel": graph_ms(lambda i: step(ps.fused_micro_step, i, kk, vv), steps),
             "plain": graph_ms(lambda i: step(ps.fused_micro_step_plain, i, kk, vv), steps),
             "stack_forward": graph_ms(lambda i: per_layer(i, False), steps),
             "stack_forward_fused": graph_ms(lambda i: per_layer(i, True), steps)}
        grid = ps.kernel_grid(dt, D)
        n_sync = 1 + 4 * L
        t["barriers"] = graph_ms(
            lambda i: ps.grid_barriers(grid, n_sync, torch.cuda.current_stream()), steps)
        live = sum(2 + i + 1 for i in range(steps)) / steps  # mean live slots a step
        n_bytes = (nbytes(*w.values(), xs[0], xs[0].new_empty(pcfg.hidden_size))
                   + L * (live + 1) * KVH * D * 2 * k0.element_size())
        n_ops = 2 * sum(w[k].numel() for k in ("proj_w", "qkv", "o", "gu", "dn"))
        b_ms, b_by = bound(n_bytes, n_ops, dt)
        log(f"  timing fused_micro_step {preset} bf16 (CUDA graph of one {steps}-step frame, per "
            f"micro-step): kernel {t['kernel'] * 1e3:.2f} us ({b_ms / t['kernel'] * 100:.1f} % "
            f"of the {b_ms * 1e3:.2f} us bound, {n_bytes / 1e6:.1f} MB), plain "
            f"{t['plain'] * 1e3:.2f} us, stack_forward {t['stack_forward'] * 1e3:.2f} us, "
            f"fused=True {t['stack_forward_fused'] * 1e3:.2f} us; {n_sync} grid barriers "
            f"alone on {grid} CTAs {t['barriers'] * 1e3:.2f} us  [{card}]")
        out = {"times": t, "bound_ms": b_ms, "bound_by": b_by, "grid": grid,
               "barriers": n_sync}
        del params, w, layers, kv
    return max_err, out


def matvec_phase(card: str):
    """matvec and matvec_kt against their plain versions at the probe's
    default shape (K 1024, N 65536) and the talker's qkv shape (1024 x
    4096), bf16 and float32, weights scaled by K^-0.5.  Then the probe's
    run (benchmarks/matvec_probe.py inner_loop: 20 dependent calls) through
    both kernels at both shapes in bf16, counts zeroed before and read
    after.  Timing: a CUDA graph of 20 calls (the stream orders them; at
    4096 each call reads its own weights, so that 20 x 8 MB stream from HBM
    instead of the 50 MB L2), beside torch.matmul of 1 and 8 rows and
    wt @ x (the probe's xla_1row / xla_8row / xla_pre_t)."""
    from qwen3tts_tpu_torch.ops import cuda_build
    from qwen3tts_tpu_torch.ops import matvec as mv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    T = 20
    shapes = {"probe": (1024, 65536), "qkv": (1024, 4096)}
    max_err = {"matvec": 0.0, "matvec_kt": 0.0}
    data = {}
    for where, (K, N) in shapes.items():
        w32 = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        x32 = torch.randn((1, K), generator=g, device=dev)
        for dname, dt, tol in (("bf16", torch.bfloat16, BF16_TOL), ("f32", torch.float32,
                                                                    F32_TOL)):
            w, x = w32.to(dt), x32.to(dt)
            wt = w.t().contiguous()
            what = f"{where} K={K} N={N} x={dname}"
            y = mv.matvec(x, w)
            max_err["matvec"] = max(max_err["matvec"], _held(
                "matvec", y, mv.matvec_plain(x, w), tol, what))
            if not torch.equal(y, mv.matvec(x, w)):
                raise AssertionError(f"matvec: two runs differ at {what}")
            max_err["matvec_kt"] = max(max_err["matvec_kt"], _held(
                "matvec_kt", mv.matvec_kt(x, wt), mv.matvec_kt_plain(x, wt), tol, what))
            if dname == "bf16":
                data[where] = (x, w, wt)
        del w32, x32

    # the probe's run: T dependent calls of each kernel at both shapes
    mv.matvec.launches = mv.matvec_kt.launches = 0  # the main path's run starts here
    for where, (x, w, wt) in data.items():
        K = x.shape[1]
        for fn, weight in ((mv.matvec, w), (mv.matvec_kt, wt)):
            xc = x
            for _ in range(T):
                y = fn(xc, weight)
                xc = xc + y.reshape(1, -1)[:, :K].to(xc.dtype) * 1e-30
            torch.cuda.synchronize()
            if not torch.isfinite(xc).all():
                raise AssertionError(f"{fn.__name__} probe run gave non-finite values")
    launches = {"matvec": mv.matvec.launches, "matvec_kt": mv.matvec_kt.launches}
    if launches != {"matvec": T * len(data), "matvec_kt": T * len(data)}:
        raise AssertionError(f"matvec probe launches {launches}; want {T * len(data)} each")

    times = {}
    for where, (x, w, wt) in data.items():
        K, N = w.shape
        ws = [w] if where == "probe" else [w] + [torch.randn_like(w) for _ in range(T - 1)]
        wts = [wt] if where == "probe" else [m.t().contiguous() for m in ws]
        x8 = torch.randn((8, K), generator=g, device=dev).to(x.dtype)
        xt = x.t().contiguous()
        cases = {"matvec": lambda i: mv.matvec(x, ws[i % len(ws)]),
                 "matvec_plain": lambda i: mv.matvec_plain(x, ws[i % len(ws)]),
                 "matvec_kt": lambda i: mv.matvec_kt(x, wts[i % len(wts)]),
                 "matvec_kt_plain": lambda i: mv.matvec_kt_plain(x, wts[i % len(wts)]),
                 "torch_1row": lambda i: torch.matmul(x, ws[i % len(ws)]),
                 "torch_8row": lambda i: torch.matmul(x8, ws[i % len(ws)]),
                 "torch_pre_t": lambda i: torch.matmul(wts[i % len(wts)], xt)}
        t = {name: graph_ms(fn, T) for name, fn in cases.items()}
        log(f"  matvec grid {where}: {-(-N // mv.matvec_tile(x.dtype))} column tiles x "
            f"{mv.matvec_splits(K, N, x.dtype, cuda_build.sm_count(dev))} K splits")
        wb = nbytes(w)
        b_ms, b_by = bound(nbytes(w, x) + N * x.element_size(), 2 * K * N, x.dtype)
        times[where] = {"times": t, "bound_ms": b_ms, "bound_by": b_by,
                        "bound_kt_ms": bound(nbytes(wt, x) + N * 4, 2 * K * N, x.dtype)[0]}
        log(f"  timing matvec probes {where} K={K} N={N} bf16 ({wb / 1e6:.1f} MB, bound "
            f"{b_ms * 1e3:.2f} us): " + ", ".join(
                f"{name} {v * 1e3:.2f} us ({wb / (v * 1e-3) / 1e9:.0f} GB/s, "
                f"{wb / (v * 1e-3) / HBM_BYTES_PER_S * 100:.1f} % of 3.35 TB/s)"
                for name, v in t.items()) + f"  [{card}]")
        del ws, wts
    return max_err, launches, times


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


def _load(preset: str = "qwen3-tts-0.6b", **kw):
    from qwen3tts_tpu_torch import FasterQwen3TTS

    t0 = time.time()
    model = FasterQwen3TTS.from_pretrained(f"random:{preset}", device="cuda",
                                           dtype="bfloat16", **kw)
    torch.cuda.synchronize()
    model.load_s = time.time() - t0
    log(f"load random:{preset} {kw or ''}: {model.load_s:.1f}s")
    return model


def _engine(model, **kw):
    """A new Engine on the model's weights (``use_cuda_graphs=False``: the
    chunks run eagerly, every kernel launched by its wrapper)."""
    from qwen3tts_tpu_torch.runtime.engine import Engine

    kw.setdefault("max_seq_len", model.max_seq_len)
    return Engine(model.params["talker"], model.params["predictor"], model.cfg, **kw)


def slice_phase(card: str, model):
    """The eager bf16 path through the public API: three requests, the
    flash-decode wrapper's launches counted."""
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode

    steps, chunk, sync = STEPS, CHUNK, torch.cuda.synchronize
    model.engine = _engine(model, use_cuda_graphs=False)
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


def slice_int8_phase(card: str, model):
    """The int8 + fused-block path, eager: int8 weights, int8 KV cache, fused
    kernels; one non-streaming and one streaming (chunk 8) request."""
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode

    steps, chunk, sync = STEPS, CHUNK, torch.cuda.synchronize
    model.engine = _engine(model, use_fused_kernels=True, kv_quant=True,
                           use_cuda_graphs=False)
    kv = model.engine.new_kv()
    if kv["k"].dtype != torch.int8:
        raise AssertionError("kv_quant did not give an int8 cache")
    model.engine.release({"kv": kv})  # the first request takes it from the pool
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
    kernels (free-running and step by step from the CPU's cache, counting
    the int8 cache entries that differ), and predictor micro-steps through
    the fused kernels."""
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

        def move(t, dev):
            return ({k: move(v, dev) for k, v in t.items()} if isinstance(t, dict)
                    else [move(v, dev) for v in t] if isinstance(t, list) else t.to(dev))

        def run(device, caches):
            """(talker outputs, predictor outputs); ``caches`` collects the
            talker's KV cache as each talker output left it (the prefill's,
            then each decode step's)."""
            dev = torch.device(device)
            p = move(params, dev)
            kv = talker_lib.new_kv_cache(cfg.talker, 1, 64, torch.float32, dev, kv_quant=True)
            pad = torch.zeros((1,), dtype=torch.int32, device=dev)
            _, logits, kv = talker_lib.prefill(p["talker"], cfg.talker,
                                               torch.from_numpy(embeds).to(dev), pad, kv)
            touts = [logits]
            for i in range(len(xs)):
                caches.append({k: t.clone() for k, t in kv.items()})
                pos = torch.full((1,), 12 + i, dtype=torch.int32, device=dev)
                h, kv = talker_lib.decode_step(p["talker"], cfg.talker,
                                               torch.from_numpy(xs[i]).to(dev), pos, pad,
                                               kv, use_flash=True, fused=True)
                touts.append(h.reshape(1, -1))
            caches.append({k: t.clone() for k, t in kv.items()})
            # predictor: 2-token prefill (unfused), then fused micro-steps
            blocks = p["predictor"]["blocks"]
            pkv = init_kv_cache(pspec, 1, pcfg.max_seq, torch.float32, dev)
            zero = torch.zeros((1,), dtype=torch.int32, device=dev)
            cos, sin = predictor_lib._rope(pcfg, torch.arange(2, device=dev)[None])
            h, pkv = stack_forward(blocks, torch.from_numpy(pin).to(dev), cos, sin, pkv, 0,
                                   prefill_mask(2, 2, zero), pspec)
            pouts = [h.reshape(1, -1)]
            for i in range(len(pxs)):
                cos, sin = predictor_lib._rope(pcfg, torch.full((1, 1), 2 + i, device=dev))
                h, pkv = stack_forward(blocks, torch.from_numpy(pxs[i]).to(dev), cos, sin,
                                       pkv, 2 + i, decode_mask(pcfg.max_seq, 2 + i, zero),
                                       pspec, fused=True)
                pouts.append(h.reshape(1, -1))
            return [t.cpu() for t in touts], [t.cpu() for t in pouts]

        before = (fb.fused_norm_matmul.launches, fb.fused_o_mlp.launches,
                  flash_decode.launches_int8kv)
        gpu_caches, caches = [], []
        gpu_t, gpu_p = run("cuda", gpu_caches)
        L, Lp = cfg.talker.num_hidden_layers, pcfg.num_hidden_layers
        fused_calls = len(xs) * L + len(pxs) * Lp
        if (fb.fused_norm_matmul.launches - before[0], fb.fused_o_mlp.launches - before[1],
                flash_decode.launches_int8kv - before[2]) != (fused_calls, fused_calls,
                                                               len(xs) * L):
            raise AssertionError("int8 parity did not run the kernels")
        cpu_t, cpu_p = run("cpu", caches)
        pred_err = max((a - b).abs().max().item() for a, b in zip(gpu_p, cpu_p))

        def flipped(kv, ref):
            """(int8 cache entries of kv that differ from ref's, the largest
            difference)."""
            n, most = 0, 0
            for k, t in kv.items():
                if t.dtype == torch.int8:
                    d = (t.cpu().int() - ref[k].int()).abs()
                    n, most = n + int((d > 0).sum()), max(most, int(d.max()))
            return n, most

        # The talker re-quantizes every new cache row to int8, so a last-bit
        # difference in a float32 sum (the kernels sum in another order than
        # the CPU) can flip one int8 rounding, which moves what attends to
        # that row by about its scale: the chain is continuous in the
        # kernels' last bits only while the card's int8 entries equal the
        # CPU's.  An output is held to F32_ATOL where its cache's int8
        # entries equal the CPU's bit for bit, and to FLIP_ATOL where it
        # attends to a flipped entry; each decode step, run on the card from
        # the CPU chain's cache as it stood before the step, flips at most
        # MAX_FLIPS entries over the whole chain, by one each.  The predictor
        # (a float32 cache) is held to F32_ATOL.
        free = {"equal": 0.0, "flipped": 0.0}
        n_free = 0
        for a, b, kv, ref in zip(gpu_t, cpu_t, gpu_caches, caches):
            where = "flipped" if flipped(kv, ref)[0] else "equal"
            n_free += where == "flipped"
            free[where] = max(free[where], (a - b).abs().max().item())
        dev = torch.device("cuda")
        p, pad = move(params, dev), torch.zeros((1,), dtype=torch.int32, device=dev)
        step = {"equal": 0.0, "flipped": 0.0}
        flips, most, n_step = 0, 0, 0
        for i in range(len(xs)):
            pos = torch.full((1,), 12 + i, dtype=torch.int32, device=dev)
            h, kv = talker_lib.decode_step(p["talker"], cfg.talker,
                                           torch.from_numpy(xs[i]).to(dev), pos, pad,
                                           move(caches[i], dev), use_flash=True, fused=True)
            n, m = flipped(kv, caches[i + 1])
            flips, most, n_step = flips + n, max(most, m), n_step + (n > 0)
            where = "flipped" if n else "equal"
            step[where] = max(step[where], (h.reshape(1, -1).cpu() - cpu_t[1 + i]).abs().max().item())
        log(f"parity int8 + kv_quant + fused (float32, TF32 off): predictor "
            f"max_abs_err={pred_err:.3e} (tol {F32_ATOL}); talker max_abs_err where the int8 "
            f"cache equals the CPU's: free-running {free['equal']:.3e} ({len(gpu_t) - n_free} "
            f"outputs), per step from the CPU's cache {step['equal']:.3e} "
            f"({len(xs) - n_step} steps) (tol {F32_ATOL}); after a flipped entry: "
            f"{free['flipped']:.3e} ({n_free}), {step['flipped']:.3e} ({n_step}) "
            f"(tol {FLIP_ATOL}); the steps flipped {flips} int8 cache entries (tol "
            f"{MAX_FLIPS}), by at most {most}  [{card}]")
        if not (pred_err <= F32_ATOL and free["equal"] <= F32_ATOL and step["equal"] <= F32_ATOL
                and free["flipped"] <= FLIP_ATOL and step["flipped"] <= FLIP_ATOL
                and flips <= MAX_FLIPS and most <= 1):
            raise AssertionError("card and CPU disagree on the int8 small model")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def slice_micro_phase(card: str, model):
    """The 0.6B bf16 model's predictor through predict_frame(micro_kernel=True)
    with the API's predictor policy (top-k 50, T 0.9) and a generator: 48
    frames, the launch count exactly 14 a frame, tokens in range, embed_sum
    finite; then host-wall ms/frame, synchronised, for the micro-step
    kernel, the default path and fused=True in the same call."""
    from qwen3tts_tpu_torch.models import predictor as predictor_lib
    from qwen3tts_tpu_torch.ops.predictor_step import fused_micro_step, micro_step_weights

    frames, sync = STEPS, torch.cuda.synchronize
    params, pcfg = model.params["predictor"], model.cfg.predictor
    _, policy = model._policies(0.9, 50, 1.0, True, 1.05, 2)
    w = micro_step_weights(params)  # once, outside the frame loop
    g = torch.Generator(device="cuda").manual_seed(13)
    inputs = [torch.randn((1, 2, model.cfg.talker.hidden_size), generator=g,
                          device="cuda").to(torch.bfloat16) for _ in range(frames)]

    def run(**kw):
        out = []
        t = time.time()
        for x in inputs:
            out.append(predictor_lib.predict_frame(params, pcfg, x, g, policy, **kw))
            sync()
        return out, (time.time() - t) / frames * 1e3

    run(micro_kernel=True, micro_weights=w)  # warm-up; not counted
    fused_micro_step.launches = 0  # the main path's run starts here
    out, ms_micro = run(micro_kernel=True, micro_weights=w)
    launches = fused_micro_step.launches  # the main path's run ends here
    if launches != (pcfg.num_codebooks - 1) * frames:
        raise AssertionError(f"fused_micro_step launched {launches} times in {frames} frames; "
                             f"want {pcfg.num_codebooks - 1} a frame")
    toks = torch.stack([t for t, _ in out])
    if toks.shape != (frames, 1, 15) or toks.min() < 0 or toks.max() >= pcfg.codebook_size:
        raise AssertionError(f"micro-kernel frames: tokens {tuple(toks.shape)} out of range")
    if not all(torch.isfinite(e).all() for _, e in out):
        raise AssertionError("micro-kernel frames: embed_sum not finite")
    run()  # warm-up of the default path
    _, ms_default = run()
    run(fused=True)
    _, ms_fused = run(fused=True)
    res = {"micro_kernel": ms_micro, "default": ms_default, "fused": ms_fused}
    log(f"  predictor frames ({frames}, sampled, host wall synchronised): "
        + ", ".join(f"{k} {v:.2f} ms/frame" for k, v in res.items())
        + f"; {launches / frames:g} micro-step launches a frame  [{card}]")
    return launches, res


def parity_micro_phase(card: str):
    """A small float32 model (predictor head_dim 64, so the card runs the
    kernel), TF32 off: greedy predict_frame(micro_kernel=True) on the card
    (kernel) and on the CPU (plain version) give the same tokens, embed_sum
    within F32_ATOL."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import predictor as predictor_lib
    from qwen3tts_tpu_torch.ops.predictor_step import fused_micro_step

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        cfg = dataclasses.replace(
            base, predictor=dataclasses.replace(base.predictor, head_dim=64))
        params = init_random(cfg, seed=5, dtype=torch.float32, device="cpu")["predictor"]
        rng = np.random.default_rng(2)
        pins = rng.standard_normal((4, 1, 2, cfg.talker.hidden_size)).astype(np.float32)
        greedy = predictor_lib.SamplingPolicy(do_sample=False)

        def run(device):
            dev = torch.device(device)
            move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) \
                else t.to(dev)
            p = move(params)
            return [tuple(t.cpu() for t in predictor_lib.predict_frame(
                p, cfg.predictor, torch.from_numpy(x).to(dev), None, greedy,
                micro_kernel=True)) for x in pins]

        before = fused_micro_step.launches
        gpu = run("cuda")
        if fused_micro_step.launches - before != 14 * len(pins):
            raise AssertionError("micro-kernel parity did not run the kernel")
        cpu = run("cpu")
        err = max((a[1] - b[1]).abs().max().item() for a, b in zip(gpu, cpu))
        same = all(torch.equal(a[0], b[0]) for a, b in zip(gpu, cpu))
        log(f"parity predict_frame(micro_kernel=True) (float32, TF32 off, {len(pins)} greedy "
            f"frames): tokens equal={same}, embed_sum max_abs_err={err:.3e} "
            f"(tol {F32_ATOL})  [{card}]")
        if not same or err > F32_ATOL:
            raise AssertionError("card and CPU disagree on the micro-kernel frame")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


GRAPH_STEPS = 96  # the slice-graph phase's timed captured requests (8 s of audio)
EAGER_STEPS = 32  # ... eager ones (75-180 ms a step)
COUNTED_STEPS = {"captured": 16, "eager": 8}  # streamed requests whose kernels are counted
# the kernels counted on each path, launches a step (28 talker layers; 5
# predictor layers x 14 micro-steps)
KERNELS = ("flash_decode", "fused_norm_matmul", "fused_o_mlp", "fused_micro_step",
           "quantize_act", "w8a8_gemv")
GRAPH_PATHS = {  # path -> (model, Engine keywords, launches a step by kernel)
    "bf16": ("bf16", {}, {"flash_decode": 28}),
    "micro": ("bf16", {"use_micro_kernel": True}, {"flash_decode": 28, "fused_micro_step": 14}),
    "int8_fused": ("int8", {"use_fused_kernels": True, "kv_quant": True},
                   {"flash_decode": 28, "fused_norm_matmul": 98, "fused_o_mlp": 98}),
}


def _launch_counts() -> dict:
    """The wrappers' launch counters, by KERNELS name (flash-decode: both caches)."""
    from qwen3tts_tpu_torch.ops import flash_decode as fd
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops import predictor_step as ps
    from qwen3tts_tpu_torch.ops import w8a8

    return {"flash_decode": fd.flash_decode.launches + fd.flash_decode.launches_int8kv,
            "fused_norm_matmul": fb.fused_norm_matmul.launches,
            "fused_o_mlp": fb.fused_o_mlp.launches,
            "fused_micro_step": ps.fused_micro_step.launches,
            "quantize_act": w8a8.quantize_act.launches, "w8a8_gemv": w8a8.w8a8_gemv.launches}


def _zero_counts() -> None:
    from qwen3tts_tpu_torch.ops import flash_decode as fd
    from qwen3tts_tpu_torch.ops import fused_block as fb
    from qwen3tts_tpu_torch.ops import predictor_step as ps
    from qwen3tts_tpu_torch.ops import w8a8

    fd.flash_decode.launches = fd.flash_decode.launches_int8kv = 0
    fb.fused_norm_matmul.launches = fb.fused_o_mlp.launches = ps.fused_micro_step.launches = 0
    w8a8.quantize_act.launches = w8a8.w8a8_gemv.launches = 0


def _per_step(want: dict, B: int) -> dict:
    """Kernel launches a step at B rows, from ``want`` (calls a step):
    fused_o_mlp launches its kernel once per 4 rows above batch 1."""
    from qwen3tts_tpu_torch.ops.fused_block import o_mlp_launches

    return {k: v * (o_mlp_launches(B) if k == "fused_o_mlp" else 1) for k, v in want.items()}


@contextlib.contextmanager
def _recording(engine):
    """``engine`` with captured chunks of its own for the block
    (``ChunkGraphs(record=True)``): its requests capture every chunk they
    replay, and each replay is logged.  The engine's graphs come back after,
    so no other request carries the recording."""
    from qwen3tts_tpu_torch.runtime.graphs import ChunkGraphs

    saved = engine.graphs
    engine.graphs = ChunkGraphs(engine, record=True)
    try:
        yield engine.graphs
    finally:
        engine.graphs = saved


def _steps_run(graphs) -> int:
    """The steps that the replays in a recording's log ran (their ``n``)."""
    torch.cuda.synchronize()
    return sum(int(n) for _, n, _, _ in graphs.log)


def _replayed(graphs) -> tuple:
    """What the replays in a recording's log launched, read from their
    graphs: each replay runs its graph's kernel nodes outside the steps and
    the bodies of its first ``n`` steps' conditional nodes (a step whose
    predicate fails runs none of its body).  Returns (launches by kernel,
    steps run, the replays' device ms by CUDA events, the kernel nodes of
    each captured step by kernel and "all")."""
    from qwen3tts_tpu_torch.ops.cuda_build import KERNEL_SYMBOLS

    torch.cuda.synchronize()
    needles = [KERNEL_SYMBOLS[k] for k in KERNELS]
    launches, steps, device_ms, walked = dict.fromkeys(KERNELS, 0), 0, 0.0, {}
    for g, n, start, end in graphs.log:
        if id(g) not in walked:
            walked[id(g)] = graphs.kernel_nodes(g, needles)
        top, bodies = walked[id(g)]
        steps += int(n)
        for counts in (top, *bodies[: int(n)]):
            for k, c in zip(KERNELS, counts):
                launches[k] += c
        device_ms += start.elapsed_time(end)
    per_step = [dict(zip((*KERNELS, "all"), c)) for _, bodies in walked.values() for c in bodies]
    return launches, steps, device_ms, per_step


def _held_request(engine, fn, want: dict, steps: int, what: str,
                  per_request: dict = None) -> dict:
    """Run ``fn``, a request of ``steps`` frame steps on ``engine``, with the
    launch counters set to 0 just before and read just after, and hold its
    launches to ``want`` a step, plus ``per_request`` launches outside the
    steps (the w8a8 talker prefill's quantize_act, eager).  The wrappers count what they launch
    eagerly (nothing while a stream captures).  On a captured engine the
    request runs twice under ``_recording``: first capturing its chunks
    afresh (each capture runs one eager step on copies of the state) and
    replaying them, then replaying them only; a replay's launches are read
    from its graph (``_replayed``), and every captured step must hold
    ``want``.  Returns per run the steps, wall ms, launches, the kernel
    nodes a captured step holds, and for the replaying run the replays'
    device ms and their share of its wall (the device's busy share)."""
    extra = per_request or {}
    expect = (lambda k: {name: want.get(name, 0) * k for name in KERNELS})
    expect_eager = (lambda k: {name: want.get(name, 0) * k + extra.get(name, 0)
                               for name in KERNELS})

    def run():
        torch.cuda.synchronize()
        _zero_counts()  # the main path's run starts here
        t = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3, _launch_counts()  # ... and ends here

    if engine.graphs is None:
        wall, launches = run()
        if launches != expect_eager(steps):
            raise AssertionError(f"{what}: launches {launches}; want {want} a step, "
                                 f"{steps} steps")
        return {"steps": steps, "wall_ms": wall, "launches": launches}
    res = {}
    with _recording(engine) as graphs:
        for name in ("capturing", "replaying"):
            graphs.log.clear()
            captures = graphs.captures
            wall, eager = run()
            replayed, run_steps, device_ms, per_step = _replayed(graphs)
            warm = graphs.captures - captures
            bad = [c for c in per_step if {k: c[k] for k in KERNELS} != expect(1)]
            if (bad or run_steps != steps or eager != expect_eager(warm)
                    or replayed != expect(steps)):
                raise AssertionError(
                    f"{what} ({name}): {run_steps} steps replayed, launches {replayed} from "
                    f"the graphs and {eager} eagerly ({warm} captures), captured steps "
                    f"holding {bad[:1]}; want {steps} steps, {want} a step")
            launches = {k: eager[k] + replayed[k] for k in KERNELS}
            res[name] = {"steps": steps, "wall_ms": wall, "captures": warm,
                         "replays": len(graphs.log), "launches": launches,
                         "kernel_nodes_a_step": sorted({c["all"] for c in per_step})}
        res["replaying"].update(replay_device_ms=device_ms, busy_share=device_ms / wall)
    return res


class _Timings:
    """Records the timing dict of the loops' last fast_generate (the API
    logs it and returns the audio only)."""

    def __init__(self):
        from qwen3tts_tpu_torch.runtime import loops

        self.loops, self.real, self.last = loops, loops.fast_generate, None

        def recorded(*a, **kw):
            ids, timing = self.real(*a, **kw)
            self.last = timing
            return ids, timing

        loops.fast_generate = recorded

    def close(self):
        self.loops.fast_generate = self.real


def _graph_requests(model, ref: str, want: dict, card: str, mode: str, steps: int = None,
                    per_request: dict = None) -> dict:
    """Warm-up (capture on the captured path), then a non-streamed (chunk
    16) and a streamed (chunk 8) request through the API (``steps``, by
    default GRAPH_STEPS captured, EAGER_STEPS eager), then a streamed request
    of COUNTED_STEPS whose launches are held to ``want`` a step and
    ``per_request`` outside the steps (``_held_request``)."""
    sync = torch.cuda.synchronize
    graphs = model.engine.graphs
    embeds, trailing, _, _ = model._prepare_clone(TEXT_A, ref, "", "English", True, True, True,
                                                  None)
    pol, ppol = model._policies(0.9, 50, 1.0, True, 1.05, 2)
    sync()
    t = time.time()
    model._warmup(embeds.shape[1], trailing.shape[1], pol, ppol, chunk_sizes=(8, 16))
    sync()
    res = {"warmup_s": time.time() - t,
           "captures": graphs.captures if graphs is not None else 0}
    kw = dict(language="English", ref_audio=ref, ref_text="reference transcript")
    kind = "captured" if graphs is not None else "eager"
    n = steps or (GRAPH_STEPS if graphs is not None else EAGER_STEPS)
    spf = model.vocoder.spf
    model.generate_voice_clone(text=TEXT_A, max_new_tokens=16, min_new_tokens=16, **kw)
    replays = graphs.replays if graphs is not None else 0
    rec = _Timings()
    try:
        sync()
        t = time.time()
        wavs, _ = model.generate_voice_clone(text=TEXT_A, max_new_tokens=n, min_new_tokens=n,
                                             **kw)
        sync()
        wall = time.time() - t
    finally:
        rec.close()
    _check_audio(wavs[0], n, spf, f"{mode} non-streamed")
    res["non_streamed_chunk16"] = {"ms_per_step": wall / n * 1e3, "rtf": n / 12.0 / wall,
                                   "prefill_ms": rec.last["prefill_ms"],
                                   "decode_ms_per_step": rec.last["ms_per_step"]}
    t = time.time()
    first, chunks, timings = None, [], []
    for audio, _sr, timing in model.generate_voice_clone_streaming(
            text=TEXT_A, max_new_tokens=n, min_new_tokens=n, chunk_size=8, **kw):
        first = first or (time.time() - t) * 1e3
        chunks.append(audio)
        timings.append(timing)
    sync()
    wall = time.time() - t
    _check_audio(np.concatenate(chunks), n, spf, f"{mode} streamed")
    res["streamed_chunk8"] = {"ms_per_step": wall / n * 1e3, "rtf": n / 12.0 / wall,
                              "ttfa_ms": first, "prefill_ms": timings[0]["prefill_ms"]}
    res["replays"] = (graphs.replays - replays) if graphs is not None else 0
    steps = COUNTED_STEPS[kind]
    res["steps"] = n
    res["counted_request"] = _held_request(model.engine, lambda: list(
        model.generate_voice_clone_streaming(text=TEXT_A, max_new_tokens=steps,
                                             min_new_tokens=steps, chunk_size=8, **kw)),
        want, steps, mode, per_request)
    log(f"  {mode}: " + json.dumps(res) + f"  [{card}]")
    return res


def _greedy_frames(engine, prompt, steps: int, chunk: int, seed=None):
    """Frames of one request through the loops: greedy talker and predictor,
    or sampled from ``seed``."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    if seed is None:
        gen, pol, ppol = None, GenerationPolicy(do_sample=False), SamplingPolicy(do_sample=False)
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        pol, ppol = GenerationPolicy(), SamplingPolicy()
    ids, _ = loops.fast_generate(engine, *prompt, generator=gen, max_new_tokens=steps,
                                 policy=dataclasses.replace(pol, min_new_tokens=steps),
                                 pred_policy=ppol, device_chunk=chunk)
    return ids


def _dead_steps(model, prompt, card: str) -> dict:
    """A captured chunk stops when every row is done: a greedy request,
    rerun with the talker's EOS id set to a token it first samples at step
    40 or later, so that it stops there; chunks of 16 and of 8, the next one
    dispatched before each read; against the same frames ended by the token
    budget instead.  The steps that ran (the chunks' ``n``) must equal the
    frames returned (the last of them sampled the EOS), and the card must
    be idle soon after the request returns."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    ids = _greedy_frames(model.engine, prompt, 96, 16)
    first_at = {}
    for i, t in enumerate(ids[:, 0].tolist()):
        first_at.setdefault(t, i)
    k = min(i for i in first_at.values() if i >= 40)
    cfg = dataclasses.replace(model.cfg, talker=dataclasses.replace(
        model.cfg.talker, codec_eos_token_id=int(ids[k, 0])))
    eng = Engine(model.params["talker"], model.params["predictor"], cfg,
                 max_seq_len=model.max_seq_len)
    pol = GenerationPolicy(do_sample=False, min_new_tokens=2)
    ppol = SamplingPolicy(do_sample=False)
    res = {"eos_step": k}
    with _recording(eng) as graphs:  # the chunks' n, from its log
        eng.warmup(prompt[0].shape[1], prompt[1].shape[1], pol, ppol, chunk_sizes=(16, 8))
        for chunk in (16, 8):
            for budget in (k, 96):  # the same frames without and with the EOS ending them
                replays = graphs.replays
                torch.cuda.synchronize()
                graphs.log.clear()
                t = time.time()
                out, _ = loops.fast_generate(eng, *prompt, generator=None, max_new_tokens=budget,
                                             policy=pol, pred_policy=ppol, device_chunk=chunk)
                ret = time.time() - t
                torch.cuda.synchronize()
                run = {"frames": len(out), "chunks": graphs.replays - replays,
                       "return_ms": ret * 1e3, "device_tail_ms": (time.time() - t - ret) * 1e3,
                       "steps_run": _steps_run(graphs)}
                res[f"chunk{chunk}_{'budget' if budget == k else 'eos'}"] = run
                if budget == 96 and run["steps_run"] != run["frames"]:
                    raise AssertionError(f"chunk {chunk}: {run['steps_run']} steps ran for "
                                         f"{run['frames']} frames ended by an EOS")
    log(f"  dead steps (EOS at step {k}): {json.dumps(res)}  [{card}]")
    return res


def slice_graph_phase(card: str, models: dict):
    """The captured chunks through FasterQwen3TTS on the 0.6B at full width:
    each path (bf16; bf16 with the micro-step kernel; int8 weights + int8 KV
    cache + fused kernels) eager and captured, non-streamed (chunk 16) and
    streamed (chunk 8); each path's kernels counted in a request
    (``_held_request``: on the captured paths from the graphs that the
    request captured and replayed); greedy captured vs eager tokens; sampled replays
    by seed; the pipeline depth; the cache's capped last chunk; warmup_all;
    and the cost of dead steps after an EOS."""
    from qwen3tts_tpu_torch.ops.flash_decode import flash_decode
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy, bucket_for

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        for path, (which, kw, want) in GRAPH_PATHS.items():
            model = models[which]
            for mode, graphs in (("eager", False), ("captured", True)):
                model.engine = _engine(model, use_cuda_graphs=graphs, **kw)
                results.setdefault(path, {})[mode] = _graph_requests(
                    model, ref, want, card, f"{path} {mode}")

        model = models["bf16"]
        prompt = model._prepare_clone(TEXT_A, ref, "", "English", True, True, True, None)[:3]
        eager, captured = _engine(model, use_cuda_graphs=False), _engine(model)
        g_eager, g_capt = (_greedy_frames(e, prompt, 48, 16) for e in (eager, captured))
        equal = (g_eager == g_capt).all(axis=1)
        first_diff = int(np.argmin(equal)) if not equal.all() else None
        log(f"  bf16 0.6B greedy, captured vs eager: {int(equal.sum())} of {len(equal)} frames "
            f"equal, {int((g_eager[:, 0] == g_capt[:, 0]).sum())} codebook-0 tokens equal, "
            f"first differing step {first_diff}  [{card}]")
        seeded = {s: _greedy_frames(captured, prompt, 48, 16, seed=s) for s in (11, 12)}
        again = _greedy_frames(captured, prompt, 48, 16, seed=11)
        same_as_eager = np.array_equal(_greedy_frames(eager, prompt, 48, 16, seed=11),
                                       seeded[11])
        log(f"  sampled replays: seed 11 twice equal={np.array_equal(seeded[11], again)}, "
            f"seeds 11 and 12 differ={not np.array_equal(seeded[11], seeded[12])}, "
            f"seed 11 equals the eager request={same_as_eager}")
        if not np.array_equal(seeded[11], again) or np.array_equal(seeded[11], seeded[12]):
            raise AssertionError("sampled replays do not repeat by seed")

        # the pipeline depth of the streamed audio loop, captured chunk 8
        # (the first request captures the sampled policy's graphs)
        depth = {}
        for d in (1, 1, 2, 3, 1, 2, 3):
            torch.cuda.synchronize()
            t = time.time()
            first = None
            for _f, _a, _t in loops.fast_generate_streaming_audio(
                    captured, model.vocoder, *prompt, generator=None,
                    max_new_tokens=GRAPH_STEPS, policy=GenerationPolicy(
                        min_new_tokens=GRAPH_STEPS), chunk_size=8, pipeline_depth=d):
                first = first or (time.time() - t) * 1e3
            torch.cuda.synchronize()
            wall = time.time() - t
            depth.setdefault(str(d), []).append({"ttfa_ms": first,
                                                 "rtf": GRAPH_STEPS / 12.0 / wall})
        depth["1"].pop(0)  # the capture
        log(f"  pipeline_depth (streamed, chunk 8, {GRAPH_STEPS} steps): {json.dumps(depth)}"
            f"  [{card}]")

        # the cache's last chunk: capped below the chunk size, so eager
        T = prompt[0].shape[1]
        max_seq = max(bucket_for(T), T + 1 + 16 + 5)
        capped = max_seq - 1 - T - 16
        model.engine = _engine(model, max_seq_len=max_seq)
        kw = dict(language="English", ref_audio=ref, ref_text="reference transcript",
                  max_new_tokens=64, min_new_tokens=64)
        model.generate_voice_clone(text=TEXT_A, **kw)  # captures
        flash_decode.launches = 0
        replays = model.engine.graphs.replays
        wavs, _ = model.generate_voice_clone(text=TEXT_A, **kw)
        torch.cuda.synchronize()
        cap = {"steps": len(wavs[0]) // model.vocoder.spf, "replays":
               model.engine.graphs.replays - replays, "eager_flash_launches": flash_decode.launches}
        log(f"  capped last chunk (max_seq_len {max_seq}, prompt {T}): {json.dumps(cap)}")
        if cap != {"steps": 16 + capped, "replays": 1, "eager_flash_launches": 28 * capped}:
            raise AssertionError(f"capped chunk: {cap}, want {16 + capped} steps, one replay "
                                 f"and {28 * capped} eager flash-decode launches")

        model.engine = _engine(model)
        torch.cuda.synchronize()
        warm_all = {"seconds": model.warmup_all(chunk_sizes=(8, 16)),
                    "captures": model.engine.graphs.captures}
        log(f"  warmup_all (5 trailing-text buckets x chunks 8, 16, with and without the "
            f"codec): {json.dumps(warm_all)}  [{card}]")
        dead = _dead_steps(model, prompt, card)
    return {"paths": results, "greedy_equal_frames": int(equal.sum()),
            "greedy_frames": len(equal), "sampled_equals_eager": same_as_eager,
            "pipeline_depth": depth, "capped": cap, "warmup_all": warm_all, "dead_steps": dead}


def graph_parity_phase(card: str):
    """Captured against eager chunks on the small float32 model of the
    parity phase (TF32 off) and on the int8 one (int8 weights, int8 KV
    cache, fused kernels): the same kernels in the same order give equal
    greedy tokens, step for step."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        talker = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20))
        cfg = dataclasses.replace(base, talker=talker)
        H = cfg.talker.hidden_size
        rng = np.random.default_rng(5)
        embeds = rng.standard_normal((1, 12, H)).astype(np.float32) * 0.1
        tth = torch.from_numpy(rng.standard_normal((1, 16, H)).astype(np.float32) * 0.1)
        tpe = torch.from_numpy(rng.standard_normal((1, 1, H)).astype(np.float32) * 0.1)
        for name, seed, kw in (("float32", 3, {}),
                               ("int8", 4, dict(use_fused_kernels=True, kv_quant=True))):
            params = init_random(cfg, seed=seed, dtype=torch.float32, device="cuda")
            if name == "int8":
                params = quantize_bundle(params, "int8")
            frames = {}
            for graphs in (False, True):
                eng = Engine(params["talker"], params["predictor"], cfg, max_seq_len=128,
                             use_cuda_graphs=graphs, **kw)
                state = eng.prefill(embeds, None, GenerationPolicy(do_sample=False,
                                                                   min_new_tokens=99),
                                    SamplingPolicy(do_sample=False))
                out = [state["token"][:, None].expand(1, 16).cpu()]
                for _ in range(4):
                    _, f, n, lens, _ = eng.decode_chunk(state, tth.cuda(), 7, tpe.cuda(), 8)
                    out.append(f[0, : int(lens[0])].cpu())
                frames[graphs] = torch.cat(out)
            equal = (frames[True] == frames[False]).all(dim=1)
            first = None if bool(equal.all()) else int(torch.argmin(equal.int()))
            log(f"parity {name} captured vs eager (TF32 off): {int(equal.sum())} of "
                f"{len(equal)} steps equal, first differing step {first}  [{card}]")
            if first is not None:
                raise AssertionError(f"{name}: captured and eager chunks differ at step {first}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# slice-icl and slice-voices: the rest of the single-request API
# ---------------------------------------------------------------------------

ICL_REF_TEXT = "A three second reference that the cloned voice continues from."
INSTRUCT = "A calm, low voice, speaking slowly and clearly."
LONGFORM_TEXT = ("The first group of this long text is one sentence of about this length. "
                 "The second group follows it with other words in another order. "
                 "The third group ends the text with a last sentence of its own.")
LONGFORM_BUDGET = 48  # frames a segment when the budget ends it


def _timed_request(call, steps: int, spf: int, what: str) -> dict:
    """One non-streamed request ``call() -> ([wav], sr)``: wall ms/step, RTF
    and the loop's prefill ms; the audio checked."""
    rec = _Timings()
    try:
        torch.cuda.synchronize()
        t = time.time()
        wavs, _ = call()
        torch.cuda.synchronize()
        wall = time.time() - t
    finally:
        rec.close()
    _check_audio(wavs[0], steps, spf, what)
    return {"ms_per_step": wall / steps * 1e3, "rtf": steps / 12.0 / wall,
            "prefill_ms": rec.last["prefill_ms"]}


def _streamed_request(call, steps: int, chunk: int, spf: int, what: str) -> dict:
    """One streamed request ``call()`` yielding (audio, sr, timing): wall
    ms/step, RTF, TTFA and the first chunk's prefill ms; the chunks, the
    audio and the final flag checked."""
    torch.cuda.synchronize()
    t = time.time()
    first, chunks, timings = None, [], []
    for audio, _sr, timing in call():
        first = first or (time.time() - t) * 1e3
        chunks.append(audio)
        timings.append(timing)
    torch.cuda.synchronize()
    wall = time.time() - t
    if len(chunks) != -(-steps // chunk):
        raise AssertionError(f"{what}: {len(chunks)} chunks for {steps} steps at {chunk}")
    _check_audio(np.concatenate(chunks), steps, spf, what)
    if not timings[-1]["is_final"] or timings[-1]["total_steps_so_far"] != steps:
        raise AssertionError(f"{what}: bad final timing {timings[-1]}")
    return {"ms_per_step": wall / steps * 1e3, "rtf": steps / 12.0 / wall, "ttfa_ms": first,
            "prefill_ms": timings[0]["prefill_ms"]}


def _longform_gap(card: str, model, ref: str) -> dict:
    """The wait between segments of generate_longform_streaming (three
    sentence groups, chunk 8, the talker greedy): from one segment's last
    chunk to the next segment's first, with every group ended by the token
    budget, then by an EOS.  The EOS run's engine takes as EOS id the token
    that the budget run's greedy segments all sample, latest; each segment
    draws the predictor's samples from the same seed in both runs, so the
    EOS run repeats the budget run's frames up to that token."""
    from qwen3tts_tpu_torch.api import longform
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import Engine

    groups = longform.split_sentences(LONGFORM_TEXT, 80)
    if len(groups) != 3:
        raise AssertionError(f"long form: {len(groups)} sentence groups, want 3")
    real_stream = model.generate_voice_clone_streaming
    real_loop = loops.fast_generate_streaming_audio
    frames = []

    def reseeded(*a, **kw):
        model._gen.manual_seed(21)
        yield from real_stream(*a, **kw)

    def recorded(*a, **kw):
        frames.append([])
        for f, audio, timing in real_loop(*a, **kw):
            frames[-1].append(f)
            yield f, audio, timing

    def run(min_new: int) -> dict:
        frames.clear()
        first, last = {}, {}
        torch.cuda.synchronize()
        t0 = time.time()
        for _audio, _sr, timing in longform.generate_longform_streaming(
                model, LONGFORM_TEXT, "English", ref, "", max_chars=80, chunk_size=8,
                do_sample=False, max_new_tokens=LONGFORM_BUDGET, min_new_tokens=min_new):
            if not timing["is_gap"]:
                now = (time.time() - t0) * 1e3
                first.setdefault(timing["segment"], now)
                last[timing["segment"]] = now
        torch.cuda.synchronize()
        return {"frames": [sum(len(f) for f in seg) for seg in frames],
                "gap_ms": [first[i + 1] - last[i] for i in range(len(groups) - 1)],
                "segment_ms": [last[i] - first[i] for i in range(len(groups))],
                "first_chunk_ms": first[0], "wall_ms": (time.time() - t0) * 1e3}

    saved = model.engine
    model.generate_voice_clone_streaming = reseeded
    loops.fast_generate_streaming_audio = recorded
    try:
        out = {"budget": run(LONGFORM_BUDGET)}
        firsts = []
        for seg in frames:
            f0 = {}
            for i, tok in enumerate(np.concatenate(seg)[:, 0].tolist()):
                f0.setdefault(tok, i)
            firsts.append({tok: i for tok, i in f0.items() if i >= 8})
        # the token in the most segments, then the latest first sample
        eos = max(set().union(*firsts), key=lambda tok: (
            sum(tok in f for f in firsts), min(f.get(tok, LONGFORM_BUDGET) for f in firsts)))
        cfg = dataclasses.replace(model.cfg, talker=dataclasses.replace(
            model.cfg.talker, codec_eos_token_id=int(eos)))
        model.engine = Engine(model.params["talker"], model.params["predictor"], cfg,
                              max_seq_len=model.max_seq_len)
        out["eos"] = run(2)
        out["eos"]["eos_step"] = [f.get(eos) for f in firsts]
    finally:
        model.engine = saved
        del model.generate_voice_clone_streaming
        loops.fast_generate_streaming_audio = real_loop
    if out["budget"]["frames"] != [LONGFORM_BUDGET] * 3 or out["eos"]["frames"] != [
            f.get(eos, LONGFORM_BUDGET) for f in firsts]:
        raise AssertionError(f"long form frames: {out}")
    log(f"  long form (3 groups, chunk 8, greedy talker): {json.dumps(out)}  [{card}]")
    return out


def slice_icl_phase(card: str, models: dict) -> dict:
    """ICL voice clone through the API on the 0.6B: a 3 s reference with its
    transcript, the voice prompt timed on first use (speaker embedding +
    codec encode) and from its cache; after a warm-up request, the parts of
    TTFA alone (encode, codec priming, prompt build, synchronised prefill);
    then non-streamed and streamed (chunk 8) requests of STEPS steps on the
    bf16 model (audio length: steps x spf, the reference cut off), the
    streamed one again with the voice prompt uncached, and one streamed
    request on the int8 + kv_quant + fused model; then the wait between
    long-form segments."""
    sync = torch.cuda.synchronize
    model = models["bf16"]
    steps, spf = STEPS, model.vocoder.spf
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        kw = dict(language="English", ref_audio=ref, ref_text=ICL_REF_TEXT, xvec_only=False,
                  max_new_tokens=steps, min_new_tokens=steps)
        model._voice_prompt_cache.clear()
        sync()
        t = time.time()
        vcp = model._voice_prompt(ref, ICL_REF_TEXT, False, True)
        sync()
        first_ms = (time.time() - t) * 1e3
        t = time.time()
        model._voice_prompt(ref, ICL_REF_TEXT, False, True)
        cached_ms = (time.time() - t) * 1e3
        codes = vcp["ref_code"]
        n_ref = 42  # 3 s and 0.5 s of silence, 12 frames a second
        if (codes.shape != (n_ref, 16) or codes.min() < 0
                or codes.max() >= model.cfg.codec.codebook_size):
            raise AssertionError(f"ICL reference codes {codes.shape} out of range")
        model.generate_voice_clone(text=TEXT_A, **{**kw, "max_new_tokens": 8,
                                                   "min_new_tokens": 8})  # warm-up

        # TTFA's parts alone, warm (the second of two runs of each)
        audio, _ = model._load_ref_audio_with_silence(ref)
        pol, ppol = model._policies(0.9, 50, 1.0, True, 1.05, steps)
        parts = {}
        for _ in range(2):
            sync()
            t = time.time()
            model.vocoder.encode(audio)
            sync()
            parts["encode_ms"] = (time.time() - t) * 1e3
            t = time.time()
            model.engine.vocode_prime(model.vocoder, model.vocoder.stream_state(), codes)
            sync()
            parts["priming_ms"] = (time.time() - t) * 1e3
            t = time.time()
            embeds, _, _, _ = model._prepare_clone(TEXT_A, ref, ICL_REF_TEXT, "English", False,
                                                   True, True, None)
            parts["prompt_build_ms"] = (time.time() - t) * 1e3
            sync()
            t = time.time()
            state = model.engine.prefill(embeds, model._gen, pol, ppol)
            sync()
            parts["prefill_ms"] = (time.time() - t) * 1e3
            model.engine.release(state)
        res["prompt"] = {"ref_frames": n_ref, "prompt_tokens": int(embeds.shape[1]),
                         "voice_prompt_first_ms": first_ms, "voice_prompt_cached_ms": cached_ms,
                         **parts}
        res["non_streamed"] = _timed_request(
            lambda: model.generate_voice_clone(text=TEXT_A, **kw), steps, spf,
            "ICL non-streamed")
        res["streamed_chunk8"] = _streamed_request(
            lambda: model.generate_voice_clone_streaming(text=TEXT_A, chunk_size=CHUNK, **kw),
            steps, CHUNK, spf, "ICL streamed")
        s = res["streamed_chunk8"]
        s["ttfa_split_ms"] = {k: parts[f"{k}_ms"] for k in ("prompt_build", "priming", "prefill")}
        s["ttfa_split_ms"]["first_chunk"] = s["ttfa_ms"] - sum(s["ttfa_split_ms"].values())
        model._voice_prompt_cache.clear()
        res["streamed_chunk8_uncached"] = _streamed_request(
            lambda: model.generate_voice_clone_streaming(text=TEXT_C, chunk_size=CHUNK, **kw),
            steps, CHUNK, spf, "ICL streamed, voice prompt uncached")

        m8 = models["int8"]
        m8.generate_voice_clone(text=TEXT_A, **{**kw, "max_new_tokens": 8,
                                                "min_new_tokens": 8})  # warm-up
        res["int8_streamed_chunk8"] = _streamed_request(
            lambda: m8.generate_voice_clone_streaming(text=TEXT_A, chunk_size=CHUNK, **kw),
            steps, CHUNK, spf, "int8 ICL streamed")
        log(f"  ICL: {json.dumps(res)}  [{card}]")
        res["longform"] = _longform_gap(card, model, ref)
    return res


def icl_parity_phase(card: str):
    """A small float32 model (the talker's head layout, so the card runs
    flash-decode), TF32 off for matmul and cuDNN: the codec encoder's codes
    on the card equal the CPU's except at frames where the CPU's best and
    second-best RVQ distances lie within 1e-4 relative (at most one such
    frame may differ); then the CPU's ICL prompt, greedy, streamed at chunk
    8 with its reference codes priming the codec: the card's captured
    chunks give the CPU's frames and its audio within F32_ATOL."""
    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.audio.wav import read_wav
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import codec as codec_lib
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        talker = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20))
        cfg = dataclasses.replace(base, talker=talker)
        params = init_random(cfg, seed=6, dtype=torch.float32, device="cpu")
        move = lambda t: {k: move(v) for k, v in t.items()} if isinstance(t, dict) \
            else [move(v) for v in t] if isinstance(t, list) else t.cuda()
        models = {dev: FasterQwen3TTS(cfg, p, max_seq_len=512,
                                      vocoder_compute_dtype=torch.float32)
                  for dev, p in (("cpu", params), ("cuda", move(params)))}
        with tempfile.TemporaryDirectory() as tmp:
            ref = os.path.join(tmp, "ref.wav")
            _ref_wav(ref)
            audio, _ = read_wav(ref)
            codes = {dev: m.vocoder.encode(audio) for dev, m in models.items()}
            cpu = models["cpu"].vocoder
            T = len(audio) // cpu.spf
            _, margins = codec_lib.rvq(codec_lib.encode_hidden(
                cpu.params, cfg.codec, torch.from_numpy(audio[: T * cpu.spf])[None]),
                cpu.params["encoder"]["codebooks"])
            near = (margins[0] < 1e-4).any(-1).numpy()
            differ = (codes["cpu"] != codes["cuda"]).any(-1)
            log(f"parity codec encode (float32, TF32 off, {T} frames): {int(differ.sum())} "
                f"frames differ, {int(near.sum())} frames with a near tie on the CPU  [{card}]")
            if differ.sum() > 1 or (differ & ~near).any():
                raise AssertionError("card and CPU encode disagree beyond a near tie")

            prompt = models["cpu"]._prepare_clone(TEXT_C, ref, ICL_REF_TEXT, "English", False,
                                                  True, True, None)
            n = 24
            out = {}
            for dev, m in models.items():
                fr, au = [], []
                for f, a, _ in loops.fast_generate_streaming_audio(
                        m.engine, m.vocoder, *prompt[:3], generator=None, max_new_tokens=n,
                        policy=GenerationPolicy(do_sample=False, min_new_tokens=n),
                        pred_policy=SamplingPolicy(do_sample=False), chunk_size=8,
                        ref_codes=prompt[3]):
                    fr.append(f)
                    au.append(a)
                out[dev] = (np.concatenate(fr), np.concatenate(au))
        replays = models["cuda"].engine.graphs.replays
        same = np.array_equal(out["cpu"][0], out["cuda"][0])
        err = float(np.abs(out["cpu"][1] - out["cuda"][1]).max())
        log(f"parity ICL streamed (float32, TF32 off, {n} greedy steps, {len(prompt[3])} "
            f"reference frames, {replays} replays): frames equal={same}, audio "
            f"max_abs_err={err:.3e} (tol {F32_ATOL})  [{card}]")
        if replays != n // 8 or not same or err > F32_ATOL:
            raise AssertionError("card and CPU disagree on the captured ICL stream")
        return {"encode_frames_differ": int(differ.sum()), "near_ties": int(near.sum()),
                "audio_max_abs_err": err}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# slice-batch: batched generation
# ---------------------------------------------------------------------------

BATCH_STEPS = 96  # slice-batch's timed requests, pinned by min_new_tokens
BATCH_TRACED = 16  # ... and its counted ones (one chunk of 16)
BATCH_SIZES = (4, 16)
BATCH_PATHS = {  # path -> (model, Engine keywords, launches a step by kernel)
    "bf16": ("bf16", {}, {"flash_decode": 28}),
    "int8_fused": ("int8", {"use_fused_kernels": True, "kv_quant": True},
                   {"flash_decode": 28, "fused_norm_matmul": 98, "fused_o_mlp": 98}),
}


def _batch_texts(B: int) -> list:
    """B texts of different lengths (4 to 23 words)."""
    words = (TEXT_A + " " + TEXT_C).split()
    return [" ".join(words[: 4 + (7 * b) % 20]) for b in range(B)]


def _greedy():
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    return GenerationPolicy(do_sample=False, min_new_tokens=2), SamplingPolicy(do_sample=False)


def _batch_run(eng, prompt, steps: int, pol, ppol, gen=None):
    """fast_generate_batch over a stacked prompt (``_batch_prompt``)."""
    from qwen3tts_tpu_torch.runtime import loops

    embeds, trailing, tpe, pads, tth_lens, _ = prompt
    return loops.fast_generate_batch(eng, embeds, trailing, tpe, generator=gen, pad_count=pads,
                                     tth_lens=tth_lens, max_new_tokens=steps, policy=pol,
                                     pred_policy=ppol, device_chunk=16)


def _batch_throughput(card: str, model, ref: str, path: str, B: int, kw: dict,
                      want: dict, steps: int = BATCH_STEPS, per_request: dict = None) -> dict:
    """Warm-up (capture of chunk 16), a timed sampled request of ``steps``
    steps over B rows of different prompt lengths, and one of BATCH_TRACED
    steps whose launches are held to ``want`` calls a step (``_per_step``
    kernel launches) and ``per_request`` outside the steps, with the
    device's busy share (``_held_request``)."""
    sync = torch.cuda.synchronize
    eng = _engine(model, batch=B, **kw)
    prompt = model._batch_prompt(_batch_texts(B), ref, "", "English", True, True, True, None)
    pol, ppol = model._policies(0.9, 50, 1.0, True, 1.05, 2)
    sync()
    t = time.time()
    eng.warmup(prompt[0].shape[1], prompt[1].shape[1], pol, ppol, chunk_sizes=(16,))
    sync()
    res = {"warmup_s": time.time() - t,
           "prompt_tokens": [int(prompt[0].shape[1] - p) for p in prompt[3]]}

    def request(steps):
        return _batch_run(eng, prompt, steps, dataclasses.replace(pol, min_new_tokens=steps),
                          ppol, model._gen)

    sync()
    t = time.time()
    out, timing = request(steps)
    sync()
    wall = time.time() - t
    if [len(o) for o in out] != [steps] * B:
        raise AssertionError(f"{path} B{B}: rows of {[len(o) for o in out]} frames")
    res.update({"steps": steps, "ms_per_step": wall / steps * 1e3,
                "frames_per_s": B * steps / wall,
                "throughput_rtf": B * steps / 12.0 / wall,
                "prefill_ms": timing["prefill_ms"]})
    res["counted_request"] = _held_request(eng, lambda: request(BATCH_TRACED),
                                           _per_step(want, B), BATCH_TRACED, f"{path} B{B}",
                                           per_request)
    log(f"  {path} B{B}: {json.dumps(res)}  [{card}]")
    return res


def _batch_eos(card: str, model, ref: str) -> dict:
    """A greedy B 4 batch, then again with the EOS id set to a token that row 1
    first samples at step 8 or later: row 1 stops there, every other row
    gives its frames of the first run (up to its own first such token), and
    the chunks run the steps of the longest row and no more."""
    prompt = model._batch_prompt(_batch_texts(4), ref, "", "English", True, True, True, None)
    pol, ppol = _greedy()
    base, _ = _batch_run(_engine(model, batch=4), prompt, 48, pol, ppol)
    first = {}
    for i, t in enumerate(base[1][:, 0].tolist()):
        first.setdefault(t, i)
    k = min(i for i in first.values() if i >= 8)
    eos = int(base[1][k, 0])
    eng = _engine(model, batch=4)
    eng.eos_id = eos
    with _recording(eng) as graphs:
        got, _ = _batch_run(eng, prompt, 48, pol, ppol)
        steps_run = _steps_run(graphs)
    ends = [next((i for i, t in enumerate(b[:, 0].tolist()) if t == eos), len(b)) for b in base]
    res = {"eos_row1_step": k, "frames": [len(g) for g in got], "want_frames": ends,
           "steps_run": steps_run}
    log(f"  B4 batch with row 1 ended by an EOS: {json.dumps(res)}  [{card}]")
    if len(got[1]) != k or any(not np.array_equal(g, b[:e]) for g, b, e in zip(got, base, ends)):
        raise AssertionError("an EOS in one row changed another row's frames")
    if res["steps_run"] != max(ends):
        raise AssertionError(f"the chunks ran {res['steps_run']} steps for rows of {ends}")
    return res


def _batch_join(card: str, model, ref: str) -> dict:
    """join_row into a running greedy B 4 batch (row 2, once the position
    passes the joining prompt's bucket), then 32 steps: the joined row's
    frames beside the same prompt's batch-1 request."""
    from qwen3tts_tpu_torch.runtime.engine import bucket_for

    pol, ppol = _greedy()
    prompt = model._batch_prompt(_batch_texts(4), ref, "", "English", True, True, True, None)
    join = model._prepare_clone(TEXT_C, ref, "", "English", True, True, True, None)
    eng = _engine(model, batch=4)
    dev, dt = eng.device, eng.dtype
    embeds, trailing, tpe, pads, tth_lens, _ = prompt
    state = eng.prefill(embeds, None, pol, ppol, pad_count=pads)
    up = (lambda a: torch.from_numpy(a).to(dev, dt))
    tth, tpe_d = up(trailing), up(tpe)
    lens_d = torch.from_numpy(tth_lens).to(dev)
    while state["pos_host"] < bucket_for(join[0].shape[1]):
        _, _, n, _, _ = eng.decode_chunk(state, tth, lens_d, tpe_d, 16)
        eng.settle(state, int(n))
    t = time.time()
    eng.join_row(state, 2, join[0], policy=pol, pred_policy=ppol, pos_hint=state["pos_host"])
    torch.cuda.synchronize()
    join_ms = (time.time() - t) * 1e3
    Tt = max(trailing.shape[1], join[1].shape[1])
    tth2 = np.repeat(tpe, Tt, axis=1)
    tth2[:, : trailing.shape[1]] = trailing
    tth2[2] = tpe[2]
    tth2[2, : join[1].shape[1]] = join[1][0]
    tth2[2, join[1].shape[1]:] = join[2][0, 0]
    tpe2 = tpe.copy()
    tpe2[2] = join[2][0]
    lens2 = tth_lens.copy()
    lens2[2] = join[1].shape[1]
    rows = []
    for _ in range(2):
        _, f, n, lens, _ = eng.decode_chunk(state, up(tth2), torch.from_numpy(lens2).to(dev),
                                            up(tpe2), 16)
        eng.settle(state, int(n))
        rows.append(f[2, : int(lens[2])].cpu().numpy())
    eng.release(state)
    joined = np.concatenate(rows)
    single = _greedy_frames(model.engine, join[:3], len(joined), 16)
    equal = (joined == single[: len(joined)]).all(axis=1)
    res = {"join_ms": join_ms, "frames": len(joined), "equal_frames_vs_batch1": int(equal.sum()),
           "first_differing_step": None if equal.all() else int(np.argmin(equal))}
    log(f"  join_row into a running B4 batch (bf16 0.6B): {json.dumps(res)}  [{card}]")
    if len(joined) != 32 or not equal.all():
        raise AssertionError(f"the joined row's {len(joined)} greedy frames differ from the "
                             f"prompt's batch-1 request from step {res['first_differing_step']}")
    return res


def _batch_vocode(card: str, model, ref: str) -> dict:
    """chunk_vocode_batched at chunk 8 on a sampled B 4 batch: three chunks
    (the first captures), every row's audio [8 * spf] finite and in [-1, 1]."""
    eng = _engine(model, batch=4)
    embeds, trailing, tpe, pads, tth_lens, _ = model._batch_prompt(
        _batch_texts(4), ref, "", "English", True, True, True, None)
    pol, ppol = model._policies(0.9, 50, 1.0, True, 1.05, 24)
    state = eng.prefill(embeds, model._gen, pol, ppol, pad_count=pads)
    up = (lambda a: torch.from_numpy(a).to(eng.device, eng.dtype))
    tth, tpe_d, lens_d = up(trailing), up(tpe), torch.from_numpy(tth_lens).to(eng.device)
    vst = model.vocoder.stream_state_batched(4)
    spf, ms = model.vocoder.spf, []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.time()
        _, _, n, lens, _, audio, vst = eng.chunk_vocode_batched(model.vocoder, state, tth, lens_d,
                                                                 tpe_d, CHUNK, vst)
        audio = audio.cpu().numpy()
        ms.append((time.time() - t) * 1e3)
        eng.settle(state, int(n))
        if audio.shape != (4, CHUNK * spf) or int(n) != CHUNK or lens.tolist() != [CHUNK] * 4:
            raise AssertionError(f"chunk_vocode_batched: audio {audio.shape}, n {int(n)}")
        if not np.isfinite(audio).all() or np.abs(audio).max() > 1.0:
            raise AssertionError("chunk_vocode_batched: audio not finite or outside [-1, 1]")
    eng.release(state)
    res = {"chunk": CHUNK, "rows": 4, "audio_per_row": CHUNK * spf, "chunk_ms": ms,
           "captures": eng.graphs.captures}
    log(f"  chunk_vocode_batched (B4, chunk 8, bf16 0.6B): {json.dumps(res)}  [{card}]")
    return res


def slice_batch_phase(card: str, models: dict) -> dict:
    """Batched generation on the 0.6B at full width: the bf16 and the int8 +
    kv_quant + fused paths at B 4 and B 16 (warm-up, a timed 96-step
    request, a traced 16-step one); then on bf16 a batch with one row ended
    by an EOS, join_row into a running batch, chunk_vocode_batched, and
    generate_voice_clone_batch through the API with four texts."""
    import gc

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        for path, (which, kw, want) in BATCH_PATHS.items():
            for B in BATCH_SIZES:
                res.setdefault(path, {})[f"B{B}"] = _batch_throughput(
                    card, models[which], ref, path, B, kw, want)
                gc.collect()
                torch.cuda.empty_cache()
        model = models["bf16"]
        res["eos"] = _batch_eos(card, model, ref)
        res["join"] = _batch_join(card, model, ref)
        res["vocode_batched"] = _batch_vocode(card, model, ref)
        texts, api = _batch_texts(4), {}
        for run in ("first (captures)", "second"):
            torch.cuda.synchronize()
            t = time.time()
            wavs, _ = model.generate_voice_clone_batch(texts, "English", ref, "",
                                                       max_new_tokens=STEPS,
                                                       min_new_tokens=STEPS)
            wall = time.time() - t
            for i, w in enumerate(wavs):
                _check_audio(w, STEPS, model.vocoder.spf, f"generate_voice_clone_batch row {i}")
            api[run] = {"wall_s": wall, "throughput_rtf": len(wavs) * STEPS / 12.0 / wall}
        res["api_batch4"] = api
        log(f"  generate_voice_clone_batch (4 texts, {STEPS} steps, bf16 0.6B): "
            f"{json.dumps(api)}  [{card}]")
        model._batch_engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return res


def batch_parity_phase(card: str) -> dict:
    """A small float32 model (talker head_dim 128), TF32 off, card (captured
    chunks, kernels) vs CPU (eager, plain versions): a greedy B 3 batch with
    left pads (prompts of 6, 10 and 8), chunks of 8, and join_row into row 1
    after the third chunk, give the same tokens."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.runtime.engine import Engine

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        cfg = dataclasses.replace(base, talker=dataclasses.replace(
            base.talker, head_dim=128, mrope_section=(24, 20, 20)))
        params = init_random(cfg, seed=6, dtype=torch.float32, device="cpu")
        H = cfg.talker.hidden_size
        rng = np.random.default_rng(9)
        T = 10
        batch = np.zeros((3, T, H), np.float32)
        pads = np.asarray([T - L for L in (6, 10, 8)])
        for b in range(3):
            batch[b, pads[b]:] = rng.standard_normal((T - pads[b], H)) * 0.1
        tth = rng.standard_normal((3, 16, H)).astype(np.float32) * 0.1
        join = rng.standard_normal((1, 7, H)).astype(np.float32) * 0.1
        pol, ppol = _greedy()
        pol = dataclasses.replace(pol, min_new_tokens=99)

        def move(t, dev):
            if isinstance(t, dict):
                return {k: move(v, dev) for k, v in t.items()}
            return [move(v, dev) for v in t] if isinstance(t, list) else t.to(dev)

        def run(device):
            p = move(params, device)
            eng = Engine(p["talker"], p["predictor"], cfg, max_seq_len=128, batch=3)
            state = eng.prefill(batch, None, pol, ppol, pad_count=pads)
            tth_d = torch.from_numpy(tth).to(device)
            tpe = torch.zeros((3, 1, H), device=device)
            frames = []
            for i in range(5):
                _, f, n, _, _ = eng.decode_chunk(state, tth_d, 16, tpe, 8)
                eng.settle(state, int(n))
                frames.append(f.cpu().clone())
                if i == 2:
                    eng.join_row(state, 1, join, policy=pol, pred_policy=ppol,
                                 pos_hint=state["pos_host"])
            replays = eng.graphs.replays if eng.graphs is not None else 0
            return torch.cat(frames, dim=1), replays

        (cuda, replays), (cpu, _) = run("cuda"), run("cpu")
        equal = (cuda == cpu).all(dim=2)  # [3, steps]
        res = {"rows": 3, "steps": int(cuda.shape[1]), "replays": replays,
               "equal_frames_per_row": equal.sum(dim=1).tolist()}
        log(f"parity batch (float32, TF32 off, B3 + join_row into row 1 after step 24), card "
            f"vs CPU: {json.dumps(res)}  [{card}]")
        if not bool(equal.all()) or replays != 5:
            raise AssertionError("card and CPU disagree on the batched small model")
        return res
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# slice-serve: the OpenAI-compatible server on the continuous batcher
# ---------------------------------------------------------------------------

SERVE_B = 4
SERVE_CHUNK = 8
SERVE_STEPS = 96  # the fixed-length batcher run's budgets
SERVE_REQUESTS = 8
SERVE_BUCKETS = (32, 64, 128, 256)  # the prompts' prefill buckets (30-153 tokens)
SERVE_MAX_TTH = 64  # trailing-text widths warmed: 16 and 64
SERVE_DEPTHS = (1, 3, 3, 1)  # QWEN3TTS_BATCH_PIPELINE, in turns
SERVE_AUDIO_ATOL = 1e-4  # small float32 model, card vs CPU audio (codec float32, TF32 off)


def _http_speech(url: str, body: dict, timeout: float = 300) -> dict:
    """POST /v1/audio/speech: status, content type, ms to the first audio
    byte (past wav's 44-byte header), wall ms, and the body."""
    import urllib.request

    req = urllib.request.Request(url + "/v1/audio/speech", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t = time.time()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        skip = 44 if body.get("response_format", "wav") == "wav" else 0
        first = r.read(skip + 1)
        ttfa = (time.time() - t) * 1e3
        data = first + r.read()
        return {"status": r.status, "type": r.headers["Content-Type"], "ttfa_ms": ttfa,
                "wall_ms": (time.time() - t) * 1e3, "data": data}


def _wav_frames(res: dict, what: str) -> int:
    """A 200 wav response's whole codec frames of finite audio."""
    if res["status"] != 200 or res["type"] != "audio/wav" or res["data"][:4] != b"RIFF":
        raise AssertionError(f"{what}: {res['status']} {res['type']}")
    pcm = np.frombuffer(res["data"][44:], "<i2").astype(np.float32) / 32767.0
    if len(pcm) == 0 or len(pcm) % 2000 or not np.isfinite(pcm).all():
        raise AssertionError(f"{what}: {len(pcm)} samples, not whole frames of finite audio")
    return len(pcm) // 2000


def _concurrently(fn, args: list) -> list:
    """``fn(*a)`` for each ``a`` on threads of their own; their results in
    order (an exception in any fails the run)."""
    import threading

    out, errors = [None] * len(args), []

    def run(i, a):
        try:
            out[i] = fn(*a)
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("a request never ended")
    if errors:
        raise errors[0]
    return out


def _disconnect_and_reuse(url: str, port: int, batcher) -> dict:
    """Three long requests and one that its client abandons fill the four
    rows; a fifth queues.  When the abandoned stream's row is cancelled the
    fifth takes it: its first audio comes before the long ones end."""
    import socket
    import threading

    before = dict(batcher.stats)
    long_body = {"input": TEXT_C, "max_new_tokens": 240}
    longs, started = [], threading.Event()

    def run_long():
        longs.append(_http_speech(url, long_body))

    threads = [threading.Thread(target=run_long) for _ in range(3)]
    for t in threads:
        t.start()
    body = json.dumps({"input": TEXT_A, "response_format": "pcm",
                       "max_new_tokens": 2000}).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(b"POST /v1/audio/speech HTTP/1.1\r\nHost: t\r\n"
              b"Content-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    got = b""
    while len(got) < 4096:  # headers, then audio
        data = s.recv(65536)
        if not data:
            raise AssertionError(f"the server closed the stream after {len(got)} bytes")
        got += data
    deadline = time.time() + 30
    while batcher.stats["active_rows"] < SERVE_B and time.time() < deadline:
        time.sleep(0.01)
    queued = {}

    def run_queued():
        queued.update(_http_speech(url, {"input": "The queued request.", "max_new_tokens": 48}))
        started.set()

    q = threading.Thread(target=run_queued)
    t_submit = time.time()
    q.start()
    time.sleep(0.3)  # it waits: every row is busy
    waiting = batcher.stats["queue_depth"]
    t_close = time.time()
    s.close()  # abandon the stream
    q.join(timeout=120)
    for t in threads:
        t.join(timeout=120)
    first_long_end = min(r["wall_ms"] for r in longs)
    res = {"queue_depth_while_full": waiting,
           "cancelled": batcher.stats["cancelled"] - before["cancelled"],
           "queued_ttfa_ms": queued["ttfa_ms"],
           "queued_first_audio_after_close_ms": queued["ttfa_ms"] - (t_close - t_submit) * 1e3,
           "long_requests_wall_ms": [r["wall_ms"] for r in longs]}
    _wav_frames(queued, "the queued request")
    for r in longs:
        _wav_frames(r, "a long request")
    if res["cancelled"] != 1 or waiting != 1:
        raise AssertionError(f"the abandoned stream's row: {res}")
    if queued["ttfa_ms"] >= first_long_end:
        raise AssertionError(f"the queued request waited for a long one to end: {res}")
    return res


def _fixed_length_runs(card: str, model, ref: str) -> dict:
    """A greedy batcher (EOS suppressed) on the served engine's keys, its
    graphs recorded (``_recording``): warm-up, then SERVE_REQUESTS requests
    of SERVE_STEPS steps at each QWEN3TTS_BATCH_PIPELINE depth of
    SERVE_DEPTHS, submitted at once: served frames/s, throughput RTF, the
    launches each replay's graph holds over the steps its ``n`` says ran
    (flash-decode 28 a step), no capture after the warm-up, the busy share."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy
    from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher

    texts = _batch_texts(SERVE_REQUESTS)
    spf, res = model.vocoder.spf, {"runs": []}
    b = ContinuousBatcher(model, max_batch=SERVE_B, chunk_size=SERVE_CHUNK,
                          max_new_tokens=SERVE_STEPS,
                          policy=GenerationPolicy(do_sample=False, min_new_tokens=10_000),
                          pred_policy=SamplingPolicy(do_sample=False), first_chunks=(2, 4))
    try:
        with _recording(b.engine) as graphs:
            torch.cuda.synchronize()
            res["warmup_s"] = b.warmup(prefill_buckets=SERVE_BUCKETS, max_tth=SERVE_MAX_TTH)
            res["warmup_captures"] = graphs.captures
            with b.arriving():  # one untimed flood first: the host's first-use costs
                handles = [b.submit(x, "English", ref, "") for x in texts]
            _concurrently(lambda h: list(h.chunks()), [(h,) for h in handles])
            for depth in SERVE_DEPTHS:
                os.environ["QWEN3TTS_BATCH_PIPELINE"] = str(depth)
                graphs.log.clear()
                before = dict(b.stats)
                _zero_counts()
                torch.cuda.synchronize()
                t = time.time()
                with b.arriving():  # a flood: the batch starts full
                    handles = [b.submit(x, "English", ref, "") for x in texts]
                streams = _concurrently(lambda h: list(h.chunks()), [(h,) for h in handles])
                torch.cuda.synchronize()
                wall = time.time() - t
                eager = _launch_counts()
                replayed, steps, device_ms, per_step = _replayed(graphs)
                for i, chunks in enumerate(streams):
                    _check_audio(np.concatenate([a for a, _, _ in chunks]), SERVE_STEPS, spf,
                                 f"fixed-length request {i}")
                run = {"depth": depth, "wall_s": wall,
                       "frames_per_s": SERVE_REQUESTS * SERVE_STEPS / wall,
                       "throughput_rtf": SERVE_REQUESTS * SERVE_STEPS / 12.0 / wall,
                       "ttfa_ms": [chunks[0][2]["ttfa_ms"] for chunks in streams],
                       "served": b.stats["served"] - before["served"],
                       "joined_mid_batch": b.stats["joined_mid_batch"] - before["joined_mid_batch"],
                       "batches": b.stats["batches"] - before["batches"],
                       "replays": len(graphs.log), "steps_run": steps,
                       "launches_replayed": replayed, "launches_eager": eager,
                       "kernel_nodes_a_step": sorted({c["all"] for c in per_step}),
                       "replay_device_ms": device_ms, "busy_share": device_ms / (wall * 1e3),
                       "captures_after_warmup": graphs.captures - res["warmup_captures"]}
                bad = [c for c in per_step if c["flash_decode"] != 28
                       or any(c[k] for k in KERNELS if k != "flash_decode")]
                log(f"  fixed-length run: {json.dumps(run)}  [{card}]")
                if (run["served"] != SERVE_REQUESTS or run["joined_mid_batch"] < 1 or bad
                        or run["captures_after_warmup"] or eager["flash_decode"]
                        or replayed["flash_decode"] != 28 * steps):
                    raise AssertionError(f"the fixed-length run: {run}; steps holding {bad[:1]}")
                res["runs"].append(run)
    finally:
        os.environ.pop("QWEN3TTS_BATCH_PIPELINE", None)
        b.close()
    for depth in sorted(set(SERVE_DEPTHS)):
        fps = [r["frames_per_s"] for r in res["runs"] if r["depth"] == depth]
        res[f"depth{depth}_frames_per_s"] = fps
    return res


def _raw_batch(card: str, model, ref: str) -> dict:
    """Raw fast_generate_batch at B 4, SERVE_STEPS greedy steps over four of
    the served texts, at chunk 8 and 16 (warm-up first): frames/s."""
    from qwen3tts_tpu_torch.runtime import loops

    eng = _engine(model, batch=SERVE_B)
    prompt = model._batch_prompt(_batch_texts(SERVE_B), ref, "", "English", True, True, True,
                                 None)
    pol, ppol = _greedy()
    pol = dataclasses.replace(pol, min_new_tokens=SERVE_STEPS)
    embeds, trailing, tpe, pads, tth_lens, _ = prompt
    res = {}
    for chunk in (SERVE_CHUNK, 16):
        eng.warmup(embeds.shape[1], trailing.shape[1], pol, ppol, chunk_sizes=(chunk,))
        torch.cuda.synchronize()
        t = time.time()
        out, _ = loops.fast_generate_batch(eng, embeds, trailing, tpe, generator=None,
                                           pad_count=pads, tth_lens=tth_lens,
                                           max_new_tokens=SERVE_STEPS, policy=pol,
                                           pred_policy=ppol, device_chunk=chunk)
        torch.cuda.synchronize()
        wall = time.time() - t
        if [len(o) for o in out] != [SERVE_STEPS] * SERVE_B:
            raise AssertionError(f"raw B{SERVE_B}: rows of {[len(o) for o in out]} frames")
        res[f"chunk{chunk}"] = {"frames_per_s": SERVE_B * SERVE_STEPS / wall,
                                "throughput_rtf": SERVE_B * SERVE_STEPS / 12.0 / wall,
                                "ms_per_step": wall / SERVE_STEPS * 1e3}
    log(f"  raw fast_generate_batch B{SERVE_B}, {SERVE_STEPS} steps: {json.dumps(res)}  [{card}]")
    return res


def _server(model, registry, warm: dict):
    """``openai_server.serve`` in-process on a free port (B 4, chunk 8), its
    batcher warmed first, serving on a thread: (httpd, url, warm-up s,
    captures after the warm-up)."""
    import threading

    from qwen3tts_tpu_torch.apps import openai_server

    httpd = openai_server.serve(model, registry, host="127.0.0.1", port=0,
                                chunk_size=SERVE_CHUNK, max_batch=SERVE_B)
    batcher = httpd.tts_state.batcher
    torch.cuda.synchronize()
    warm_s = batcher.warmup(**warm)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", warm_s, _captures(batcher)


def _captures(batcher) -> int:
    """The chunk captures of the batcher's engine so far."""
    return batcher.engine.graphs.captures


def slice_serve_phase(card: str, models: dict) -> dict:
    """The OpenAI-compatible server (``apps/openai_server.py``) in-process
    on the bf16 0.6B with a 4-row continuous batcher (chunk 8, ramp 2, 4):
    warm-up; three light-load requests one after another and SERVE_REQUESTS
    concurrent streamed wav requests of mixed texts and budgets (sampled, as
    served), each 200 with whole frames, TTFA per request; served = sent,
    joins mid-batch; an mp3 request (or its 501); a client that disconnects
    while a fifth request queues; no capture after the warm-up.  Then the
    fixed-length greedy batcher runs (saturated frames/s by pipeline depth,
    launches, busy share; one untimed flood first), raw fast_generate_batch
    at B 4 beside them, and
    one request through a server on the int8 + kv_quant model (int8
    flash-decode)."""
    from qwen3tts_tpu_torch.apps.openai_server import VoiceRegistry
    from qwen3tts_tpu_torch.audio import mp3

    model, res = models["bf16"], {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        registry = VoiceRegistry.from_args(None, ref, "")
        httpd, url, warm_s, captures = _server(
            model, registry, dict(prefill_buckets=SERVE_BUCKETS, max_tth=SERVE_MAX_TTH))
        batcher = httpd.tts_state.batcher
        try:
            res["warmup_s"], res["warmup_captures"] = warm_s, captures
            log(f"  server warm-up: {warm_s:.2f} s, {captures} captures  [{card}]")
            # the voice's first request runs the speaker encoder; the
            # light-load ones after it find the voice prompt cached
            light = [_http_speech(url, {"input": TEXT_C, "max_new_tokens": 24})
                     for _ in range(4)]
            for r in light:
                _wav_frames(r, "a light-load request")
            res["first_request_ttfa_ms"] = light[0]["ttfa_ms"]
            res["light_ttfa_ms"] = [r["ttfa_ms"] for r in light[1:]]
            before = dict(batcher.stats)
            texts = _batch_texts(SERVE_REQUESTS)
            budgets = [48 + 8 * (i % 7) for i in range(SERVE_REQUESTS)]
            t = time.time()
            out = _concurrently(_http_speech, [(url, {"input": x, "max_new_tokens": n})
                                               for x, n in zip(texts, budgets)])
            wall = time.time() - t
            frames = [_wav_frames(r, f"concurrent request {i}") for i, r in enumerate(out)]
            stats = batcher.stats
            res["concurrent"] = {
                "requests": SERVE_REQUESTS, "budgets": budgets, "frames": frames,
                "ttfa_ms": [r["ttfa_ms"] for r in out], "wall_ms": [r["wall_ms"] for r in out],
                "frames_per_s": sum(frames) / wall,
                "served": stats["served"] - before["served"],
                "joined_mid_batch": stats["joined_mid_batch"] - before["joined_mid_batch"]}
            log(f"  {SERVE_REQUESTS} concurrent wav requests: {json.dumps(res['concurrent'])}"
                f"  [{card}]")
            if res["concurrent"]["served"] != SERVE_REQUESTS or \
                    res["concurrent"]["joined_mid_batch"] < 1:
                raise AssertionError(f"served {res['concurrent']}")
            res["mp3"] = {"libmp3lame": mp3.is_available(), "libmpg123": mp3.decode_available()}
            if mp3.is_available():
                r = _http_speech(url, {"input": TEXT_C, "response_format": "mp3",
                                       "max_new_tokens": 24})
                if r["status"] != 200 or r["type"] != "audio/mpeg" or len(r["data"]) < 200:
                    raise AssertionError(f"mp3: {r['status']} {r['type']} {len(r['data'])}")
                res["mp3"]["bytes"] = len(r["data"])
            else:
                import urllib.error

                try:
                    _http_speech(url, {"input": TEXT_C, "response_format": "mp3"})
                    raise AssertionError("mp3 without libmp3lame answered 200")
                except urllib.error.HTTPError as e:
                    if e.code != 501:
                        raise
                    res["mp3"]["status"] = 501
            res["disconnect"] = _disconnect_and_reuse(url, httpd.server_address[1], batcher)
            log(f"  disconnect and reuse: {json.dumps(res['disconnect'])}  [{card}]")
            res["captures_after_warmup"] = _captures(batcher) - captures
            if res["captures_after_warmup"]:
                raise AssertionError(f"{res['captures_after_warmup']} captures while serving")
        finally:
            httpd.shutdown()
            batcher.close()
        res["fixed_length"] = _fixed_length_runs(card, model, ref)
        res["raw_batch"] = _raw_batch(card, model, ref)
        httpd, url, warm_s, captures = _server(
            models["int8"], registry, dict(prefill_buckets=(128,), max_tth=16))
        try:
            r = _http_speech(url, {"input": TEXT_A, "max_new_tokens": 48})
            res["kv_quant"] = {"frames": _wav_frames(r, "the kv_quant request"),
                               "ttfa_ms": r["ttfa_ms"], "warmup_s": warm_s,
                               "kv_cache": str(httpd.tts_state.batcher.engine.new_kv()["k"].dtype),
                               "captures_after_warmup":
                                   _captures(httpd.tts_state.batcher) - captures}
            if res["kv_quant"]["captures_after_warmup"] or res["kv_quant"]["kv_cache"] != \
                    "torch.int8":
                raise AssertionError(f"kv_quant server: {res['kv_quant']}")
        finally:
            httpd.shutdown()
            httpd.tts_state.batcher.close()
        log(f"  kv_quant request (int8 weights and KV cache): {json.dumps(res['kv_quant'])}"
            f"  [{card}]")
    for m in (models["bf16"], models["int8"]):
        m._batch_engines.clear()
    return res


def serve_parity_phase(card: str) -> dict:
    """A small float32 model (talker head_dim 128), TF32 off, on the CPU and
    its ``replicate_to("cuda")``: three requests through a greedy 2-row
    batcher on the card (EOS suppressed, budgets 16, 40 and 24: the third
    joins when a row frees), each against the port's batch-1 streamed
    request on the CPU (``fast_generate_streaming_audio``, greedy, the same
    prompt); float32 codec on both, PCM16 off."""
    import threading

    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy
    from qwen3tts_tpu_torch.runtime.scheduler import ContinuousBatcher

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            os.environ.get("QWEN3TTS_SERVE_PCM16"))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["QWEN3TTS_SERVE_PCM16"] = "0"
    try:
        base = get_preset("tiny")
        cfg = dataclasses.replace(base, talker=dataclasses.replace(
            base.talker, head_dim=128, mrope_section=(24, 20, 20)))
        params = init_random(cfg, seed=6, dtype=torch.float32, device="cpu")
        cpu = FasterQwen3TTS(cfg, params, max_seq_len=256, vocoder_compute_dtype=None)
        gpu = cpu.replicate_to("cuda")
        pol = GenerationPolicy(do_sample=False, min_new_tokens=10_000)
        ppol = SamplingPolicy(do_sample=False)
        budgets = {"First utterance.": 16, "A different second text.": 40,
                   "Late third arrival.": 24}
        with tempfile.TemporaryDirectory() as tmp:
            ref = os.path.join(tmp, "ref.wav")
            _ref_wav(ref)
            cpu._voice_prompt(ref, "", True, True)
            gpu._voice_prompt_cache.update(cpu._voice_prompt_cache)  # one prompt for both
            b = ContinuousBatcher(gpu, max_batch=2, chunk_size=8, max_new_tokens=40,
                                  policy=pol, pred_policy=ppol)
            try:
                b.warmup(prefill_buckets=(32,), max_tth=16)
                handles = [b.submit(x, "English", ref, "", max_new_tokens=n)
                           for x, n in budgets.items()]
                got = _concurrently(lambda h: np.concatenate([a for a, _, _ in h.chunks()]),
                                    [(h,) for h in handles])
                joined = b.stats["joined_mid_batch"]
            finally:
                b.close()
            errs = []
            for (text, n), a in zip(budgets.items(), got):
                prompt = cpu._prepare_clone(text, ref, "", "English", True, True, True, None)
                want = np.concatenate([w for _, w, _ in loops.fast_generate_streaming_audio(
                    cpu.engine, cpu.vocoder, *prompt[:3], generator=None, max_new_tokens=n,
                    policy=pol, pred_policy=ppol, chunk_size=8)])
                if a.shape != want.shape:
                    raise AssertionError(f"{text}: card {a.shape}, CPU {want.shape}")
                errs.append(float(np.abs(a - want).max()))
        res = {"budgets": list(budgets.values()), "joined_mid_batch": joined,
               "audio_max_abs_err": errs, "tolerance": SERVE_AUDIO_ATOL}
        log(f"parity serve (float32, TF32 off, B2 batcher on the card vs batch-1 streams on "
            f"the CPU): {json.dumps(res)}  [{card}]")
        if joined < 1 or max(errs) > SERVE_AUDIO_ATOL:
            raise AssertionError("the card's served audio differs from the CPU's")
        return res
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
        if prev[2] is None:
            os.environ.pop("QWEN3TTS_SERVE_PCM16", None)
        else:
            os.environ["QWEN3TTS_SERVE_PCM16"] = prev[2]


def _voice_requests(card: str, model, prompt, call, stream, what: str, want: dict,
                    traced_steps: int) -> dict:
    """Warm-up (capture), a non-streamed and a streamed (chunk 8) request of
    STEPS steps through ``call`` / ``stream`` (no arguments but the token
    budget), then a streamed request of ``traced_steps`` whose launches are
    held to ``want`` a step (``_held_request``)."""
    sync = torch.cuda.synchronize
    steps, spf = STEPS, model.vocoder.spf
    pol, ppol = model._policies(0.9, 50, 1.0, True, 1.05, 2)
    sync()
    t = time.time()
    model._warmup(prompt[0].shape[1], prompt[1].shape[1], pol, ppol, chunk_sizes=(8, 16))
    sync()
    res = {"warmup_s": time.time() - t, "captures": model.engine.graphs.captures,
           "prompt_tokens": int(prompt[0].shape[1])}
    budget = dict(max_new_tokens=steps, min_new_tokens=steps)
    res["non_streamed"] = _timed_request(lambda: call(**budget), steps, spf,
                                         f"{what} non-streamed")
    res["streamed_chunk8"] = _streamed_request(lambda: stream(chunk_size=CHUNK, **budget),
                                               steps, CHUNK, spf, f"{what} streamed")
    res["counted_request"] = _held_request(model.engine, lambda: list(stream(
        chunk_size=CHUNK, max_new_tokens=traced_steps, min_new_tokens=traced_steps)),
        want, traced_steps, what)
    log(f"  {what}: {json.dumps(res)}  [{card}]")
    return res


def slice_voices_phase(card: str, models: dict) -> dict:
    """parity_mode=True (24 steps, streamed chunk 8) on the 0.6B beside the
    captured fast path; then, each model loaded after the last is freed,
    random:qwen3-tts-0.6b-custom (a named speaker) and
    random:qwen3-tts-1.7b-design (``instruct``), captured, non-streamed and
    streamed, STEPS steps, the kernels of a traced streamed request counted
    (flash-decode 28 a step); the 1.7B again with use_micro_kernel=True
    (a traced 48-step request: flash-decode 28 and the micro-step 14 a
    step).  Frees every model it ends with, the 0.6B ones included."""
    import gc

    res = {}
    model = models["bf16"]
    n, spf = 24, model.vocoder.spf
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        kw = dict(text=TEXT_A, language="English", ref_audio=ref, ref_text="",
                  max_new_tokens=n, min_new_tokens=n, chunk_size=CHUNK)
        res["parity_mode"] = {
            mode: _streamed_request(lambda: model.generate_voice_clone_streaming(
                parity_mode=mode == "parity", **kw), n, CHUNK, spf, f"0.6B {mode}")
            for mode in ("fast", "parity")}
    log(f"  parity_mode vs the captured fast path (0.6B bf16, {n} steps, streamed chunk 8): "
        f"{json.dumps(res['parity_mode'])}  [{card}]")
    del model
    models.clear()
    gc.collect()
    torch.cuda.empty_cache()

    for name, preset in (("custom", "qwen3-tts-0.6b-custom"),
                         ("design", "qwen3-tts-1.7b-design")):
        m = _load(preset)
        if name == "custom":
            args = (TEXT_A, sorted(m.cfg.talker.spk_id)[0], "English")
            call, stream = m.generate_custom_voice, m.generate_custom_voice_streaming
            prompt = m._custom_prompt(*args, None)
        else:
            args = (TEXT_A, INSTRUCT, "English")
            call, stream = m.generate_voice_design, m.generate_voice_design_streaming
            prompt = m._design_prompt(*args)
        out = {"load_s": m.load_s, "speaker_or_instruct": args[1]}
        out["default"] = _voice_requests(
            card, m, prompt, lambda **k: call(*args, **k), lambda **k: stream(*args, **k),
            f"{name} ({preset})", {"flash_decode": 28}, 16)
        if name == "design":
            m.engine = _engine(m, use_micro_kernel=True)
            out["micro"] = _voice_requests(
                card, m, prompt, lambda **k: call(*args, **k), lambda **k: stream(*args, **k),
                f"{name} ({preset}) use_micro_kernel", {"flash_decode": 28, "fused_micro_step": 14},
                STEPS)
        res[name] = out
        del m, call, stream
        gc.collect()
        torch.cuda.empty_cache()
    return res


CKPT_STEPS = 48  # the CLI's clone requests
FIXTURE_STEPS = 24
TRACED_STEPS = 8  # the profiled request (eager: every launch traced)


def _leaves_equal(got: dict, want: dict, what: str) -> int:
    """Every leaf of ``got`` on the card and ``torch.equal`` to ``want``'s."""
    from qwen3tts_tpu_torch.core.loader import flatten

    fa, fb = flatten(got), flatten(want)
    bad = sorted(set(fa) ^ set(fb)) or [
        k for k in fa if fa[k].device.type != "cuda" or fa[k].dtype != fb[k].dtype
        or not torch.equal(fa[k], fb[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(fa)


def _cli(*argv) -> tuple:
    """``qwen3tts_tpu_torch.apps.cli.main(argv)`` in this process: (exit
    code, stdout, stderr, seconds).  Frees the model it loaded."""
    import gc
    import io

    from qwen3tts_tpu_torch.apps import cli

    out, err, code = io.StringIO(), io.StringIO(), 0
    t = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(list(argv))
        except SystemExit as e:
            code = e.code
    torch.cuda.synchronize()
    dt = time.time() - t
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  cli {argv[0]}: exit {code} in {dt:.1f}s; {out.getvalue().strip()[-300:]}")
    return code, out.getvalue(), err.getvalue(), dt


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _wav_of(audio: np.ndarray, path: str) -> np.ndarray:
    """``audio`` as the CLI's wav holds it (16-bit PCM, read back)."""
    from qwen3tts_tpu_torch.audio.wav import read_wav, write_wav

    write_wav(path, audio, 24_000)
    return read_wav(path)[0]


def _greedy_ids(model, prompt, steps: int) -> np.ndarray:
    """The codec ids of one greedy ``_generate`` (talker and predictor
    greedy, ``steps`` pinned), read from the loop's return."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import GenerationPolicy

    real, got = loops.fast_generate, []

    def recorded(*a, **kw):
        ids, timing = real(*a, **kw)
        got.append(ids)
        return ids, timing

    loops.fast_generate = recorded
    try:
        model._generate(*prompt, GenerationPolicy(do_sample=False, min_new_tokens=steps),
                        SamplingPolicy(do_sample=False), steps)
    finally:
        loops.fast_generate = real
    if got[0].shape != (steps, 16):
        raise AssertionError(f"greedy request: ids {got[0].shape}, want ({steps}, 16)")
    return got[0]


def _traced_then_captured(card: str, model, ref: str, tmp: str) -> dict:
    """QWEN3TTS_PROFILE_DIR on the captured engine: the traced request runs
    eagerly (no ChunkGraphs.run while the profiler is active) and writes its
    trace; two untraced requests after it capture and replay; every one's
    greedy tokens equal the eager engine's."""
    graphs = model.engine.graphs
    runs, real_run = [0], graphs.run

    def counted(*a, **kw):
        runs[0] += 1
        return real_run(*a, **kw)

    graphs.run = counted
    prompt = model._prepare_clone(TEXT_A, ref, "", "English", True, True, True, None)
    prof = os.path.join(tmp, "prof")
    try:
        os.environ["QWEN3TTS_PROFILE_DIR"] = prof
        t = time.time()
        traced = _greedy_ids(model, prompt, TRACED_STEPS)
        traced_s = time.time() - t
        del os.environ["QWEN3TTS_PROFILE_DIR"]
        replays_traced = runs[0]
        captured = [_greedy_ids(model, prompt, TRACED_STEPS) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        os.environ.pop("QWEN3TTS_PROFILE_DIR", None)
        del graphs.run
    saved = model.engine
    model.engine = _engine(model)  # use_cuda_graphs=False
    try:
        eager = _greedy_ids(model, prompt, TRACED_STEPS)
    finally:
        model.engine = saved
    traces = os.listdir(prof) if os.path.isdir(prof) else []
    if replays_traced or len(traces) != 1:
        raise AssertionError(f"traced request: {replays_traced} graph replays, traces {traces}")
    if runs[0] == 0:
        raise AssertionError("the untraced requests replayed no graph")
    for name, ids in (("traced", traced), ("captured", captured[0]),
                      ("captured again", captured[1])):
        if not np.array_equal(ids, eager):
            raise AssertionError(f"{name} greedy tokens differ from the eager engine's")
    return {"traced_s": traced_s, "trace_bytes": os.path.getsize(os.path.join(prof, traces[0])),
            "replays_while_traced": replays_traced, "replays_after": runs[0],
            "greedy_steps": TRACED_STEPS, "tokens_equal_eager": True}


def slice_checkpoint_phase(card: str) -> dict:
    """Checkpoints and the CLI on the bf16 0.6B (see the module docstring,
    phase 12).  Frees every model it loads."""
    import gc
    import re

    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.core import loader

    if not logging.root.handlers:  # the CLI's basicConfig must not bind a captured stream
        logging.basicConfig(level=logging.WARNING)
    sync = torch.cuda.synchronize
    res = {"card": card}
    model = _load()
    spf = model.vocoder.spf
    with tempfile.TemporaryDirectory() as tmp:
        canon, tdir = os.path.join(tmp, "canon"), os.path.join(tmp, "torch")
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        t = time.time()
        model.save_pretrained(canon)
        res["save"] = {"s": time.time() - t, "bytes": _dir_bytes(canon)}
        sync()
        t = time.time()
        loaded = FasterQwen3TTS.from_pretrained(canon)  # no device: the card
        sync()
        res["load"] = {"s": time.time() - t, "bytes": res["save"]["bytes"],
                       "leaves": _leaves_equal(loaded.params, model.params, "canonical load")}
        t = time.time()
        loader.export_torch_checkpoint(tdir, model.cfg, loader.bundle_to_jax_layout(model.params),
                                       num_shards=3)
        res["export_torch"] = {"s": time.time() - t, "bytes": _dir_bytes(tdir),
                               "files": sorted(os.listdir(tdir))}
        code, out, _, dt = _cli("check-checkpoint", tdir)
        if code != 0 or "OK" not in out:
            raise AssertionError(f"check-checkpoint: exit {code}\n{out}")
        res["check_checkpoint"] = {"exit": code, "s": dt, "report": out.splitlines()[0]}
        sync()
        t = time.time()
        from_torch = FasterQwen3TTS.from_pretrained(tdir)
        sync()
        res["load_torch"] = {"s": time.time() - t, "leaves": _leaves_equal(
            from_torch.params, model.params, "torch-layout load")}
        del from_torch
        gc.collect()
        torch.cuda.empty_cache()

        api = dict(text=TEXT_A, language="English", ref_audio=ref, ref_text="",
                   max_new_tokens=CKPT_STEPS)
        for mode, extra in (("non_streamed", ()), ("streamed_chunk8",
                                                   ("--streaming", "--chunk-size", "8"))):
            wav = os.path.join(tmp, f"{mode}.wav")
            code, out, err, dt = _cli("clone", "--model", canon, "--ref-audio", ref,
                                      "--text", TEXT_A, "--max-new-tokens", str(CKPT_STEPS),
                                      "--seed", "0", "-o", wav, *extra)
            if code != 0:
                raise AssertionError(f"clone {mode}: exit {code}\n{err[-2000:]}")
            from qwen3tts_tpu_torch.audio.wav import read_wav

            got, sr = read_wav(wav)
            model._gen.manual_seed(0)
            if extra:
                want = np.concatenate([a for a, _, _ in model.generate_voice_clone_streaming(
                    chunk_size=8, **api)])
            else:
                want = model.generate_voice_clone(**api)[0][0]
            want = _wav_of(want, os.path.join(tmp, "want.wav"))
            if sr != 24_000 or len(got) % spf or len(got) == 0:
                raise AssertionError(f"clone {mode}: {len(got)} samples at {sr} Hz")
            if got.shape != want.shape or np.abs(got - want).max() > 1e-6:
                raise AssertionError(f"clone {mode}: the CLI's audio {got.shape} differs from "
                                     f"the API's {want.shape}")
            rtf = re.search(r"RTF ([0-9.]+)", out)
            ttfa = re.search(r"TTFA: ([0-9]+)ms", err)
            res[f"cli_clone_{mode}"] = {
                "s": dt, "frames": len(got) // spf, "rtf_printed": float(rtf.group(1)),
                "ttfa_ms_printed": float(ttfa.group(1)) if ttfa else None,
                "audio_equals_api": True}

        # the loaded model's captured path: warm it, then count a request's launches
        list(loaded.generate_voice_clone_streaming(chunk_size=CHUNK, max_new_tokens=16,
                                                   min_new_tokens=16, **{
                                                       k: v for k, v in api.items()
                                                       if k != "max_new_tokens"}))
        res["counted_request"] = _held_request(loaded.engine, lambda: list(
            loaded.generate_voice_clone_streaming(
                text=TEXT_A, language="English", ref_audio=ref, ref_text="", chunk_size=CHUNK,
                max_new_tokens=16, min_new_tokens=16)), {"flash_decode": 28}, 16,
            "from_pretrained(<dir>) bf16")

        fx, bad = os.path.join(tmp, "fx.npz"), os.path.join(tmp, "bad.npz")
        code, _, err, dt = _cli("export-fixture", "--model", canon, "--text", TEXT_A,
                                "--max-new-tokens", str(FIXTURE_STEPS), "-o", fx)
        if code != 0:
            raise AssertionError(f"export-fixture: exit {code}\n{err[-2000:]}")
        with np.load(fx) as z:
            tokens, meta = z["tokens"].copy(), z["meta"]
        tokens[FIXTURE_STEPS // 2, 3] = (tokens[FIXTURE_STEPS // 2, 3] + 1) % 2048
        np.savez(bad, tokens=tokens, meta=meta)
        res["fixture"] = {"export_s": dt, "steps": int(tokens.shape[0])}
        for name, path, want_code in (("check_pass", fx, 0), ("check_changed_token", bad, 1)):
            code, out, _, dt = _cli("check-fixture", "--model", canon, path)
            if code != want_code:
                raise AssertionError(f"check-fixture {name}: exit {code}, want {want_code}\n"
                                     f"{out}")
            res["fixture"][name] = {"exit": code, "s": dt, "line": out.strip().splitlines()[-1]}

        res["profiler"] = _traced_then_captured(card, loaded, ref, tmp)
    del model, loaded
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  slice-checkpoint: {json.dumps(res)}")
    return res



# ---------------------------------------------------------------------------
# slice-w8a8: the w8a8 modes (ops/w8a8.py, csrc/w8a8.cu) and the quality gate
# ---------------------------------------------------------------------------

W8A8_SHAPES = {  # where -> (K, N, distinct weights in the timing graph, calls a graph)
    "talker_qkv": (1024, 4096, 28, 28), "talker_o": (2048, 1024, 28, 28),
    "talker_gateup": (1024, 6144, 28, 28), "talker_down": (3072, 1024, 28, 28),
    "pred_qkv": (1024, 2048, 5, 70), "pred_o": (1024, 1024, 5, 70),
    "talker_1.7b_qkv": (2048, 4096, 28, 28)}
W8A8_ROWS = (1, 2, 4, 16)  # the GEMV kernel's rows
W8A8_LIBRARY_ROWS = (17, 64)  # quantize_act's kernel, then torch._int_mm
W8A8_TIMED_ROWS = {"talker_qkv": (1, 4, 16)}  # the others at 1 row
# a captured 0.6B step at B 1 and B 4: 28 talker layers x 4 products, and
# the predictor's 5 layers x 4 products over its 2-token prefill and 14
# micro-steps; each product a quantize_act and a GEMV
W8A8_WANT = {"flash_decode": 28, "quantize_act": 412, "w8a8_gemv": 412}
W8A8_STEPS = 48
QUALITY_STEPS = 24


def _exact(name: str, out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Tolerance 0: ``out`` must equal ``ref`` bit for bit."""
    torch.cuda.synchronize()
    if out.dtype != ref.dtype or out.shape != ref.shape or not torch.equal(out, ref):
        diff = (out.float() - ref.float()).abs().max().item() if out.shape == ref.shape else None
        raise AssertionError(f"{name} differs from its plain version at {what}: "
                             f"{out.dtype} {tuple(out.shape)} vs {ref.dtype} {tuple(ref.shape)}, "
                             f"max_abs_err {diff}")
    return 0.0


def w8a8_kernel_phase(card: str):
    """quantize_act and w8a8_gemv against their plain versions, tolerance 0:
    the 0.6B talker's four product shapes, the predictor's qkv and o, the
    1.7B talker's qkv; 1, 2, 4 and 16 rows; bf16 and float32 activations;
    two runs bit-equal.  The route above 16 rows (quantize_act's kernel,
    torch._int_mm, the epilogue) at 17 and 64 rows, also exact.  One
    captured graph of w8a8_matmul per shape, replayed after its input was
    rewritten.  Timing (bf16 activations, one call per layer in a CUDA
    graph, each layer with its own weights as a step has them: 28 talker
    layers; the predictor's 5 layers, 70 calls): the GEMV, quantize_act,
    their plain versions, the bf16 torch.matmul of the same unquantized
    shape (what the mode replaces, not the same function) and
    torch._int_mm at 17 rows (its smallest legal M): no PyTorch call
    computes the product at 16 rows or fewer."""
    from qwen3tts_tpu_torch.ops import cuda_build
    from qwen3tts_tpu_torch.ops import w8a8 as W
    from qwen3tts_tpu_torch.ops.quant import quantize_tensor

    dev = torch.device("cuda")
    sms = cuda_build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(21)
    checked, times, bounds = 0, {}, {}
    if not hasattr(torch, "_int_mm"):
        raise AssertionError("this torch has no torch._int_mm: the route above 16 rows needs it")
    for where, (K, N, layers, calls) in W8A8_SHAPES.items():
        w32 = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        qw = quantize_tensor(w32, "w8a8")
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for M in W8A8_ROWS + W8A8_LIBRARY_ROWS:
                what = f"{where} K={K} N={N} M={M} x={dname}"
                x = (torch.randn((M, K), generator=g, device=dev) * 2).to(dt)
                pq, ps = W.quantize_act_plain(x)
                ref = W.w8a8_matmul_plain(pq, ps, qw["q8"], qw["scale"], dt)
                before = (W.quantize_act.launches, W.w8a8_gemv.launches)
                y = W.w8a8_matmul(x, qw)
                routed = (W.quantize_act.launches - before[0], W.w8a8_gemv.launches - before[1])
                if routed != (1, int(M <= W.MAX_ROWS)):
                    raise AssertionError(f"w8a8_matmul at {what} launched {routed}")
                _exact("w8a8_matmul", y, ref, what)
                if M <= W.MAX_ROWS:
                    runs = []
                    for _ in range(2):
                        xq, xs = W.quantize_act(x)
                        runs.append((xq, xs, W.w8a8_gemv(xq, xs, qw["q8"], qw["scale"], dt)))
                    for (xq, xs, out) in runs:
                        _exact("quantize_act", xq, pq, what)
                        _exact("quantize_act scale", xs, ps, what)
                        _exact("w8a8_gemv", out, ref, what)
                checked += 1
        # one captured graph, replayed after its input was rewritten
        for M in (1, 4):
            xg = torch.randn((M, K), generator=g, device=dev).bfloat16()
            graph, og = _captured(lambda: W.w8a8_matmul(xg, qw))
            for _ in range(2):
                xg.copy_(torch.randn((M, K), generator=g, device=dev) * 3)
                graph.replay()
                pq, ps = W.quantize_act_plain(xg)
                _exact("w8a8_matmul graph replay", og,
                       W.w8a8_matmul_plain(pq, ps, qw["q8"], qw["scale"], torch.bfloat16),
                       f"{where} M={M}")
            del graph
        del qw

        ws = [quantize_tensor(torch.randn((K, N), generator=g, device=dev) * K ** -0.5, "w8a8")
              for _ in range(layers)]
        wb = [torch.randn((K, N), generator=g, device=dev).bfloat16() for _ in range(layers)]
        for M in W8A8_TIMED_ROWS.get(where, (1,)):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            xq, xs = W.quantize_act(x)
            pq, ps = W.quantize_act_plain(x)
            x17 = torch.randint(-127, 128, (17, K), generator=g, device=dev, dtype=torch.int8)
            t = {"w8a8_gemv": graph_ms(lambda i: W.w8a8_gemv(
                     xq, xs, ws[i % layers]["q8"], ws[i % layers]["scale"], torch.bfloat16),
                     calls),
                 "w8a8_gemv_plain": graph_ms(lambda i: W.w8a8_matmul_plain(
                     pq, ps, ws[i % layers]["q8"], ws[i % layers]["scale"], torch.bfloat16),
                     calls),
                 "quantize_act": graph_ms(lambda i: W.quantize_act(x), calls),
                 "quantize_act_plain": graph_ms(lambda i: W.quantize_act_plain(x), calls),
                 "bf16_matmul": graph_ms(lambda i: torch.matmul(x, wb[i % layers]), calls),
                 "int_mm_17": graph_ms(lambda i: torch._int_mm(x17, ws[i % layers]["q8"]),
                                       calls)}
            times[(where, M)] = t
            bounds[(where, M)] = {
                "w8a8_gemv": bound(K * N + M * K + 4 * M + 4 * N + 2 * M * N, 2 * M * K * N,
                                   torch.int8),
                "quantize_act": bound(2 * M * K + M * K + 4 * M, 2 * M * K, torch.float32),
                "bf16_matmul": bound(2 * K * N + 2 * M * K + 2 * M * N, 2 * M * K * N,
                                     torch.bfloat16)}
            log(f"  timing w8a8 {where} K={K} N={N} M={M} (mt, vec, splits "
                f"{W.gemv_geometry(M, K, N, sms)}): "
                + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in t.items())
                + f"; bound gemv {bounds[(where, M)]['w8a8_gemv'][0] * 1e3:.2f} us, "
                f"quantize_act {bounds[(where, M)]['quantize_act'][0] * 1e3:.3f} us, bf16 "
                f"matmul {bounds[(where, M)]['bf16_matmul'][0] * 1e3:.2f} us  [{card}]")
        del ws, wb
    log(f"  w8a8: {checked} (shape, rows, dtype) cases bit-equal to the plain versions "
        f"(tolerance 0), two runs equal, {len(W8A8_SHAPES) * 2} captured graphs replayed  "
        f"[{card}]")
    return {"quantize_act": 0.0, "w8a8_gemv": 0.0}, times, bounds


@contextlib.contextmanager
def _recorded_activations(engine, log_: list):
    """Every quantize_act's (step, xq, xs) on the host, in call order, while
    ``engine`` runs eagerly (step 0 is the prefill; ``_one_step`` counts the
    rest): the card's kernel wrapper and the CPU's plain version."""
    from qwen3tts_tpu_torch.ops import w8a8

    real = {name: getattr(w8a8, name) for name in ("quantize_act", "quantize_act_plain")}
    step = [0]
    one_step = engine._one_step

    def counted(*a, **kw):
        step[0] += 1
        return one_step(*a, **kw)

    def recorder(fn):
        def rec(x):
            xq, xs = fn(x)
            log_.append((step[0], xq.reshape(-1, xq.shape[-1]).cpu(), xs.reshape(-1).cpu()))
            return xq, xs
        rec.launches = 0  # the wrapper counts its launches on the module's name: this one
        return rec

    engine._one_step = counted
    for name, fn in real.items():
        setattr(w8a8, name, recorder(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(w8a8, name, fn)
        del engine._one_step


def parity_w8a8_phase(card: str):
    """The parity phase's small float32 model with a w8a8 bundle (quantized
    on the CPU, talker hidden 128), TF32 off, greedy, a 20-token prompt (the
    prefill takes the torch._int_mm route), 33 frames: the captured engine
    on the card (the w8a8 kernels) against the eager engine on the CPU (the
    plain versions).  Each product quantizes its activation row to int8, so
    a last-bit difference in a float32 sum elsewhere (flash-decode, cuBLAS)
    can flip one rounding, and from there the greedy chain may move: the
    card's frames are held equal to the CPU's through every step before the
    first activation whose int8 rounding differs, and that first difference
    to one step of one in the int8 values.  The activations come from the
    card's engine run eagerly with every quantize_act recorded (its frames
    must equal the captured run's) and from the CPU's run."""
    from qwen3tts_tpu_torch.core.loader import init_random
    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.ops import w8a8
    from qwen3tts_tpu_torch.ops.quant import quantize_bundle
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = get_preset("tiny")
        # the parity phase's talker at hidden 128: every K of its products is
        # at least 128, which torch._int_mm needs for the 20-row prefill
        talker = dataclasses.replace(base.talker, head_dim=128, mrope_section=(24, 20, 20),
                                     hidden_size=128, text_hidden_size=128,
                                     speaker_embed_dim=128)
        cfg = dataclasses.replace(base, talker=talker)
        params = quantize_bundle(init_random(cfg, seed=6, dtype=torch.float32, device="cpu"),
                                 "w8a8")
        H = cfg.talker.hidden_size
        rng = np.random.default_rng(7)
        embeds = rng.standard_normal((1, 20, H)).astype(np.float32) * 0.1
        tth = torch.from_numpy(rng.standard_normal((1, 16, H)).astype(np.float32) * 0.1)
        tpe = torch.from_numpy(rng.standard_normal((1, 1, H)).astype(np.float32) * 0.1)

        def move(t, dev):
            return ({k: move(v, dev) for k, v in t.items()} if isinstance(t, dict)
                    else [move(v, dev) for v in t] if isinstance(t, list) else t.to(dev))

        def frames_of(device, graphs, acts=None):
            p = move(params, device)
            eng = Engine(p["talker"], p["predictor"], cfg, max_seq_len=128,
                         use_cuda_graphs=graphs)
            with (_recorded_activations(eng, acts) if acts is not None
                  else contextlib.nullcontext()):
                state = eng.prefill(embeds, None, GenerationPolicy(do_sample=False,
                                                                   min_new_tokens=99),
                                    SamplingPolicy(do_sample=False))
                out = [state["token"][:, None].expand(1, 16).cpu()]
                for _ in range(4):
                    _, f, n, lens, _ = eng.decode_chunk(state, tth.to(device), 7,
                                                        tpe.to(device), 8)
                    out.append(f[0, : int(lens[0])].cpu())
            return torch.cat(out)

        before = (w8a8.quantize_act.launches, w8a8.w8a8_gemv.launches)
        captured = frames_of("cuda", True)
        launched = (w8a8.quantize_act.launches - before[0], w8a8.w8a8_gemv.launches - before[1])
        card_acts, cpu_acts = [], []
        eager = frames_of("cuda", False, card_acts)
        cpu = frames_of("cpu", False, cpu_acts)
        if not torch.equal(eager, captured):
            raise AssertionError("w8a8: captured and eager frames differ on the card")
        if len(card_acts) != len(cpu_acts):
            raise AssertionError(f"w8a8: {len(card_acts)} quantized activations on the card, "
                                 f"{len(cpu_acts)} on the CPU")
        # the first product whose int8 rounding differs (a scale xs that
        # differs in its last bits while every xq is equal is a float32
        # difference like any other: the chain stays continuous through it)
        first = next(((i, s) for i, ((s, q, _), (_, q2, _)) in enumerate(
            zip(card_acts, cpu_acts)) if not torch.equal(q, q2)), None)
        upto = len(cpu_acts) if first is None else first[0]
        xs_rel = max([((x - x2).abs() / x2).max().item()
                      for (_, _, x), (_, _, x2) in zip(card_acts[:upto], cpu_acts[:upto])],
                     default=0.0)
        equal = (captured == cpu).all(dim=1)
        first_frame = None if bool(equal.all()) else int(torch.argmin(equal.int()))
        # per step up to the first differing frame: products whose rounding
        # differs, entries that differ, by how much at most
        per_step = {}
        for (st, q, _), (_, q2, _) in zip(card_acts, cpu_acts):
            d = (q.int() - q2.int()).abs()
            if d.any() and st <= (first_frame if first_frame is not None else st):
                e = per_step.setdefault(st, [0, 0, 0])
                e[0], e[1], e[2] = e[0] + 1, e[1] + int((d > 0).sum()), max(e[2], int(d.max()))
        held = len(cpu) if first is None else first[1]  # frames before the step of the first
        flip = {}
        if first is not None:
            _, q, x = card_acts[first[0]]
            _, q2, x2 = cpu_acts[first[0]]
            d = (q.int() - q2.int()).abs()
            flip = {"product": first[0], "step": first[1], "entries": int((d > 0).sum()),
                    "most": int(d.max()), "scale_rel_diff": ((x - x2).abs() / x2).max().item()}
        log(f"parity w8a8 (float32, TF32 off): captured card vs eager CPU, {int(equal.sum())} "
            f"of {len(equal)} greedy frames equal, first differing frame {first_frame}; "
            f"{len(cpu_acts)} quantized activation rows, the first whose int8 rounding "
            f"differs: {json.dumps(flip) if flip else None} (frames held equal before its step: "
            f"{held}; the scales before it differ by at most {xs_rel:.2e} relative); steps with "
            f"a differing rounding up to that frame (products, entries, most): "
            f"{json.dumps(per_step)}; "
            f"eager launches on the card (prefill, the captures' steps) quantize_act "
            f"{launched[0]}, w8a8_gemv {launched[1]}  [{card}]")
        if not torch.equal(captured[:held], cpu[:held]):
            raise AssertionError(f"w8a8: card and CPU frames differ at frame {first_frame}, "
                                 f"before the first differing activation rounding (step {held})")
        if xs_rel > 1e-4:
            raise AssertionError(f"w8a8: activation scales differ by {xs_rel:.2e} relative "
                                 "before any int8 rounding did (float32 order: want <= 1e-4)")
        if flip and flip["most"] > 1:
            raise AssertionError(f"w8a8: the first differing activation rounding moved by "
                                 f"{flip['most']}, want one step")
        if launched[0] <= launched[1] or launched[1] == 0:
            raise AssertionError(f"w8a8 parity did not run both routes: launches {launched}")
        return {"frames_equal": int(equal.sum()), "frames": len(equal), "held": held,
                "first_flip": flip, "scale_rel_diff_before": xs_rel, "flips_by_step": per_step}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _w8a8_prefill(model, rows: int) -> dict:
    """The eager talker prefill's w8a8 launches: 4 products a layer, each a
    quantize_act and then the GEMV kernel (16 rows or fewer) or
    torch._int_mm (not counted: a library call)."""
    n = 4 * model.cfg.talker.num_hidden_layers
    return {"quantize_act": n, "w8a8_gemv": n if rows <= 16 else 0}


def _timed_clone(model, ref: str, steps: int, what: str) -> dict:
    """A non-streamed request of ``steps`` steps after the model's warm-up."""
    kw = dict(language="English", ref_audio=ref, ref_text="", max_new_tokens=steps,
              min_new_tokens=steps)
    torch.cuda.synchronize()
    t = time.time()
    model.generate_voice_clone(text=TEXT_C, **kw)  # captures
    torch.cuda.synchronize()
    first = time.time() - t
    t = time.time()
    wavs, _ = model.generate_voice_clone(text=TEXT_A, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t
    _check_audio(wavs[0], steps, model.vocoder.spf, what)
    return {"first_request_s": first, "ms_per_step": wall / steps * 1e3,
            "rtf": steps / 12.0 / wall}


def slice_w8a8_phase(card: str, models: dict) -> dict:
    """The w8a8 modes on random:qwen3-tts-0.6b (bf16) through the API with
    captured chunks: quantize="w8a8" (warm-up, a non-streamed and a streamed
    48-step request, a counted streamed request: flash-decode 28,
    quantize_act 412 and w8a8_gemv 412 kernel nodes a step, read from the
    graphs); one request each with "w8a8-talker" and "w8a8-predictor"; a
    B 4 fast_generate_batch of 48 steps (4 rows a product; the prefill's
    rows above 16 take torch._int_mm); then the quality gate at 24 steps,
    quant_quality(bf16, w8a8) and quant_quality(bf16, int8): teacher-forced
    logit MSE and argmax-flip rates, the vocoder's SNR on identical codes
    (99.0: the codec is never quantized), and the free-running divergence."""
    import gc

    from qwen3tts_tpu_torch.utils.quality import quant_quality

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        _ref_wav(ref)
        model = _load(quantize="w8a8")
        rows = model._prepare_clone(TEXT_A, ref, "", "English", True, True, True,
                                    None)[0].shape[1]
        res["w8a8"] = _graph_requests(model, ref, W8A8_WANT, card, "w8a8 captured",
                                      steps=W8A8_STEPS, per_request=_w8a8_prefill(model, rows))
        res["w8a8"]["load_s"] = model.load_s
        B = 4
        prompt = model._batch_prompt(_batch_texts(B), ref, "", "English", True, True, True,
                                     None)
        res["w8a8_B4"] = _batch_throughput(
            card, model, ref, "w8a8", B, {}, W8A8_WANT, steps=W8A8_STEPS,
            per_request=_w8a8_prefill(model, B * prompt[0].shape[1]))
        model._batch_engines.clear()
        for mode in ("w8a8-talker", "w8a8-predictor"):
            one = _load(quantize=mode)
            res[mode] = _timed_clone(one, ref, W8A8_STEPS, mode)
            log(f"  {mode}: {json.dumps(res[mode])}  [{card}]")
            del one
            gc.collect()
            torch.cuda.empty_cache()

        # slice-voices frees the phases' models before it loads its own
        bf16 = models.get("bf16") or _load()
        bf16.engine = _engine(bf16)
        quality = {}
        for name, q in (("w8a8", model), ("int8", None)):
            q = q or _load(quantize="int8")
            t = time.time()
            quality[name] = quant_quality(bf16, q, text=TEXT_A, ref_audio=ref, ref_text="",
                                          steps=QUALITY_STEPS)
            quality[name]["seconds"] = time.time() - t
            log(f"  quant_quality(bf16, {name}), {QUALITY_STEPS} steps: "
                f"{json.dumps(quality[name])}  [{card}]")
            if quality[name]["teacher_forced"]["vocoder_snr_db"] != 99.0:
                raise AssertionError(f"{name}: the vocoder's SNR on identical codes is "
                                     f"{quality[name]['teacher_forced']['vocoder_snr_db']}, "
                                     "want 99.0")
            del q
        res["quality"] = quality
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


DEMO_MODEL = "random:qwen3-tts-0.6b"
DEMO_MODELS = [DEMO_MODEL, "random:tiny", "random:qwen3-tts-0.6b-custom"]
DEMO_STEPS = 96  # max_new_tokens of each streamed demo request (chunk 8, ramp 2, 4)
DEMO_WARM = 3  # warm streamed requests after the one that captures
DEMO_TEXT = "The demo streams this sentence while the page shows its TTFA and RTF."
ASR_CER_BOUND = 0.08  # the JAX gate's bound on the committed clips' mean CER (tests/test_asr.py)


def _demo_post(url: str, path: str, body, ctype="application/json", timeout: float = 300):
    """POST to the demo: (status, parsed JSON, wall ms)."""
    import urllib.request

    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": ctype},
                                 method="POST")
    t = time.time()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), (time.time() - t) * 1e3


def _demo_stream(url: str, body: dict, what: str) -> dict:
    """POST /generate/stream and read its server-sent events as they come:
    the events must be ``chunk`` ... ``done``, every chunk a wav of whole
    codec frames of finite audio.  Returns the server's ``ttfa_ms`` on the
    first chunk, the client's ms to that event, the last chunk's ``rtf``
    and ``total_audio_s``, the event count, frames and wall ms."""
    import base64
    import urllib.request

    from qwen3tts_tpu_torch.audio.wav import read_wav

    req = urllib.request.Request(url + "/generate/stream", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    events, client_ms = [], None
    t = time.time()
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200 or r.headers["Content-Type"] != "text/event-stream":
            raise AssertionError(f"{what}: {r.status} {r.headers['Content-Type']}")
        for line in r:
            if not line.startswith(b"data: "):
                continue
            e = json.loads(line[6:])
            if client_ms is None and e["event"] == "chunk":
                client_ms = (time.time() - t) * 1e3
            events.append(e)
    wall = (time.time() - t) * 1e3
    kinds = [e["event"] for e in events]
    if len(kinds) < 2 or kinds[-1] != "done" or set(kinds[:-1]) != {"chunk"}:
        raise AssertionError(f"{what}: events {kinds[:3]} ... {kinds[-2:]} "
                             f"{events[-1] if events else ''}")
    frames = 0
    for i, e in enumerate(events[:-1]):
        audio, sr = read_wav(base64.b64decode(e["wav_b64"]))
        if (e["chunk_index"] != i or sr != 24_000 or len(audio) == 0 or len(audio) % 2000
                or not np.isfinite(audio).all()):
            raise AssertionError(f"{what}: chunk {i}: {len(audio)} samples at {sr} Hz, "
                                 "not whole frames of finite audio")
        frames += len(audio) // 2000
    last = events[-2]
    if not 0 < frames <= body["max_new_tokens"] or events[-1]["total_audio_s"] != round(
            frames * 2000 / 24_000, 2):
        raise AssertionError(f"{what}: {frames} frames, done says {events[-1]}")
    return {"ttfa_ms": events[0]["ttfa_ms"], "client_first_chunk_ms": client_ms,
            "rtf": last["rtf"], "total_audio_s": last["total_audio_s"], "events": len(events),
            "frames": frames, "wall_ms": wall}


def _chunk_steps(frames: int, budget: int, chunk: int, ramp: tuple) -> int:
    """The steps a streamed request's chunks run for ``frames`` frames: up to
    an EOS the frames themselves (a chunk stops when its row is done); at the
    budget, every step of the chunks dispatched to reach it (``ramp``, then
    ``chunk`` each), the last one's steps past the budget trimmed from its
    audio but run (``runtime/loops.py:_chunk_iter``)."""
    if frames < budget:
        return frames
    sizes, steps = list(ramp), 0
    while steps < budget:
        steps += sizes.pop(0) if sizes else chunk
    return steps


def _demo_requests(url: str, engine, body: dict, card: str) -> dict:
    """The streamed clone requests of the demo's model, under ``_recording``
    on its engine: the first one (it captures its chunks: the API's warm-up
    captures chunks 2, 4 and 8 and runs each once), then DEMO_WARM warm ones
    (replays only), then a non-streamed /generate.  Each streamed request
    runs with the launch counters set to 0 just before it and read just
    after; each replay's launches are read from its graph.  Every captured
    step must hold flash-decode 28 and no other counted kernel, the eager
    launches must be one step's for each capture, and a warm request's
    replays must have run the steps its chunks were dispatched for
    (``_chunk_steps``; the first request's also ran the warm-up's)."""
    import base64

    from qwen3tts_tpu_torch.audio.wav import read_wav

    want = {k: 28 if k == "flash_decode" else 0 for k in KERNELS}
    res = {"warm": []}
    with _recording(engine) as graphs:
        for i in range(1 + DEMO_WARM):
            what = "first streamed request (captures)" if i == 0 else f"warm request {i}"
            graphs.log.clear()
            captures = graphs.captures
            torch.cuda.synchronize()
            _zero_counts()  # the main path's run starts here
            out = _demo_stream(url, body, what)
            torch.cuda.synchronize()
            eager = _launch_counts()  # ... and ends here
            replayed, steps, device_ms, per_step = _replayed(graphs)
            warm = graphs.captures - captures
            bad = [c for c in per_step if {k: c[k] for k in KERNELS} != want]
            want_steps = _chunk_steps(out["frames"], body["max_new_tokens"], CHUNK, (2, 4))
            if (bad or steps < want_steps or (i and steps != want_steps)
                    or replayed != {k: v * steps for k, v in want.items()}
                    or eager != {k: v * warm for k, v in want.items()}):
                raise AssertionError(
                    f"{what}: {steps} steps replayed for {out['frames']} frames, launches "
                    f"{replayed} from the graphs and {eager} eagerly ({warm} captures), "
                    f"captured steps holding {bad[:1]}; want flash_decode 28 a step")
            out.update(steps=steps, request_steps=want_steps, captures=warm,
                       replays=len(graphs.log),
                       launches={k: eager[k] + replayed[k] for k in KERNELS},
                       flash_decode_a_step=replayed["flash_decode"] / steps,
                       kernel_nodes_a_step=sorted({c["all"] for c in per_step}),
                       replay_device_ms=device_ms, busy_share=device_ms / out["wall_ms"])
            if i == 0:
                res["first"] = out
                log(f"  first streamed request (captures chunks 2, 4, 8): {json.dumps(out)}"
                    f"  [{card}]")
            else:
                res["warm"].append(out)
                log(f"  warm streamed request: {json.dumps(out)}  [{card}]")
        status, body_, ms = _demo_post(url, "/generate", body)
    if status != 200 or set(body_) != {"wav_b64", "duration_s", "wall_s", "rtf"}:
        raise AssertionError(f"/generate: {status} {sorted(body_)}")
    audio, sr = read_wav(base64.b64decode(body_["wav_b64"]))
    if (sr != 24_000 or len(audio) == 0 or len(audio) % 2000 or not np.isfinite(audio).all()
            or body_["duration_s"] != round(len(audio) / sr, 2)):
        raise AssertionError(f"/generate: {len(audio)} samples at {sr} Hz, "
                             f"{body_['duration_s']} s")
    res["non_streamed"] = {"duration_s": body_["duration_s"], "wall_s": body_["wall_s"],
                           "rtf": body_["rtf"], "client_ms": ms, "frames": len(audio) // 2000}
    log(f"  /generate (non-streamed): {json.dumps(res['non_streamed'])}  [{card}]")
    return res


def _param_bytes(tree) -> int:
    from qwen3tts_tpu_torch.core.loader import flatten

    return sum(t.numel() * t.element_size() for t in flatten(tree).values()
               if isinstance(t, torch.Tensor))


def _demo_evict(url: str, state, card: str) -> dict:
    """MODEL_CACHE_SIZE 2: /load random:tiny, then /load the 0.6B custom
    model, which evicts the 0.6B.  The eviction (under the generation
    lock) must give back at least 90 % of the 0.6B's parameter
    bytes; then one streamed request on the custom model (a named speaker)."""
    import gc

    from qwen3tts_tpu_torch.apps import demo_server

    demo_server.MODEL_CACHE_SIZE = 2
    param_bytes = _param_bytes(state.model_cache[DEMO_MODEL].params)  # no reference kept
    _demo_post(url, "/load", {"model": "random:tiny"})
    gc.collect()  # the earlier phases' garbage: the release below then frees the 0.6B's alone
    torch.cuda.synchronize()
    res = {"param_bytes_0.6b": param_bytes, "allocated_before_load": torch.cuda.memory_allocated()}
    released = []

    def evict():  # the server's eviction, with the allocator's bytes around it
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        real()
        torch.cuda.synchronize()
        released.append((before, torch.cuda.memory_allocated()))

    real, state.evict_lru = state.evict_lru, evict
    try:
        _, body, load_ms = _demo_post(url, "/load", {"model": "random:qwen3-tts-0.6b-custom"})
    finally:
        del state.evict_lru  # the class's own method again
    torch.cuda.synchronize()
    if body["cached"] != ["random:tiny", "random:qwen3-tts-0.6b-custom"] or len(released) != 1:
        raise AssertionError(f"eviction: cache {body['cached']}, releases {released}")
    before, after = released[0]
    res.update(load_custom_ms=load_ms, allocated_before_release=before,
               allocated_after_release=after, returned_bytes=before - after,
               returned_share=(before - after) / param_bytes,
               allocated_after_load=torch.cuda.memory_allocated())
    log(f"  eviction: {json.dumps(res)}  [{card}]")
    if before - after < 0.9 * param_bytes:
        raise AssertionError(f"eviction returned {before - after} bytes, under 90 % of the "
                             f"0.6B's {param_bytes} parameter bytes")
    speaker = sorted(state.model_cache["random:qwen3-tts-0.6b-custom"].cfg.talker.spk_id)[0]
    res["custom_request"] = _demo_stream(url, {
        "mode": "custom", "model": "random:qwen3-tts-0.6b-custom", "text": DEMO_TEXT,
        "speaker": speaker, "chunk_size": CHUNK, "max_new_tokens": DEMO_STEPS},
        "custom voice after the eviction")
    res["custom_request"]["speaker"] = speaker
    log(f"  custom voice ({speaker}), streamed: {json.dumps(res['custom_request'])}  [{card}]")
    return res


def _demo_transcribe(url: str, hook, card: str) -> dict:
    """The 16 committed clips through /transcribe (the builtin recognizer on
    the card, the committed checkpoint): the mean CER within ASR_CER_BOUND
    of the recorded figure and below 0.7; the port's recognizer on the CPU
    gives each clip's transcript too (all must be equal), and the logits'
    card-vs-CPU max abs error with cuDNN's TF32 as it is (on by default)
    and off; the warm ms of a transcription over HTTP and in the process."""
    from qwen3tts_tpu_torch.audio.wav import read_wav
    from qwen3tts_tpu_torch.models import asr

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "asr")
    manifest = json.load(open(os.path.join(root, "manifest.json")))
    recorded = json.load(open(os.path.join(root, "metrics.json")))[
        "eval_cer_heldout_perturbation"]
    card_rec = hook.__self__  # the recognizer behind the server's hook
    cpu_rec = asr.CTCRecognizer.from_pretrained(asr.default_checkpoint(), device="cpu")
    clips = []
    for e in manifest:
        with open(os.path.join(root, e["wav"]), "rb") as f:
            data = f.read()
        clips.append((e["text"], data, *read_wav(data)))
    http_ms, scores, card_text, cpu_text = [], [], [], []
    for ref, data, _, _ in clips:
        status, body, ms = _demo_post(url, "/transcribe", data, "audio/wav")
        if status != 200:
            raise AssertionError(f"/transcribe: {status} {body}")
        http_ms.append(ms)
        card_text.append(body["text"])
        scores.append(asr.cer(ref, body["text"]))
    t = time.time()
    for _, _, wav, sr in clips:
        cpu_text.append(cpu_rec.transcribe(wav, sr))
    cpu_ms = (time.time() - t) * 1e3 / len(clips)
    torch.cuda.synchronize()
    t = time.time()
    for _, _, wav, sr in clips:
        card_rec.transcribe(wav, sr)
    card_ms = (time.time() - t) * 1e3 / len(clips)
    err = {}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for name, tf32 in (("cudnn_tf32_default", prev), ("cudnn_tf32_off", False)):
            torch.backends.cudnn.allow_tf32 = tf32
            diffs, same = [], 0
            for _, _, wav, sr in clips:
                a, b = card_rec.logits(wav, sr), cpu_rec.logits(wav, sr)
                diffs.append(float(np.abs(a - b).max()))
                same += asr.greedy_ctc_decode(a.argmax(-1)) == asr.greedy_ctc_decode(b.argmax(-1))
            err[name] = {"allow_tf32": tf32, "logit_max_abs_err": max(diffs),
                         "transcripts_equal": same}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    mean = float(np.mean(scores))
    res = {"clips": len(clips), "mean_cer": mean, "recorded_cer": recorded,
           "transcripts_equal_cpu": sum(a == b for a, b in zip(card_text, cpu_text)),
           "card_vs_cpu": err, "http_ms_first": http_ms[0],
           "http_ms_warm_mean": float(np.mean(http_ms[1:])), "card_ms_warm": card_ms,
           "cpu_ms": cpu_ms}
    log(f"  /transcribe, 16 committed clips: {json.dumps(res)}  [{card}]")
    if res["transcripts_equal_cpu"] != len(clips):
        raise AssertionError(f"card transcripts differ from the CPU's: "
                             f"{[(a, b) for a, b in zip(card_text, cpu_text) if a != b]}")
    if not (abs(mean - recorded) < ASR_CER_BOUND and mean < 0.7):
        raise AssertionError(f"mean CER {mean} against the recorded {recorded}")
    return res


def slice_demo_phase(card: str) -> dict:
    """The web demo (``apps/demo_server.py``) in the process on a free port,
    with the builtin recognizer (the committed checkpoint) on the card:
    /status names cuda:0; /load of the bf16 0.6B, then streamed clone
    requests (``preset_low``, chunk 8, ramp 2, 4, DEMO_STEPS), each counted
    (flash-decode 28 a step): one that captures, DEMO_WARM warm ones; a
    non-streamed /generate (``_demo_requests``); the eviction
    (``_demo_evict``); the 16 committed clips through /transcribe
    (``_demo_transcribe``).  Shuts the server down and frees its models."""
    import gc
    import threading
    import urllib.request

    from qwen3tts_tpu_torch.apps import demo_server

    res = {}
    t = time.time()
    hook = demo_server.resolve_asr("builtin", device="cuda")
    res["asr_load_s"] = time.time() - t
    httpd, state = demo_server.serve(models=DEMO_MODELS, dtype="bf16", host="127.0.0.1",
                                     port=0, asr=hook, device="cuda")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/status", timeout=60) as r:
            status = json.loads(r.read())
        if "cuda:0" not in status["device_memory"] or status["available_models"] != DEMO_MODELS:
            raise AssertionError(f"/status: {status}")
        res["status_keys"] = sorted(status)
        _, body, res["load_ms"] = _demo_post(url, "/load", {"model": DEMO_MODEL})
        if body != {"ok": True, "cached": [DEMO_MODEL]}:
            raise AssertionError(f"/load: {body}")
        req = {"mode": "clone", "model": DEMO_MODEL, "text": DEMO_TEXT,
               "preset_ref": "preset_low", "chunk_size": CHUNK, "max_new_tokens": DEMO_STEPS}
        res.update(_demo_requests(url, state.model_cache[DEMO_MODEL].engine, req, card))
        res["eviction"] = _demo_evict(url, state, card)
        res["transcribe"] = _demo_transcribe(url, hook, card)
    finally:
        httpd.shutdown()
        httpd.server_close()
        with state.gen_lock:
            state.model_cache.clear()
        del state, hook
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# slice-shard: tensor-parallel serving (parallel/sharding.py)
# ---------------------------------------------------------------------------

# (KVH, NH) of one rank's talker at TP 2 and at TP 4: group 2, head_dim 128
RANK_FLASH_LAYOUTS = ((4, 8), (2, 4))
RANK_FLASH_CASES = [(27, 300, 0, None), (13, 2000, 0, None), (5, 2000, 1990, None),
                    (11, 1500, 0, 300), (2, 40, 100, None)]


def rank_flash_phase(card: str) -> dict:
    """Flash-decode at one rank's head count under TP 2 (8 heads over 4 kv
    heads) and TP 4 (4 over 2), the 0.6B's 28 layers, 2048 slots and
    head_dim 128: float (bf16 and float32 q) and int8 caches against the
    plain version (RANK_FLASH_CASES, at the kernel phase's tolerances;
    pad past pos gives exact zeros), then timed at pos 300 and 2000 (28
    calls a graph, one a layer, CUDA events; one cache stack) beside the
    bound and, for the float cache, SDPA with ``enable_gqa`` over the same
    live slice."""
    import torch.nn.functional as F

    from qwen3tts_tpu_torch.models.layers import _quantize_rows
    from qwen3tts_tpu_torch.ops import cuda_build
    from qwen3tts_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    L, B, S, D = 28, 1, 2048, 128

    def ints(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    out = {}
    for KVH, NH in RANK_FLASH_LAYOUTS:
        g = torch.Generator(device=dev).manual_seed(KVH)
        k32 = torch.randn((L, B, S, KVH, D), generator=g, device=dev)
        v32 = torch.randn((L, B, S, KVH, D), generator=g, device=dev)
        q32 = torch.randn((B, NH, D), generator=g, device=dev)
        kq, ks = _quantize_rows(k32)
        vq, vs = _quantize_rows(v32)
        ks, vs = (t.transpose(-1, -2).contiguous() for t in (ks, vs))  # [L, B, KVH, S]
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        runs = {"bf16": (qb, kb, vb, (), BF16_TOL), "f32": (q32, k32, v32, (), F32_TOL),
                "int8kv bf16": (qb, kq, vq, (ks, vs), BF16_TOL),
                "int8kv f32": (q32, kq, vq, (ks, vs), F32_TOL)}
        errs = {}
        for name, (qq, kk, vv, scales, tol) in runs.items():
            errs[name] = 0.0
            for layer, pos, pad, window in RANK_FLASH_CASES:
                args = (qq, kk, vv, layer, ints(pos), ints(pad), window, *scales)
                o = fd.flash_decode(*args)
                errs[name] = max(errs[name], _held(
                    f"flash-decode {NH}/{KVH} heads {name}", o, fd.flash_decode_plain(*args), tol,
                    f"layer={layer} pos={pos} pad={pad} window={window}"))
                if pad > pos and o.abs().max().item() != 0.0:
                    raise AssertionError("pad > pos must give exact zeros")
        res = {"splits": fd.num_splits(S, B, KVH, cuda_build.sm_count(dev)),
               "max_abs_err": errs, "us": {}, "plain_us": {}, "bound_us": {},
               "library_us": {}}
        zero = ints(0)
        qs = qb[:, :, None, :]

        def sdpa(i, live):  # the library yardstick, as the kernel phase times it
            return F.scaled_dot_product_attention(
                qs, kb[i, :, :live].transpose(1, 2), vb[i, :, :live].transpose(1, 2),
                enable_gqa=True)[:, :, 0]

        for cache, (qq, kk, vv, scales, _) in (("float", runs["bf16"]),
                                              ("int8kv", runs["int8kv bf16"])):
            for pos in (300, 2000):
                p = ints(pos)
                t_k = graph_ms(lambda i: fd.flash_decode(qq, kk, vv, i, p, zero, None, *scales), L)
                t_p = graph_ms(lambda i: fd.flash_decode_plain(qq, kk, vv, i, p, zero, None,
                                                               *scales), L)
                per_slot = KVH * (D * kk.element_size() + (4 if scales else 0))
                b = bound(nbytes(qq, qq) + 2 * (pos + 1) * per_slot, 4 * NH * (pos + 1) * D,
                          torch.int8 if scales else qq.dtype)
                key = f"{cache} pos={pos}"
                res["us"][key], res["plain_us"][key], res["bound_us"][key] = (
                    t_k * 1e3, t_p * 1e3, b[0] * 1e3)
                lib = ""
                if not scales:  # SDPA reads no int8 cache
                    res["library_us"][key] = graph_ms(lambda i: sdpa(i, pos + 1), L) * 1e3
                    lib = f", SDPA (enable_gqa) {res['library_us'][key]:.2f}"
                log(f"  flash-decode {NH}/{KVH} heads {key}: kernel {t_k * 1e3:.2f} us/call, "
                    f"plain {t_p * 1e3:.2f}{lib}, bound {b[0] * 1e3:.3f} us ({b[1]}), "
                    f"{KVH} x {res['splits']} CTAs  [{card}]")
        out[f"{NH}/{KVH}"] = res
    return out


def set_condition_phase(card: str) -> dict:
    """``set_condition`` (``csrc/graph_cond.cu``), the one-thread kernel that
    sets a captured step's IF-node predicate: 64 IF nodes with empty bodies
    in one graph, their predicate true, replayed and timed with CUDA
    events; a node's time is its kernel's launch plus the node's branch.
    Its bound: the bool read and the 32-bit condition written."""
    from qwen3tts_tpu_torch.runtime.graphs import _IfNodes

    dev = torch.device("cuda")
    pred = torch.ones((), dtype=torch.bool, device=dev)
    nodes, n, replays = _IfNodes(dev), 64, 20
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                          capture_error_mode="thread_local"):
        for _ in range(n):
            with nodes.node(pred):
                pass
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    b = bound(1 + 4, 0, torch.int8)
    log(f"  set_condition + its IF node: {ms * 1e3:.3f} us a node ({n} a graph); bound "
        f"{b[0] * 1e6:.4f} ns ({b[1]})  [{card}]")
    return {"ms": ms, "bound_ms": b[0], "bound_by": b[1], "nodes": n}


SHARD_PRESET = "qwen3-tts-0.6b"
SHARD_STEPS = 4  # the float32 flagship check's greedy steps (the JAX check's)
SHARD_NCCL_STEPS = 8  # two chunks of 4: the first captures, the second replays
# seconds a launch of the ranks may take (each ~25-55 s on the H100): a
# rank that hangs in a collective fails the phase instead of the whole run
SHARD_LAUNCH_S = 300


def _shard_gloo_rank(mesh) -> dict:
    """One of two gloo ranks on the one card: the 0.6B flagship in float32
    with the int8 cache (eager), the bf16 structural check, and the tiny
    batched serving check with its join (no flash-decode instance for
    head_dim 16)."""
    import torch.distributed as dist

    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.parallel import sharding as S

    cfg = get_preset(SHARD_PRESET)
    t = time.time()
    params = S.host_init_flagship(cfg)
    init_s = time.time() - t
    stats = {}
    ids, single = S.sharded_flagship_check(mesh, SHARD_STEPS, preset=cfg, params=params,
                                           use_cuda_graphs=False, stats=stats)
    structural = S.sharded_flagship_structural_check(mesh, 6, preset=cfg, params=params,
                                                     fp32_ids=single, use_cuda_graphs=False)
    batched = S.sharded_batched_serving_check(mesh, use_flash_decode=False,
                                              use_cuda_graphs=False)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, stats["sharded"])
    return {"ids": ids, "single": single, "stats": stats, "per_rank": per_rank,
            "structural": structural, "batched": batched, "host_init_s": init_s}


def _counted_shard_request(mesh, cfg, params, steps: int, what: str) -> dict:
    """One greedy request of ``steps`` frame steps on a captured sharded
    engine (the flagship check's inputs, EOS held off), run through
    ``_held_request``: the counters set to 0 just before it and read just
    after, each replay's launches read from its graph's kernel nodes, and
    every captured step holding 28 flash-decode launches."""
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.parallel import sharding as S
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy

    dt = cfg.torch_dtype
    eng = Engine(S.shard_params(S._host(params[0], dt), mesh, S.talker_param_specs(cfg.talker)),
                 S.shard_params(S._host(params[1], dt), mesh,
                                S.predictor_param_specs(cfg.predictor)),
                 cfg, max_seq_len=64, kv_quant=True, mesh=mesh, use_cuda_graphs=True)
    H = cfg.talker.hidden_size
    embeds, tth = S._randn(2, 1, 10, H), S._randn(3, 1, 4, H)
    tpe = np.zeros((1, 1, H), np.float32)
    pol = GenerationPolicy(do_sample=False, min_new_tokens=steps)

    def request():
        loops.fast_generate(eng, embeds, tth, tpe, generator=None, max_new_tokens=steps,
                            policy=pol, pred_policy=SamplingPolicy(do_sample=False),
                            device_chunk=4)

    return _held_request(eng, request, {"flash_decode": 28}, steps, what)


def _shard_nccl_rank(mesh, dtypes: tuple, steps: int) -> dict:
    """One NCCL rank of a mesh, one card each, for each dtype: the flagship
    check with captured chunks (the collectives captured in each step's
    IF-node body), then eagerly, then a counted captured request
    (``_counted_shard_request``)."""
    import dataclasses

    import torch.distributed as dist

    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.parallel import sharding as S

    cfg = get_preset(SHARD_PRESET)
    params = S.host_init_flagship(cfg)
    out = {}
    for dtype in dtypes:
        stats = {}
        captured, single = S.sharded_flagship_check(mesh, steps, preset=cfg, dtype=dtype,
                                                    params=params, use_cuda_graphs=True,
                                                    stats=stats)
        eager, _ = S.sharded_flagship_check(mesh, steps, preset=cfg, dtype=dtype, params=params,
                                            use_cuda_graphs=False, run_single=False)
        counted = _counted_shard_request(
            mesh, dataclasses.replace(cfg, dtype=dtype), params, steps,
            f"NCCL world {dist.get_world_size()} rank {dist.get_rank()}, {dtype}")
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, {**stats["sharded"], "counted": counted})
        out[dtype] = {"captured": captured, "single": single, "eager": eager, "stats": stats,
                      "per_rank": per_rank}
    return out


def _shard_summary(what: str, stats: dict, per_rank: list, steps: int) -> dict:
    """ms/step sharded and whole; the collectives and flash-decode launches
    of one eager step on each rank (28 int8 flash-decode launches); and
    each rank's flash-decode launches in its counted request: an eager
    engine's first request from the counters, a captured engine's counted
    request from its replayed graphs (``_counted_shard_request``)."""
    want = {"flash_decode": 0, "flash_decode_int8kv": 28}
    request = []
    for r, st in enumerate(per_rank):
        if st["eager_step_flash_decode"] != want:
            raise AssertionError(f"{what}: rank {r}'s eager step launched "
                                 f"{st['eager_step_flash_decode']} flash-decode kernels, not "
                                 f"{want}")
        if "counted" in st:
            rep = st["counted"]["replaying"]
            request.append({"steps": rep["steps"], "from": "replayed graphs",
                            "flash_decode": rep["launches"]["flash_decode"],
                            "kernel_nodes_a_step": rep["kernel_nodes_a_step"]})
        else:
            n = st["flash_decode_launches"]
            if n != {"flash_decode": 0, "flash_decode_int8kv": 28 * steps}:
                raise AssertionError(f"{what}: rank {r}'s {steps}-step request launched {n}")
            request.append({"steps": steps, "from": "counters (eager)",
                            "flash_decode": n["flash_decode_int8kv"]})
    out = {"ms_per_step_sharded": [st["ms_per_step"] for st in per_rank],
           "ms_per_step_single": stats["single"]["ms_per_step"],
           "collectives_per_eager_step": per_rank[0]["eager_step_collectives"],
           "flash_decode_per_eager_step_per_rank": [st["eager_step_flash_decode"]
                                                    for st in per_rank],
           "flash_decode_request_per_rank": request}
    log(f"  {what}: ms/step sharded {out['ms_per_step_sharded']} whole "
        f"{out['ms_per_step_single']:.2f}; collectives an eager step "
        f"{out['collectives_per_eager_step']}; flash-decode per rank in a counted request "
        f"{request}")
    return out


def slice_shard_phase(card: str) -> dict:
    """Tensor-parallel serving (``parallel/sharding.py``) on the 0.6B:

    - two gloo ranks on the one card (eager; gloo moves every collective
      through the host, so its ms/step measures the layout, not TP's
      speed): the float32 flagship with the int8 cache, SHARD_STEPS greedy
      steps, token-exact with the unsharded run, flash-decode's int8
      instance 28 a step on each rank; the bf16 structural check (logit
      deltas within JAX's thresholds); the batched serving check (3 rows, a
      join) equal to the unsharded run;
    - one NCCL rank: the bf16 flagship with captured chunks, equal to the
      eager sharded run and to the unsharded one;
    - ``nccl_tp_phase``: TP 2 and TP 4 over NCCL, captured, where the
      machine has that many cards; on one card a line says they did not
      run."""
    return {**_gloo_tp2_phase(card), **_nccl_world1_phase(card), **nccl_tp_phase(card)}


def _gloo_tp2_phase(card: str) -> dict:
    """Two gloo ranks on the one card (``_shard_gloo_rank``)."""
    from qwen3tts_tpu_torch.parallel import sharding as S

    t = time.time()
    r = S.launch(_shard_gloo_rank, 2, device="cuda", backend="gloo", timeout=SHARD_LAUNCH_S)
    if not np.array_equal(r["ids"], r["single"]):
        raise AssertionError(f"TP 2 (gloo) float32 tokens differ from the unsharded run:\n"
                             f"{r['ids']}\n{r['single']}")
    s, b = r["batched"]
    if s.shape != (3, 32, 16) or not np.array_equal(s, b):
        raise AssertionError("TP 2 (gloo) batched serving differs from the unsharded run")
    res = {"gloo_tp2": {
        "seconds": time.time() - t, "host_init_s": r["host_init_s"], "steps": SHARD_STEPS,
        "tokens_equal": True, "batched_equal": True, "structural": r["structural"],
        **_shard_summary("gloo TP 2, float32, int8 cache", r["stats"], r["per_rank"],
                         SHARD_STEPS)}}
    log(f"  gloo TP 2: float32 tokens equal the unsharded run over {SHARD_STEPS} steps; bf16 "
        f"structural {r['structural']}; batched (3 rows, a join) equal  [{card}]")
    return res


def _nccl_world1_phase(card: str) -> dict:
    """One NCCL rank, captured (``_shard_nccl_rank``, bf16)."""
    from qwen3tts_tpu_torch.parallel import sharding as S

    t = time.time()
    r = S.launch(_shard_nccl_rank, 1, ("bfloat16",), SHARD_NCCL_STEPS,
                 timeout=SHARD_LAUNCH_S)["bfloat16"]
    for name in ("eager", "single"):
        if not np.array_equal(r["captured"], r[name]):
            raise AssertionError(f"NCCL world 1, bf16: captured tokens differ from {name}")
    res = {"nccl_world1_captured": {
        "seconds": time.time() - t, "steps": SHARD_NCCL_STEPS, "tokens_equal": True,
        **_shard_summary("NCCL world 1, bf16, captured", r["stats"], r["per_rank"],
                         SHARD_NCCL_STEPS)}}
    log(f"  NCCL world 1, bf16: captured == eager == unsharded  [{card}]")
    return res


def nccl_tp_phase(card: str, tps: tuple = (2, 4),
                  dtypes: tuple = ("float32", "bfloat16")) -> dict:
    """TP 2 and TP 4 (``tps``) over NCCL, one card a rank, captured: the
    0.6B flagship in float32 with the int8 cache (captured tokens equal the
    eager sharded run and the unsharded one) and in bf16 (captured equal
    eager; the agreement with the unsharded bf16 run printed), ms/step
    sharded and whole.  A mesh needs as many cards as ranks: on fewer, a
    line says it did not run."""
    from qwen3tts_tpu_torch.parallel import sharding as S

    res = {}
    cards = torch.cuda.device_count()
    for tp in tps:
        if cards < tp:
            log(f"  NCCL TP {tp} captured: did not run: this machine has {cards} card(s), "
                f"TP {tp} over NCCL needs {tp}")
            continue
        t = time.time()
        runs = S.launch(_shard_nccl_rank, tp, dtypes, SHARD_NCCL_STEPS, timeout=SHARD_LAUNCH_S)
        seconds = time.time() - t  # both dtypes in one launch of the ranks
        for dtype, r in runs.items():
            if not np.array_equal(r["captured"], r["eager"]):
                raise AssertionError(f"NCCL TP {tp}, {dtype}: captured tokens differ from eager")
            agree = float((r["captured"] == r["single"]).mean())
            if dtype == "float32" and agree != 1.0:
                raise AssertionError(f"NCCL TP {tp}, float32: captured tokens differ from the "
                                     f"unsharded run:\n{r['captured']}\n{r['single']}")
            res[f"nccl_tp{tp}_{dtype}_captured"] = {
                "launch_seconds": seconds, "steps": SHARD_NCCL_STEPS,
                "token_agree_vs_unsharded": agree,
                **_shard_summary(f"NCCL TP {tp}, {dtype}, captured", r["stats"], r["per_rank"],
                                 SHARD_NCCL_STEPS)}
            log(f"  NCCL TP {tp}, {dtype}: captured == eager; tokens agree with the unsharded "
                f"run: {agree:.3f}  [{card}]")
    return res


TRAIN_PRESET = "qwen3-tts-0.6b"
TRAIN_ROWS, TRAIN_T, TRAIN_PADS = 2, 64, (0, 5)  # the talker step's batch
TRAIN_LR, TRAIN_STEPS = 1e-4, 3
TRAIN_RTOL = 1e-4  # a TP run's losses against the unsharded run's (float32, TF32 off)
# the ASR tool's short run: the committed recognizer's size (96 channels x
# 3 layers, the tool's defaults), synthesis by the 0.6B (its talker has a
# flash-decode instance), 8 texts x 3 voices x 3 perturbations = 72 clips
ASR_TRAIN_ARGS = ["--model", "random:qwen3-tts-0.6b", "--n-train", "8", "--n-eval", "4",
                  "--epochs", "4"]
# card vs CPU logits of the tool's checkpoint: cuDNN's default TF32 convs,
# then TF32 off (summation order only), as tests/test_torch_cuda_demo.py
ASR_TF32_ATOL, ASR_F32_ATOL = 0.1, 1e-3


def _train_batch(tk):
    """The talker step's batch: embeds [2, 64, H] * 0.02 and codebook-0
    targets from RandomState(0), left pads TRAIN_PADS."""
    rs = np.random.RandomState(0)
    embeds = (rs.randn(TRAIN_ROWS, TRAIN_T, tk.hidden_size) * 0.02).astype(np.float32)
    targets = rs.randint(0, tk.vocab_size, (TRAIN_ROWS, TRAIN_T)).astype(np.int32)
    return embeds, targets, np.array(TRAIN_PADS, np.int32)


def _spec_paths(specs, prefix: str = "") -> dict:
    from qwen3tts_tpu_torch.parallel.sharding import P

    if isinstance(specs, P):
        return {prefix: specs}
    return {k2: v2 for k, v in specs.items()
            for k2, v2 in _spec_paths(v, f"{prefix}/{k}" if prefix else k).items()}


def _talker_train(mesh) -> dict:
    """TRAIN_STEPS steps of ``make_train_step`` on the 0.6B talker at full
    width (28 layers, hidden 1024, GQA 16/8), float32 with TF32 off, the
    weights drawn on the card from a seeded generator (the same bits in
    every process), unsharded (``mesh=None``) or this rank's shard: the
    losses, ms a step (host wall around a synchronised step), the
    collectives of each step and the peak memory (above what the process
    held before: the parameters, the state and the steps); on a mesh, whether the
    replicated leaves have the same bits on every rank after each step."""
    import hashlib

    import torch.distributed as dist

    from qwen3tts_tpu_torch.core.presets import get_preset
    from qwen3tts_tpu_torch.models import talker as T
    from qwen3tts_tpu_torch.parallel import collectives
    from qwen3tts_tpu_torch.parallel import sharding as S
    from qwen3tts_tpu_torch.utils import optim

    tk = get_preset(TRAIN_PRESET).talker
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh is None else mesh.device
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
    try:
        params = T.init_params(torch.Generator(device=dev).manual_seed(0), tk, torch.float32,
                               dev)
        n_params = sum(p.numel() for p in optim.leaves(params))
        replicated = []
        if mesh is not None:
            specs = S.talker_param_specs(tk)
            replicated = [k for k, v in _spec_paths(specs).items() if "tp" not in v]
            params = S.shard_params(params, mesh, specs)
        torch.cuda.empty_cache()
        init_opt, step = S.make_train_step(tk, mesh, TRAIN_LR,
                                           device=dev if mesh is None else None)
        state = init_opt(params)
        batch = _train_batch(tk)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = {"params": n_params, "losses": [], "ms": [], "collectives": [],
               "replicated_equal": []}
        for _ in range(TRAIN_STEPS):
            collectives.reset_counts()
            torch.cuda.synchronize(dev)
            t = time.time()
            params, state, loss = step(params, state, *batch)
            out["losses"].append(loss.item())
            torch.cuda.synchronize(dev)
            out["ms"].append((time.time() - t) * 1e3)
            out["collectives"].append({"forward": collectives.counts(),
                                       "backward": collectives.backward_counts()})
            if mesh is not None:
                named = dict(optim.named_leaves(params))
                h = hashlib.sha256()
                for k in replicated:
                    h.update(named[k].cpu().numpy().tobytes())
                got = [None] * dist.get_world_size()
                dist.all_gather_object(got, h.hexdigest())
                out["replicated_equal"].append(len(set(got)) == 1)
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        if mesh is None:
            out["breakdown_ms"] = _step_breakdown(tk, params, state, batch, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def _step_breakdown(tk, params, state, batch, dev) -> dict:
    """Where an unsharded step's time goes: the loss's forward and backward
    alone (``_talker_nll`` and ``torch.autograd.grad``; host wall around
    synchronised work), then the same under ``torch.profiler`` (the
    kernels' device time and count, the five longest kernels), then one
    AdamW update alone on those gradients (it moves the parameters one more
    step).  Eager work only: no CUDA graph is traced."""
    from torch.autograd import DeviceType

    from qwen3tts_tpu_torch.parallel import sharding as S
    from qwen3tts_tpu_torch.utils import optim

    ps = optim.leaves(params)
    embeds, targets, pad = (torch.from_numpy(x).to(dev) for x in batch)

    def forward_backward():
        for p in ps:
            p.requires_grad_(True)
        nll, n = S._talker_nll(params, tk, embeds, targets, pad)
        grads = torch.autograd.grad(nll / n, ps, allow_unused=True)
        for p in ps:
            p.requires_grad_(False)
        torch.cuda.synchronize(dev)
        return grads

    torch.cuda.synchronize(dev)
    t = time.time()
    grads = forward_backward()
    out = {"forward_backward": (time.time() - t) * 1e3}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        forward_backward()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    out["forward_backward_device"] = device_us / 1e3 if device_us else None  # None: no trace
    out["forward_backward_kernels"] = sum(e.count for e in kernels)
    out["top_kernels_ms"] = [[e.key[:80], e.self_device_time_total / 1e3] for e in sorted(
        kernels, key=lambda e: -e.self_device_time_total)[:5]]
    t = time.time()
    optim.adamw(TRAIN_LR).step(params, list(grads), state)
    torch.cuda.synchronize(dev)
    out["adamw"] = (time.time() - t) * 1e3
    return out


def _talker_train_rank(mesh) -> dict:
    """One rank of ``_talker_train``, with every rank's ms a step and peak
    memory."""
    import torch.distributed as dist

    out = _talker_train(mesh)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, {"ms": out["ms"], "peak_bytes": out["peak_bytes"]})
    out["per_rank"] = per_rank
    return out


def _train_held(what: str, run: dict, single: dict, dp: int, tp: int, card: str) -> dict:
    """A TP run of the talker step against the unsharded one: the losses
    finite and falling and within TRAIN_RTOL, the replicated leaves bit-equal
    across ranks after each step, the collectives of each step as
    ``make_train_step`` gives them."""
    L = 28
    losses, ref = np.array(run["losses"]), np.array(single["losses"])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses {losses.tolist()} not finite and falling")
    rel = float(np.abs(losses - ref).max() / np.abs(ref).max())
    if rel > TRAIN_RTOL:
        raise AssertionError(f"{what}: losses {losses.tolist()} against the unsharded "
                             f"{ref.tolist()}: {rel:.2e} relative > {TRAIN_RTOL}")
    if run["replicated_equal"] != [True] * TRAIN_STEPS:
        raise AssertionError(f"{what}: replicated leaves differ across ranks "
                             f"{run['replicated_equal']}")
    want = {"forward": {"all_reduce": 2 * L + (dp > 1), "all_gather": 1},
            "backward": {"all_reduce": 2 * L + 2 + (dp > 1)}}
    if run["collectives"] != [want] * TRAIN_STEPS:
        raise AssertionError(f"{what}: collectives {run['collectives']} not {want} a step")
    res = {"dp": dp, "tp": tp, "losses": run["losses"], "loss_rel_err": rel,
           "ms_per_step_per_rank": [r["ms"] for r in run["per_rank"]],
           "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in run["per_rank"]],
           "collectives_per_step": want}
    log(f"  talker step, {what}: losses {run['losses']} ({rel:.2e} rel. of the unsharded); "
        f"ms/step by rank {res['ms_per_step_per_rank']}; peak GB by rank "
        f"{res['peak_gb_per_rank']}; collectives a step {want}  [{card}]")
    return res


def _asr_train(card: str) -> dict:
    """The ASR tool's ``main`` at ASR_TRAIN_ARGS into a temporary directory
    on the card: the epoch losses falling; the checkpoint it wrote loads
    into the port's CTCRecognizer (the card by default); its logits on the
    16 committed samples/asr/eval clips, card against CPU, within
    ASR_TF32_ATOL with cuDNN's default TF32 and ASR_F32_ATOL with it off;
    the seconds of synthesis, featurisation and an epoch."""
    from qwen3tts_tpu_torch.audio.wav import read_wav
    from qwen3tts_tpu_torch.models import asr
    from qwen3tts_tpu_torch.tools import train_asr

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "asr")
    manifest = json.load(open(os.path.join(root, "manifest.json")))
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        with contextlib.redirect_stdout(sys.stderr):  # the tool's own JSON line
            r = train_asr.main([*ASR_TRAIN_ARGS, "--out", tmp])
        seconds = time.time() - t
        ckpt = os.path.join(tmp, "ctc_selftrained")
        card_rec = asr.CTCRecognizer.from_pretrained(ckpt)
        cpu_rec = asr.CTCRecognizer.from_pretrained(ckpt, device="cpu")
    if r["device"] != "cuda" or card_rec.device.type != "cuda":
        raise AssertionError(f"the tool ran on {r['device']}, its recognizer on "
                             f"{card_rec.device}")
    losses = r["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"ASR tool: epoch losses {losses} not finite and falling")
    clips = [read_wav(os.path.join(root, e["wav"])) for e in manifest]
    err = {}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for name, tf32, atol in (("cudnn_tf32_default", prev, ASR_TF32_ATOL),
                                 ("cudnn_tf32_off", False, ASR_F32_ATOL)):
            torch.backends.cudnn.allow_tf32 = tf32
            d = max(float(np.abs(card_rec.logits(w, sr) - cpu_rec.logits(w, sr)).max())
                    for w, sr in clips)
            if d > atol:
                raise AssertionError(f"ASR tool's checkpoint: card vs CPU logits {d} > {atol} "
                                     f"({name})")
            err[name] = d
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    res = {"seconds": seconds, "tool_seconds": r["seconds"], "losses": losses,
           "clips": len(clips), "card_vs_cpu_logit_max_abs_err": err,
           "eval_cer_heldout_perturbation": r["eval_cer_heldout_perturbation"]}
    log(f"  ASR tool ({' '.join(ASR_TRAIN_ARGS)}): {json.dumps(res)}  [{card}]")
    return res


def slice_train_phase(card: str) -> dict:
    """The training half on the card:

    - the ASR tool (``tools/train_asr.py``) at ASR_TRAIN_ARGS
      (``_asr_train``);
    - the talker step (``parallel/sharding.py:make_train_step``) on the
      0.6B at full width, float32, B 2 x T 64, left pads (0, 5), lr 1e-4, 3
      steps: unsharded in this process (and where its time goes:
      ``_step_breakdown``), then TP 2 over gloo on the one card
      (``_train_held``: losses within TRAIN_RTOL of the unsharded run's,
      replicated leaves bit-equal across ranks, the collectives' formula),
      then dp 2 x tp 2 over NCCL where the machine has four cards (else a
      line says it did not run); ms a step, peak memory a rank."""
    import gc

    from qwen3tts_tpu_torch.parallel import sharding as S

    # the tool first: its synthesis replays CUDA graphs, and the talker's
    # breakdown traces (eagerly) with torch.profiler, after which no replay
    # may follow (tools/graph_trace_probe.py)
    res = {"asr": _asr_train(card)}
    gc.collect()
    torch.cuda.empty_cache()
    t = time.time()
    single = _talker_train(None)
    losses = np.array(single["losses"])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"unsharded talker step: losses {losses.tolist()} not finite "
                             "and falling")
    zero = {"forward": {"all_reduce": 0, "all_gather": 0}, "backward": {"all_reduce": 0}}
    if single["collectives"] != [zero] * TRAIN_STEPS:
        raise AssertionError(f"unsharded talker step made collectives {single['collectives']}")
    res["talker_unsharded"] = {
        "seconds": time.time() - t, "params": single["params"], "losses": single["losses"],
        "ms_per_step": single["ms"], "peak_gb": single["peak_bytes"] / 1e9,
        "breakdown_ms": single["breakdown_ms"]}
    log(f"  talker step, unsharded: {json.dumps(res['talker_unsharded'])}  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.time()
    run = S.launch(_talker_train_rank, 2, device="cuda", backend="gloo", timeout=SHARD_LAUNCH_S)
    res["talker_gloo_tp2"] = {"seconds": time.time() - t,
                              **_train_held("gloo TP 2 on one card", run, single, 1, 2, card)}
    cards = torch.cuda.device_count()
    if cards >= 4:
        t = time.time()
        run = S.launch(_talker_train_rank, 4, dp=2, timeout=SHARD_LAUNCH_S)
        res["talker_nccl_dp2xtp2"] = {
            "seconds": time.time() - t,
            **_train_held("NCCL dp 2 x tp 2", run, single, 2, 2, card)}
    else:
        log(f"  talker step, NCCL dp 2 x tp 2: did not run: this machine has {cards} card(s), "
            "the mesh needs 4")
    return res


EXAMPLE_MODEL = ["--model", "random:qwen3-tts-0.6b", "--dtype", "bf16"]
EXAMPLE_STEPS = 48  # --max-new-tokens of the generate example
EXAMPLE_S = 300  # each example process's time limit
EXAMPLE_WROTE = re.compile(r"wrote (\S+): ([0-9.]+)s in ([0-9.]+)s \(([0-9.]+) ms/step\)")


def _example(script: str, *argv) -> tuple:
    """``python3 examples/<script> *argv`` in a fresh process, as a user
    runs it (the checkout on PYTHONPATH): (its last stdout line, seconds).
    Raises unless it exits 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    t = time.time()
    res = subprocess.run([sys.executable, os.path.join(root, "examples", script), *argv,
                          *EXAMPLE_MODEL], capture_output=True, text=True, env=env, cwd=root,
                         timeout=EXAMPLE_S)
    dt = time.time() - t
    if res.returncode != 0 or not res.stdout.strip():
        raise AssertionError(f"examples/{script} exited {res.returncode}: "
                             f"{res.stderr.strip()[-2000:]}")
    return res.stdout.strip().splitlines()[-1], dt


def examples_phase(card: str) -> dict:
    """The port's x-vector examples on the card as a user runs them: two
    fresh processes, ``examples/torch_extract_speaker.py`` on the phase's
    reference wav, then ``examples/torch_generate_with_embedding.py`` on its
    .npz (random:qwen3-tts-0.6b, bf16, EXAMPLE_STEPS new tokens at most).
    The .npz must hold one finite float32 vector of the preset's speaker
    width, the wav exactly (printed steps) x samples per frame of finite
    audio, where the printed seconds give the steps (a frame is 1/12 s, the
    line prints 1/100 s); each process's seconds and the example's
    ms/step."""
    from qwen3tts_tpu_torch.audio.wav import read_wav
    from qwen3tts_tpu_torch.core.presets import get_preset

    cfg = get_preset("qwen3-tts-0.6b")
    sr, spf = cfg.codec.sample_rate, cfg.codec.total_upsample
    with tempfile.TemporaryDirectory() as tmp:
        ref, npz, out = (os.path.join(tmp, f) for f in ("ref.wav", "speaker.npz", "out.wav"))
        _ref_wav(ref)
        extract_line, extract_s = _example("torch_extract_speaker.py", ref, "-o", npz)
        with np.load(npz) as f:
            keys, vec = list(f.keys()), f["ref_spk_embedding"]
        if (keys != ["ref_spk_embedding"] or vec.dtype != np.float32
                or vec.shape != (cfg.speaker_encoder.emb_dim,) or not np.isfinite(vec).all()):
            raise AssertionError(f"extract example: {keys} {vec.dtype} {vec.shape} is not one "
                                 f"finite float32 vector of {cfg.speaker_encoder.emb_dim}")
        gen_line, gen_s = _example("torch_generate_with_embedding.py", npz, "-o", out,
                                   "--max-new-tokens", str(EXAMPLE_STEPS))
        m = EXAMPLE_WROTE.fullmatch(gen_line)
        if not m or m.group(1) != out:
            raise AssertionError(f"generate example printed {gen_line!r}")
        audio_s, wall_s, ms_per_step = (float(m.group(i)) for i in (2, 3, 4))
        steps = round(audio_s * sr / spf)
        if not (2 <= steps <= EXAMPLE_STEPS and abs(steps * spf / sr - audio_s) <= 0.005 + 1e-9):
            raise AssertionError(f"generate example: {audio_s} s is not a whole number of "
                                 f"frames in [2, {EXAMPLE_STEPS}]")
        audio, wav_sr = read_wav(out)
    if wav_sr != sr or audio.shape != (steps * spf,) or not np.isfinite(audio).all():
        raise AssertionError(f"generate example: wav of {audio.shape} at {wav_sr} Hz, want "
                             f"({steps * spf},) finite samples at {sr} Hz")
    res = {"extract": {"process_s": extract_s, "printed": extract_line},
           "generate": {"process_s": gen_s, "steps": steps, "audio_s": audio_s,
                        "printed_wall_s": wall_s, "ms_per_step": ms_per_step,
                        "printed": gen_line}}
    log(f"  examples: {json.dumps(res)}  [{card}]")
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script runs only on the card")
    import qwen3tts_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.time()
    phase_s = {}

    def phase(name, fn, *a):
        log(f"== {name} == ({time.time() - t0:.0f} s)")
        t = time.time()
        out = fn(*a)
        phase_s[name] = phase_s.get(name, 0.0) + time.time() - t
        return out

    card = phase("probe", probe)
    max_err, times, fd_extra = phase("kernel", kernel_phase, card)
    q_err, q_times, q_bounds = phase("kernel", int8kv_kernel_phase, card)
    b_err = phase("kernel", batch_kernel_phase, card)
    f_err, f_times, f_bounds = phase("kernel", fused_kernel_phase, card)
    m_err, m_out = phase("kernel", micro_kernel_phase, card)
    m17_err, m17_out = phase("kernel", micro_kernel_phase, card, "qwen3-tts-1.7b")
    v_err, v_launches, v_times = phase("kernel", matvec_phase, card)
    w_err, w_times, w_bounds = phase("kernel", w8a8_kernel_phase, card)
    rank_flash = phase("kernel", rank_flash_phase, card)
    cond = phase("kernel", set_condition_phase, card)
    models = {"bf16": _load(), "int8": _load(quantize="int8", kv_quant=True)}
    _, results = phase("slice", slice_phase, card, models["bf16"])
    _, q_results = phase("slice-int8", slice_int8_phase, card, models["int8"])
    _, m_frames = phase("slice-micro", slice_micro_phase, card, models["bf16"])
    phase("parity", parity_phase, card)
    phase("parity", parity_int8_phase, card)
    phase("parity", parity_micro_phase, card)
    phase("parity", graph_parity_phase, card)
    b_parity = phase("parity", batch_parity_phase, card)
    w_parity = phase("parity", parity_w8a8_phase, card)
    g = phase("slice-graph", slice_graph_phase, card, models)
    icl = phase("slice-icl", slice_icl_phase, card, models)
    icl_parity = phase("slice-icl", icl_parity_phase, card)
    batch = phase("slice-batch", slice_batch_phase, card, models)
    serve = phase("slice-serve", slice_serve_phase, card, models)
    serve_parity = phase("slice-serve", serve_parity_phase, card)
    voices = phase("slice-voices", slice_voices_phase, card, models)
    ckpt = phase("slice-checkpoint", slice_checkpoint_phase, card)
    w8 = phase("slice-w8a8", slice_w8a8_phase, card, models)
    demo = phase("slice-demo", slice_demo_phase, card)
    shard = phase("slice-shard", slice_shard_phase, card)
    train = phase("slice-train", slice_train_phase, card)
    examples = phase("examples", examples_phase, card)
    # the main path: the captured chunks, in the counted request that
    # captured them; a replay's launches read from its graph's kernel nodes
    traced = {path: g["paths"][path]["captured"]["counted_request"]["capturing"]["launches"]
              for path in GRAPH_PATHS}
    launches = traced["bf16"]["flash_decode"]
    q_launches = {"flash_decode_int8kv": traced["int8_fused"]["flash_decode"],
                  "fused_norm_matmul": traced["int8_fused"]["fused_norm_matmul"],
                  "fused_o_mlp": traced["int8_fused"]["fused_o_mlp"]}
    m_launches = traced["micro"]["fused_micro_step"]
    log("slice: " + json.dumps({"card": card, "requests": results,
                                "kernel_max_abs_err": max_err,
                                "kernel_ms": {str(k): v[0] for k, v in times.items()},
                                "plain_ms": {str(k): v[1] for k, v in times.items()},
                                "sdpa_ms": {str(k): v for k, v in
                                            fd_extra["library_ms"].items()}}))
    log("slice-int8: " + json.dumps({
        "card": card, "requests": q_results, "traced_launches": q_launches,
        "int8kv_max_abs_err": q_err,
        "int8kv_ms": {str(k): v[0] for k, v in q_times.items()},
        "int8kv_plain_ms": {str(k): v[1] for k, v in q_times.items()},
        "fused_max_abs_err": f_err,
        "fused_ms": {" ".join(k): v for k, v in f_times.items()}}))
    log("slice-graph: " + json.dumps({"card": card, **g}))
    log("slice-icl: " + json.dumps({"card": card, **icl, "parity": icl_parity}))
    log("slice-batch: " + json.dumps({"card": card, **batch, "parity": b_parity,
                                      "flash_decode_rows_max_abs_err": b_err}))
    log("slice-serve: " + json.dumps({"card": card, **serve, "parity": serve_parity}))
    k17 = {name: {"ms": {w: f_times[(name, "talker_1.7b", w)][0] for w in ("int8", "bf16")},
                  "plain_ms": {w: f_times[(name, "talker_1.7b", w)][1] for w in ("int8", "bf16")},
                  "bound_ms": {w: f_bounds[(name, "talker_1.7b", w)][0]
                               for w in ("int8", "bf16")}}
           for name in ("fused_norm_matmul", "fused_o_mlp")}
    k17["fused_micro_step"] = {"ms": m17_out["times"]["kernel"],
                               "plain_ms": m17_out["times"]["plain"],
                               "bound_ms": m17_out["bound_ms"], "max_abs_err": m17_err}
    log("slice-voices: " + json.dumps({"card": card, **voices, "kernels_1.7b": k17}))
    log("slice-checkpoint: " + json.dumps(ckpt))
    log("slice-w8a8: " + json.dumps({
        "card": card, **w8, "parity": w_parity, "kernel_max_abs_err": w_err,
        "kernel_us": {f"{where} M={M}": {k: v * 1e3 for k, v in t.items()}
                      for (where, M), t in w_times.items()},
        "bound_us": {f"{where} M={M}": {k: v[0] * 1e3 for k, v in b.items()}
                     for (where, M), b in w_bounds.items()}}))
    log("slice-demo: " + json.dumps({"card": card, **demo}))
    log("slice-shard: " + json.dumps({"card": card, **shard, "rank_flash_decode": rank_flash,
                                      "set_condition": cond}))
    log("slice-train: " + json.dumps({"card": card, **train}))
    log("examples: " + json.dumps({"card": card, **examples}))
    log("slice-micro: " + json.dumps({
        "card": card, "ms_per_frame": m_frames, "launches": m_launches,
        "micro_step_max_abs_err": m_err, "micro_step_ms": m_out["times"],
        "grid_ctas": m_out["grid"], "grid_barriers": m_out["barriers"],
        "matvec_max_abs_err": v_err,
        "matvec_ms": {w: v["times"] for w, v in v_times.items()}}))
    fd_src, fb_src = ("qwen3tts_tpu_torch/csrc/flash_decode.cu",
                      "qwen3tts_tpu_torch/csrc/fused_block.cu")
    mv_src = "qwen3tts_tpu_torch/csrc/matvec.cu"
    probe_t = v_times["probe"]["times"]
    w_src = "qwen3tts_tpu_torch/csrc/w8a8.cu"
    w_launches = w8["w8a8"]["counted_request"]["capturing"]["launches"]
    w_t, w_b = w_times[("talker_qkv", 1)], w_bounds[("talker_qkv", 1)]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound_ms_by, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
                "library_ms": library_ms}

    # flash-decode at pos 300 with a cold L2 (two cache stacks); the fused
    # kernels at the talker's shapes with int8 weights, as the int8 path runs
    # them; the micro-step per step of a bf16 frame; the matvecs at the
    # probe's default shape in bf16; the w8a8 kernels at the 0.6B talker's
    # qkv shape, one row of bf16 activations (their launches: slice-w8a8's
    # counted captured request; no Pallas original: they replace the JAX
    # package's XLA int8 dot and its activation quantizer)
    log(f"phase seconds: {json.dumps(phase_s)}; total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [
        entry("flash_decode", fd_src, "qwen3tts_tpu/ops/flash_decode.py:180", launches,
              max_err["bf16"], times["cold300"][0], times["cold300"][1],
              fd_extra["bound"]["cold300"], fd_extra["library_ms"]["cold300"]),
        entry("flash_decode_int8kv", fd_src, "qwen3tts_tpu/ops/flash_decode.py:180",
              q_launches["flash_decode_int8kv"], q_err["bf16"], q_times["cold300"][0],
              q_times["cold300"][1], q_bounds["cold300"], None),
        *(entry(name, fb_src, f"qwen3tts_tpu/ops/fused_block.py:{line}", q_launches[name],
                f_err[name], f_times[(name, "talker", "int8")][0],
                f_times[(name, "talker", "int8")][1], f_bounds[(name, "talker", "int8")],
                None)
          for name, line in (("fused_norm_matmul", 95), ("fused_o_mlp", 187))),
        entry("fused_micro_step", "qwen3tts_tpu_torch/csrc/predictor_step.cu",
              "qwen3tts_tpu/ops/predictor_step.py:319", m_launches, m_err["bf16"],
              m_out["times"]["kernel"], m_out["times"]["plain"],
              (m_out["bound_ms"], m_out["bound_by"]), None),
        entry("matvec", mv_src, "benchmarks/matvec_probe.py:65", v_launches["matvec"],
              v_err["matvec"], probe_t["matvec"], probe_t["matvec_plain"],
              (v_times["probe"]["bound_ms"], v_times["probe"]["bound_by"]),
              probe_t["torch_1row"]),
        entry("matvec_kt", mv_src, "benchmarks/matvec_probe.py:85", v_launches["matvec_kt"],
              v_err["matvec_kt"], probe_t["matvec_kt"], probe_t["matvec_kt_plain"],
              (v_times["probe"]["bound_kt_ms"], v_times["probe"]["bound_by"]),
              probe_t["torch_pre_t"]),
        entry("quantize_act", w_src, "qwen3tts_tpu/ops/quant.py:68", w_launches["quantize_act"],
              w_err["quantize_act"], w_t["quantize_act"], w_t["quantize_act_plain"],
              w_b["quantize_act"], None),
        entry("w8a8_gemv", w_src, "qwen3tts_tpu/ops/quant.py:76", w_launches["w8a8_gemv"],
              w_err["w8a8_gemv"], w_t["w8a8_gemv"], w_t["w8a8_gemv_plain"], w_b["w8a8_gemv"],
              None),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
