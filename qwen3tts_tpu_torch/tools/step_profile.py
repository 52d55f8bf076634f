"""Where a decode step's time goes, on the card.

    python -m qwen3tts_tpu_torch.tools.step_profile [--steps 48] [--out DIR]
        [--quantize int8|w8a8[-talker|-predictor]] [--kv-quant] [--fused]
        [--micro]

Loads ``random:qwen3-tts-0.6b`` in bf16 (with ``--quantize``, a
quantize mode: int8 weight-only or w8a8; ``--kv-quant``, an int8 KV cache; ``--fused``,
``use_fused_kernels=True``; ``--micro``, ``use_micro_kernel=True``) with
an engine that runs its chunks eagerly, warms up, then runs one streaming
request (chunk 8) without and then under ``torch.profiler`` and prints:
wall time per step (the profiler's own cost shows as the difference),
the host time inside each named range of the engine (``predictor_frame``,
``talker_step``, ``codec_stream``), the device time summed over all kernels
and its share of the unprofiled wall time (the device's busy share), and the
kernels with the most device time, with their device ms and launches a
step.  ``--out`` also writes a Chrome trace.  The captured chunks are not
profiled: the profiler's tracing of CUDA graphs with conditional nodes lost
kernel records and left a later replay faulting on the H100 (``chip_smoke.py``
counts their launches and times their replays without it).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val:
            return float(val)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out", default=None, help="directory for trace.json")
    ap.add_argument("--quantize", default=None,
                    help="a quantize mode: int8 or w8a8, -talker / -predictor for one part")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--fused", action="store_true", help="use_fused_kernels=True")
    ap.add_argument("--micro", action="store_true", help="use_micro_kernel=True")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA device")

    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.audio.wav import write_wav
    from qwen3tts_tpu_torch.runtime.engine import Engine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    model = FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b", device="cuda",
                                           dtype="bfloat16", quantize=args.quantize,
                                           kv_quant=args.kv_quant)
    model.engine = Engine(model.params["talker"], model.params["predictor"], model.cfg,
                          max_seq_len=model.max_seq_len, use_fused_kernels=args.fused,
                          use_micro_kernel=args.micro, use_cuda_graphs=False,
                          kv_quant=args.kv_quant)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.wav")
        t = np.linspace(0, 3.0, 72_000, dtype=np.float32)
        write_wav(ref, (0.25 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), 24_000)
        kw = dict(text="The quick brown fox jumps over the lazy dog.", language="English",
                  ref_audio=ref, ref_text="", chunk_size=args.chunk)
        list(model.generate_voice_clone_streaming(max_new_tokens=16, min_new_tokens=16, **kw))
        torch.cuda.synchronize()
        t0 = time.time()
        list(model.generate_voice_clone_streaming(
            max_new_tokens=args.steps, min_new_tokens=args.steps, **kw))
        torch.cuda.synchronize()
        plain_wall = time.time() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            list(model.generate_voice_clone_streaming(
                max_new_tokens=args.steps, min_new_tokens=args.steps, **kw))
            torch.cuda.synchronize()
            wall = time.time() - t0
    events = prof.key_averages()
    names = ("predictor_frame", "talker_step", "codec_stream")
    # host side: the CPU events of the named ranges; device side: the card's
    # kernel (and memcpy/memset) events, without the ranges' GPU annotations
    ranges = {e.key: e.cpu_time_total / 1e3 for e in events
              if e.key in names and e.device_type == DeviceType.CPU}
    kernels = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and e.key not in names),
                     key=lambda r: -r[1])
    device_ms = sum(k[1] for k in kernels)
    report = {
        "card": card,
        "path": {"quantize": args.quantize, "kv_quant": args.kv_quant, "fused": args.fused,
                 "micro": args.micro},
        "steps": args.steps,
        "wall_ms": wall * 1e3,
        "wall_ms_per_step": wall * 1e3 / args.steps,
        "wall_ms_per_step_without_profiler": plain_wall * 1e3 / args.steps,
        "host_ms_in_ranges": ranges,
        "device_ms_all_kernels": device_ms,
        "device_ms_per_step": device_ms / args.steps,
        # the profiler slows the host, not the device: the busy share of an
        # unprofiled request is device time over the unprofiled wall time
        "device_busy_share": device_ms / (plain_wall * 1e3),
        "device_busy_share_under_profiler": device_ms / (wall * 1e3),
        "device_ops_per_step": sum(k[2] for k in kernels) / args.steps,
        "top_kernels_ms": [[k[0][:80], round(k[1], 3), k[2]] for k in kernels[:12]],
        "top_kernels_ms_and_launches_per_step": [
            [k[0][:80], round(k[1] / args.steps, 4), k[2] / args.steps] for k in kernels[:16]],
    }
    print(json.dumps(report, indent=1))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))


if __name__ == "__main__":
    main()
