"""Do captured chunks replay right, with and without torch.profiler?

    python -m qwen3tts_tpu_torch.tools.graph_trace_probe [--profile] [--steps 32]

Loads ``random:qwen3-tts-0.6b`` in bf16 and with int8 weights and an int8
KV cache, then runs, in this order, int8 + fused kernels at B 4, int8 +
fused at B 1, bf16 + micro kernel at B 1, bf16 at B 4, int8 + fused at B 16
and bf16 at B 1: for each a new Engine whose chunks are captured with
``ChunkGraphs(record=True)``, and three greedy ``fast_generate_batch``
requests of ``--steps`` steps (chunk 16) over random prompts of different
lengths, whose frames must equal the first request's.  Each request's
kernel launches are read from the graphs it replayed
(``ChunkGraphs.kernel_nodes``, the bodies of the steps its ``n`` says ran).
With ``--profile``, the second and third request of each run under
``torch.profiler`` (CPU and CUDA activity), and the trace's kernel records
are printed beside the graphs' count.  Prints one JSON line a request; a
fault ends the process, so run the two modes as two processes.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops.cuda_build import KERNEL_SYMBOLS as NEEDLES

RUNS = (("int8", 4), ("int8", 1), ("micro", 1), ("bf16", 4), ("int8", 16), ("bf16", 1))


def _replayed(graphs) -> dict:
    """Kernel launches of the replays in the recording's log, by kernel."""
    torch.cuda.synchronize()
    out = dict.fromkeys(NEEDLES, 0)
    walked = {}
    for g, n, _, _ in graphs.log:
        if id(g) not in walked:
            walked[id(g)] = graphs.kernel_nodes(g, list(NEEDLES.values()))
        top, bodies = walked[id(g)]
        for counts in (top, *bodies[: int(n)]):
            for k, c in zip(NEEDLES, counts):
                out[k] += c
    return out


def _traced(fn) -> dict:
    """Run ``fn`` under torch.profiler; its kernel records, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(NEEDLES, 0)
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        for k, needle in NEEDLES.items():
            if needle in evt.name:
                out[k] += 1
                break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)

    from qwen3tts_tpu_torch import FasterQwen3TTS
    from qwen3tts_tpu_torch.models.predictor import SamplingPolicy
    from qwen3tts_tpu_torch.runtime import loops
    from qwen3tts_tpu_torch.runtime.engine import Engine, GenerationPolicy
    from qwen3tts_tpu_torch.runtime.graphs import ChunkGraphs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, "torch", torch.__version__, flush=True)
    models = {"bf16": FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b", device="cuda",
                                                     dtype="bfloat16"),
              "int8": FasterQwen3TTS.from_pretrained("random:qwen3-tts-0.6b", device="cuda",
                                                     dtype="bfloat16", quantize="int8",
                                                     kv_quant=True)}
    options = {"bf16": ("bf16", {}), "micro": ("bf16", {"use_micro_kernel": True}),
               "int8": ("int8", {"use_fused_kernels": True, "kv_quant": True})}
    pol = GenerationPolicy(do_sample=False, min_new_tokens=args.steps)
    ppol = SamplingPolicy(do_sample=False)
    rng = np.random.default_rng(0)
    ok = True
    for path, B in RUNS:
        which, kw = options[path]
        model = models[which]
        H = model.cfg.talker.hidden_size
        eng = Engine(model.params["talker"], model.params["predictor"], model.cfg,
                     max_seq_len=model.max_seq_len, batch=B, **kw)
        eng.graphs = ChunkGraphs(eng, record=True)
        lengths = [40 + 23 * b % 97 for b in range(B)]
        T = max(lengths)
        embeds = np.zeros((B, T, H), np.float32)
        for b, n in enumerate(lengths):
            embeds[b, T - n:] = rng.normal(0, 0.1, (n, H))
        trailing = rng.normal(0, 0.1, (B, 8, H)).astype(np.float32)
        tpe = rng.normal(0, 0.1, (B, 1, H)).astype(np.float32)
        pads = np.array([T - n for n in lengths], np.int64)

        def request():
            return loops.fast_generate_batch(
                eng, embeds, trailing, tpe, generator=None, pad_count=pads,
                max_new_tokens=args.steps, policy=pol, pred_policy=ppol, device_chunk=16)[0]

        first = None
        for run in range(3):
            eng.graphs.log.clear()
            trace = None
            if args.profile and run:
                box = []
                trace = _traced(lambda: box.append(request()))
                rows = box[0]
            else:
                rows = request()
            same = first is None or all(np.array_equal(a, b) for a, b in zip(rows, first))
            first = first or rows
            ok &= same
            print(json.dumps({"path": path, "B": B, "run": run, "frames": [len(r) for r in rows],
                              "same_as_run0": same, "graph_launches": _replayed(eng.graphs),
                              "trace_records": trace, "card": card}), flush=True)
        del eng
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
