"""The traced run's eager profile: kernel times by name from a device trace.

``torch.profiler`` loses the kernels of replayed graphs with conditional
nodes (and a replay after such a trace has faulted), so it never runs
around a replay: after the window, a second ``Engine`` on the same weights
with ``use_cuda_graphs=False`` runs a few eager steps at the cell's batch,
at a talker position inside its traffic's range, under the profiler.  The
trace is read from its Chrome-trace export (kernel and copy events, and the
host's ``record_function`` ranges and operators).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

WARM_STEPS = 4
PROFILED_STEPS = 4
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_RANGES = ("predictor_frame", "talker_step", "codec_stream")


def mid_frames(mix: Dict) -> int:
    f = mix["frames"]
    return int(f["median"] if f["kind"] == "lognormal" else (f["min"] + f["max"]) // 2)


def eager_profile(model, cfg_obj, mix: Dict, batch: int, seed: int, options: Dict) -> Dict:
    """Profile ``PROFILED_STEPS`` eager steps at ``batch`` rows on an engine
    with the cell's ``Engine`` ``options``, the talker at a prompt of the
    mix's middle length plus half its middle frames."""
    from qwen3tts_tpu_torch.runtime.engine import Engine
    from drivers import policies

    frames = mid_frames(mix)
    prompt = 11 + int(round(frames * mix["text_tokens_per_frame"]))
    eng = Engine(model.params["talker"], model.params["predictor"], cfg_obj,
                 max_seq_len=model.max_seq_len, batch=batch, use_cuda_graphs=False,
                 **options)
    H = cfg_obj.talker.hidden_size
    gen = torch.Generator(device=eng.device).manual_seed(int(seed))
    embeds = (torch.randn((batch, prompt, H), generator=gen, device=eng.device) * 0.05
              ).to(eng.dtype)
    pol, ppol = policies(mix["greedy_share"] >= 0.5, 1 << 20)
    tpe = torch.zeros((batch, 1, H), dtype=eng.dtype, device=eng.device)
    state = eng.prefill(embeds, gen, pol, ppol)
    for _ in range(frames // 2 + WARM_STEPS):
        state, _ = eng.decode_step(state, tpe, 1, tpe)
    torch.cuda.synchronize()
    pos0 = int(state["pos"])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            state, _ = eng.decode_step(state, tpe, 1, tpe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.release(state)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return _read(events, wall, pos0, batch)


def _read(events, wall: float, pos0: int, batch: int) -> Dict:
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                 if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
            if e.get("cat") in ("user_annotation", "cpu_op") and e.get("ph") == "X"]
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-6
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    for s, e, _n in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    spans = (np.array([h[0] for h in host], float), np.array([h[1] for h in host], float))
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        idle[_host_label(host, spans, g1)] += (g1 - g0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"kernels": dict(by_name), "busy_s": busy * 1e-6, "window_s": wall,
            "steps": PROFILED_STEPS, "pos0": pos0, "batch": batch,
            "device_ops": [[n, v] for n, v in top[:10]],
            "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def _host_label(host, spans, t: float) -> str:
    """What the host was doing when the device's gap ended: the step part
    (``record_function`` range) and the innermost operator running then."""
    starts, ends = spans
    part, op, op_len = "outside a step", None, None
    for i in np.nonzero((starts <= t) & (ends >= t))[0]:
        s, e, n = host[i]
        if n in HOST_RANGES:
            part = n
        elif op_len is None or e - s < op_len:
            op, op_len = n, e - s
    return f"{part}: {op}" if op else part


def kernel_time(kernels: Dict[str, float], pattern: str) -> float:
    """Seconds of every traced kernel whose name matches ``pattern``."""
    rx = re.compile(pattern, re.IGNORECASE)
    return sum(v for n, v in kernels.items() if rx.search(n))
