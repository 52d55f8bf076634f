"""The one traffic generator: a mix file's parameters and a seed -> a plan.

The schedule is the mix file's: request sizes and arrival gaps at
stratified quantiles of its distributions, put in an order drawn from its
``schedule_seed``, and which requests are greedy.  The run's seed draws the
content: the texts, the voices and which voice each request takes (and the
weights, ``weights.py``).  So every seed does the same work in the same
order, as the open loop's tails need: at 4/5 of the knee an order of its
own moved a window's TTFA p95 from 0.6 to 1.6 s.

Mix file keys (``bench_h100/traffic/<mix>.json``):

- ``driver``: the name of the driver file (``bench_h100/drivers/<name>.py``):
  ``serve`` (open loop through the continuous batcher), ``stream`` (one
  client in a closed loop on the streaming API) or ``batch`` (a closed loop
  of batches through the batch API);
- ``arrivals``: a kind of ``ARRIVALS`` and its parameters:
  ``{"kind": "closed"}`` (a request is due when the one before it ends),
  ``{"kind": "poisson", "rate_per_s": r}`` or ``{"kind": "gamma",
  "rate_per_s": r, "cv": c}`` (gamma gaps at the same mean rate, the
  coefficient of variation ``c``: above 1, bursts); an open loop's mix also
  gives ``warm_s``, the seconds of the same traffic set-up serves before the
  window;
- ``frames``: ``{"kind": "lognormal", "median", "sigma", "min", "max"}`` or
  ``{"kind": "uniform", "min", "max"}``, and for the closed loops ``cycle``,
  the number of stratified sizes that repeat in a seeded order;
- ``text_tokens_per_frame``: text bytes per codec frame (byte-level
  tokenizer: one token a byte);
- ``voices``: ``{"count", "zipf_s", "min_s", "max_s", "sample_rate"}``;
- ``schedule_seed``: the draw that orders sizes, gaps and greedy flags;
- ``greedy_share``: the share of requests (batches) whose codebook-0 token
  is greedy; the rest sample with the API's defaults;
- ``language``, and the driver's own keys (``batcher``, ``chunk_size``,
  ``batch``: a plan item is then a batch of that many texts) and ``check``
  (how many finished requests the reference reads).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", dtype=np.uint8)


def load_mix(path) -> Dict:
    return json.loads(Path(path).read_text())


def _stratified(spec: Dict, n: int) -> np.ndarray:
    """``n`` frame counts at the quantiles (i + 0.5) / n of ``spec``."""
    u = (np.arange(n) + 0.5) / n
    if spec["kind"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["kind"] == "uniform":
        v = spec["min"] + u * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown frames kind {spec['kind']!r}")
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(int)


def voices(mix: Dict, seed: int) -> List[np.ndarray]:
    """The mix's reference voices: seeded waveforms of ``min_s``-``max_s``
    seconds (a glottal pulse train at a seeded pitch with vibrato, shaped
    by three formant resonances, plus breath noise, under a syllabic
    envelope), float32 at ``sample_rate``."""
    v = mix["voices"]
    rng = np.random.default_rng([seed, 2])
    sr = v["sample_rate"]
    durs = np.linspace(v["min_s"], v["max_s"], v["count"])
    rng.shuffle(durs)
    out = []
    for d in durs:
        n = int(d * sr)
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 250) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        src = np.zeros(n)
        for k in range(1, 30):
            src += np.sin(k * phase) / k
        spec = np.fft.rfft(src)
        f = np.fft.rfftfreq(n, 1 / sr)
        shape = sum(1 / (1 + ((f - fc) / bw) ** 2)
                    for fc, bw in zip(rng.uniform([300, 900, 2200], [900, 2200, 3500]),
                                      (80, 120, 200)))
        wav = np.fft.irfft(spec * shape, n) + 0.02 * rng.standard_normal(n)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t) ** 2
        wav = wav * env
        out.append((0.3 * wav / np.abs(wav).max()).astype(np.float32))
    return out


def _texts(rng, frames: np.ndarray, per_frame: float) -> List[str]:
    out = []
    for f in frames:
        n = max(1, int(round(f * per_frame)))
        out.append(bytes(rng.choice(LETTERS, n)).decode("ascii"))
    return out


def _zipf(rng, n: int, count: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, count + 1) ** s
    return rng.choice(count, size=n, p=p / p.sum())


def _greedy(rng, n: int, share: float) -> np.ndarray:
    flags = np.arange(n) < int(round(share * n))
    rng.shuffle(flags)
    return flags


def _poisson_gaps(spec: Dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / spec["rate_per_s"]


def _gamma_gaps(spec: Dict, n: int) -> np.ndarray:
    from scipy.stats import gamma

    shape = 1.0 / spec["cv"] ** 2
    u = (np.arange(n) + 0.5) / n
    return gamma.ppf(u, shape, scale=1.0 / (spec["rate_per_s"] * shape))


# each open loop's ``n`` gaps at the stratified quantiles of its distribution
ARRIVALS = {"closed": None, "poisson": _poisson_gaps, "gamma": _gamma_gaps}


def plan(mix: Dict, seed: int, seconds: float) -> List[Dict]:
    """The requests of one run: each ``{"due", "frames", "text", "voice",
    "greedy"}`` (``due`` in seconds from the window's start; None in a
    closed loop, where a request is due when the one before it ends).  A
    batch plan's entries are batches, with ``texts`` in place of ``text``."""
    rng = np.random.default_rng([seed, 1])
    order = np.random.default_rng([mix["schedule_seed"], 0])
    per_frame = mix["text_tokens_per_frame"]
    arrivals = mix["arrivals"]
    if arrivals["kind"] not in ARRIVALS:
        raise ValueError(f"unknown arrivals kind {arrivals['kind']!r}; known: {sorted(ARRIVALS)}")
    if arrivals["kind"] != "closed":
        n = max(1, int(round(arrivals["rate_per_s"] * seconds)))
        gaps = ARRIVALS[arrivals["kind"]](arrivals, n)
        order.shuffle(gaps)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        frames = _stratified(mix["frames"], n)
        order.shuffle(frames)
        greedy = _greedy(order, n, mix["greedy_share"])
        reqs = [{"due": float(d), "frames": int(f)} for d, f in zip(due, frames)]
    else:
        cycle = _stratified(mix["frames"], mix["frames"]["cycle"])
        # more than a window can hold at any plausible speed: the loop stops
        # starting requests at the first cycle's end after the window's time
        n_cycles = 64
        frames = np.concatenate([order.permutation(cycle) for _ in range(n_cycles)])
        greedy = np.concatenate([_greedy(order, len(cycle), mix["greedy_share"])
                                 for _ in range(n_cycles)])
        reqs = [{"due": None, "frames": int(f)} for f in frames]
    n = len(reqs)
    voice = _zipf(rng, n, mix["voices"]["count"], mix["voices"]["zipf_s"])
    for r, g, v in zip(reqs, greedy, voice):
        r["greedy"], r["voice"] = bool(g), int(v)
    if "batch" in mix:
        for r in reqs:
            r["texts"] = _texts(rng, np.full(mix["batch"], r["frames"]), per_frame)
    else:
        for r, t in zip(reqs, _texts(rng, np.array([r["frames"] for r in reqs]), per_frame)):
            r["text"] = t
    return reqs
