"""Whether what the timed path served is right: the reference's judgement.

Once the window has closed, a sample of the finished requests, drawn from
the seed with the longest greedy one and the longest one in it, is run
through the plain reference that the configuration names
(``bench.reference``: ``reference/<name>.py``, loaded by
``harness.load_reference``) on the served frames.  The numbers compared:

- ``talker_greedy_gap_mean``: over the greedy requests' codebook-0 tokens,
  the mean gap by which a served token's logit lies below the reference's
  best, the logits as the sampler sees them (repetition penalty, control
  ids out);
- ``sampled_topk_gap_mean``: over every sampled token (the 15 predictor
  codebooks of every frame, codebook 0 of sampled requests), the mean gap
  by which a served token's logit lies below the reference's 50th best: a
  top-50 sampler may serve only a token among its top 50;
- ``audio_rel_err``: the widest relative L2 distance of a request's served
  audio from the reference decoder's waveform of its frames;
- ``unfinished``: requests of the window that failed or came back with
  another number of frames or samples than asked for (limit 0).

A gap's mean is read only where the sample holds such tokens; a cell's
limits file names the numbers it compares, and a number with a limit that
the run gave nothing to read fails the check.  Beside them, read and not
compared: the widest of each gap
(``talker_greedy_gap_max``, ``sampled_topk_gap_max``) and the share of
tokens with a gap (``greedy_flip_rate``, ``topk_out_rate``).  The widest
gaps are what bfloat16's own rounding of a logit sets (its step at a logit
of 2-8 is 0.016-0.031), and lie under three times from the program's int8
path's; the means, which grow with the square of the error, lie further
apart (the readings are in ``PERF.md``).

With ``fp8_audio`` it also reads the control of the audio number: the
reference decoder in float8 against itself in float32, on the same frames.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import logits_processed, no_tf32

TOP_K = 50
PENALTY = 1.05


def finished(rec: Dict, spf: int) -> bool:
    codes = rec.get("codes")
    if rec.get("error") or codes is None or len(codes) != rec["frames"]:
        return False
    return sum(len(a) for a in rec["audio"]) == rec["frames"] * spf


def sample(recs: List[Dict], n: int, seed: int, spf: int) -> List[Dict]:
    """``n`` finished requests: the longest greedy one, the longest one,
    then others drawn from the seed."""
    done = [r for r in recs if finished(r, spf)]
    pick = []
    for pool in ([r for r in done if r["greedy"]], done):
        if pool:
            top = max(pool, key=lambda r: r["frames"])
            if all(top is not p for p in pick):
                pick.append(top)
    rest = [r for r in done if all(r is not p for p in pick)]
    rng = np.random.default_rng([seed, 3])
    take = rng.permutation(len(rest))[: max(0, n - len(pick))]
    return pick + [rest[i] for i in sorted(take)]


@torch.no_grad()
def judge(reference, params, cfg: Dict, voices: List[np.ndarray], recs: List[Dict], n: int,
          seed: int, fp8_audio: bool = False) -> Dict[str, float]:
    """The numbers of the sample, computed by ``reference`` (a reference
    module's ``Reference`` class) on ``params``."""
    no_tf32()
    ref = reference(params, cfg)
    spf = int(np.prod(cfg["speech_tokenizer_config"]["upsample_rates"])
              * np.prod(cfg["speech_tokenizer_config"]["upsampling_ratios"]))
    vocab = cfg["talker_config"]["vocab_size"]
    out = {"audio_rel_err": 0.0,
           "unfinished": float(sum(not finished(r, spf) for r in recs)),
           "checked_frames": 0.0, "checked_requests": 0.0}
    sums = {"greedy_gap": 0.0, "greedy_flips": 0.0, "greedy_n": 0.0,
            "topk_gap": 0.0, "topk_out": 0.0, "topk_n": 0.0}
    if fp8_audio:
        out["audio_rel_err_fp8"] = 0.0
    xv = {}
    for r in sample(recs, n, seed, spf):
        if r["voice"] not in xv:
            xv[r["voice"]] = ref.xvector(voices[r["voice"]])
        codes = torch.as_tensor(np.asarray(r["codes"]), device=ref.device).long()
        prompt, pad = ref.prompt(r["text"], xv[r["voice"]])
        logits, hidden = ref.talker(prompt, codes, pad)
        lp = logits_processed(logits, codes[:, 0], vocab, PENALTY)
        served0 = lp.gather(1, codes[:, :1])[:, 0]
        if r["greedy"]:
            gap = lp.max(-1).values - served0
            out["talker_greedy_gap_max"] = max(out.get("talker_greedy_gap_max", 0.0),
                                               gap.max().item())
            sums["greedy_gap"] += gap.sum().item()
            sums["greedy_flips"] += (gap > 0).sum().item()
            sums["greedy_n"] += gap.numel()
        else:
            _topk(lp, served0, out, sums)
        pl = ref.predictor(hidden, codes).double()
        _topk(pl, pl.gather(2, codes[:, 1:, None])[..., 0], out, sums)
        want = ref.decode(codes)
        got = torch.as_tensor(np.concatenate(r["audio"]).astype(np.float32), device=ref.device)
        norm = want.norm().clamp_min(1e-12)
        out["audio_rel_err"] = max(out["audio_rel_err"], ((got - want).norm() / norm).item())
        if fp8_audio:
            low = ref.decode(codes, lowp=True)
            out["audio_rel_err_fp8"] = max(out["audio_rel_err_fp8"],
                                           ((low - want).norm() / norm).item())
        out["checked_frames"] += len(codes)
        out["checked_requests"] += 1
    if sums["greedy_n"]:
        out["talker_greedy_gap_mean"] = sums["greedy_gap"] / sums["greedy_n"]
        out["greedy_flip_rate"] = sums["greedy_flips"] / sums["greedy_n"]
    if sums["topk_n"]:
        out["sampled_topk_gap_mean"] = sums["topk_gap"] / sums["topk_n"]
        out["topk_out_rate"] = sums["topk_out"] / sums["topk_n"]
    return out


def _topk(logits, served, out, sums) -> None:
    """Gaps of sampled tokens below the reference's TOP_K-th logit."""
    kth = logits.topk(TOP_K, -1).values[..., -1]
    gap = (kth - served).clamp_min(0)
    out["sampled_topk_gap_max"] = max(out.get("sampled_topk_gap_max", 0.0), gap.max().item())
    sums["topk_gap"] += gap.sum().item()
    sums["topk_out"] += (gap > 0).sum().item()
    sums["topk_n"] += gap.numel()


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when a request was checked and every number with a limit was
    read and is within it: a number the run gave nothing to read (no greedy
    request for a greedy gap) fails."""
    if numbers.get("checked_requests", 0) < 1:
        return False
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
