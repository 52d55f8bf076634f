"""Find a served mix's knee once: windows at rising offered rates, one set-up.

    python3 bench_h100/sweep.py --config <name> --traffic <open-loop mix> --seed <n> \
        --seconds <s> --rates 6,7,8,9,10

Prints a JSON line a rate: TTFA and chunk-gap p95, frames/s served, the
backlog's growth (the mean queue wait of the window's last quarter of
requests less its first quarter's), the requests that came back short of
their frames, and the furthest a batch's shared cache position got.  The
knee is the highest rate whose backlog does not grow and whose chunk-gap
p95 stays under 667 ms (8 frames at 12 Hz: a longer gap stalls playback); a
cell offers 4/5 of it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--repeat", type=int, default=1, help="windows at each rate")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch
    from qwen3tts_tpu_torch.core.config import TTSModelConfig

    import drivers
    import harness
    from check import finished
    from stats import chunk_gaps_ms, percentile, ttfa_ms
    from traffic import load_mix, plan, voices
    from weights import make_weights

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == args.config)
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = load_mix(HERE / "traffic" / f"{args.traffic}.json")
    cfg_obj = TTSModelConfig.from_dict(cfg)
    driver_cls = drivers.load(mix["driver"])
    model = harness.build_model(cfg, cfg_obj, make_weights(cfg_obj, args.seed, "cuda"),
                                args.seed, driver_cls.rows(mix))
    vox = voices(mix, args.seed)
    for v in vox:
        model._voice_prompt((v, mix["voices"]["sample_rate"]), "", True, True)
    driver = driver_cls(model, mix, vox, False, args.seed)
    driver.setup(plan(mix, args.seed, args.seconds))
    rates = [float(r) for r in args.rates.split(",") for _ in range(args.repeat)]
    for rate in rates:
        m = dict(mix, arrivals=dict(mix["arrivals"], rate_per_s=rate))
        driver.codes.max_pos = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = driver.window(plan(m, args.seed, args.seconds), t0, args.seconds)
        ends = [r["end"] for r in recs if r.get("end")]
        q = [r["chunks"][0][2]["queue_ms"] for r in recs if r["chunks"]]
        k = max(1, len(q) // 4)
        frames = sum(c[1] for r in recs for c in r["chunks"])
        print(json.dumps({
            "rate_per_s": rate, "requests": len(recs),
            "failed": sum(1 for r in recs if r.get("error")),
            **{f"ttfa_p{q}_ms": percentile(ttfa_ms(recs), q) for q in (50, 90, 95)},
            **{f"chunk_gap_p{q}_ms": percentile(chunk_gaps_ms(recs), q) for q in (50, 90, 95)},
            "served_frames_per_s": frames / (max(ends) - t0) if ends else None,
            "offered_frames_per_s": rate * sum(r["frames"] for r in recs) / max(1, len(recs)),
            "backlog_growth_ms": sum(q[-k:]) / k - sum(q[:k]) / k,
            "drain_s": max(ends) - t0 - args.seconds if ends else None,
            "unfinished": sum(not finished(r, model.vocoder.spf) for r in recs),
            "batch_max_pos": driver.codes.max_pos}), flush=True)
    driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
