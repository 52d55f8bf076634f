"""The readings that set a cell's correctness limits, in one process.

    python3 bench_h100/calibrate.py --workload <name> --seconds <s> \
        --seeds 11,12,... [--control w8a8 --control-seeds 21,22,23]

Runs the cell as a benchmark run does (set-up from each seed, a window at
the cell's load, the check) once a seed on the program as configured, then
once a control seed with the program on its own int8 path
(``quantize=<control>``: weights and activations in int8).  Every run also
reads the audio number's control, the reference decoder in float8 on the
same frames.  Prints one JSON line a run: the seed, the side, ``correct``
under the current limits, and every compared number.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="w8a8")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), args.control) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.perf_counter()
        try:
            out = harness.run(bench, ROOT, args.workload, seed, args.seconds, False, t,
                              control=control, fp8_audio=True)
        except Exception as exc:  # noqa: BLE001 -- a control that crashes has failed
            print(json.dumps({"seed": seed, "side": control or "program",
                              "error": repr(exc)}), flush=True)
            continue
        print(json.dumps({"seed": seed, "side": control or "program",
                          "correct": out["correct"], "attempted": out["attempted"],
                          "setup_s": out["metrics"].get("setup_s", {}).get("value"),
                          "seconds": time.perf_counter() - t, **out["numbers"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
