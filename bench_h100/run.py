"""Run one cell of the benchmark once, on the card it is started on.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and a breakdown.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the check compared beside its limit); the same numbers end standard
error.  It exits non-zero, printing no result, without enough CUDA cards,
or when the process holds JAX or the JAX package once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "qwen3tts_tpu"}


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    import harness

    out = harness.run(bench, ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    numbers, limits = out.pop("numbers"), out.pop("limits")
    out["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    for k in sorted(set(numbers) - set(limits)):
        out["checks"][k] = {"value": numbers[k], "limit": None}
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
