"""On the card: each cell runs correct at its own size, and its control (the
program on its own int8 path, the codec in float8) does not.  Skipped
without a card:

    python -m pytest bench_h100/tests/test_bench_card.py -q
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _lines(args):
    r = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    _card()
    out = _lines(["bench_h100/run.py", "--workload", cell, "--seed", str(2**31 + 101),
                  "--seconds", "8", "--trace", "0"])[-1]
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    _card()
    for line in _lines(["bench_h100/calibrate.py", "--workload", cell, "--seconds", "10",
                        "--control-seeds", str(2**31 + 103)]):
        assert not line["correct"], line
