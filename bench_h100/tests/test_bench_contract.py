"""BENCHMARK.json against the benchmark's contract, and every piece a cell
names found by its name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.startswith("/") and (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e


def test_every_cell_reports_enough():
    def of(group, w):
        return [m for m in BENCH[group] if "workloads" not in m or w in m["workloads"]]

    cells = {w["name"] for w in BENCH["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        e2e = {m["name"] for m in of("end_to_end", w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert of("per_layer", w)
        for m in of("per_layer", w):  # the metric it moves is reported there
            assert m["moves"] in e2e
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_preset(conf):
    from qwen3tts_tpu_torch.core.config import TTSModelConfig
    from qwen3tts_tpu_torch.core.presets import get_preset

    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    raw = json.loads((ROOT / conf["file"]).read_text())
    assert TTSModelConfig.from_dict(raw) == get_preset(conf["name"])
    assert raw["bench"]["source"] == conf["source"]
    assert raw["bench"]["reduced"] == conf["reduced"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_names_its_reference_and_counts(conf):
    """The modules a configuration names exist, and its counts module gives
    every name the readers take (``counts/qwen3tts.py``'s docstring)."""
    import harness

    raw = json.loads((ROOT / conf["file"]).read_text())
    assert callable(harness.load_reference(raw))
    counts = harness.load_counts(raw)
    for name in ("step_products", "flash_decode_call", "decode_attention_layers",
                 "frame_ops", "codec_ops_per_frame", "bound_s", "PEAK_BF16_OPS",
                 "HBM_BYTES_PER_S"):
        assert hasattr(counts, name) and name in counts.__doc__, name


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_pieces_found_by_name(w):
    import drivers
    import harness
    from traffic import ARRIVALS

    here = ROOT / "bench_h100"
    mix = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    assert mix["arrivals"]["kind"] in ARRIVALS
    assert drivers.load(mix["driver"]).rows(mix) >= 1
    limits = json.loads((here / "limits" / f"{w['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert harness.load_counts(cfg).frame_ops(cfg, 100) > 0
    assert harness.program_path(cfg) == dict(harness.PATH, **cfg["bench"]["path"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    import harness

    assert callable(harness.load_reader(m["name"]))
